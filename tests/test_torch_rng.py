"""pim_tpu_torch.core.rng and the Hammersley sequence, bitwise against
pim_tpu (the port carries 32-bit words in int64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pim_tpu.core import rng as jrng
from pim_tpu.math import sampling as jsamp
from pim_tpu_torch.core import rng
from pim_tpu_torch.math import sampling

torch.set_num_threads(2)


def _ids(n=4096):
    """4096 pixel ids, the last few words near and at 2^32 - 1."""
    ids = np.arange(n, dtype=np.uint64)
    ids[-6:] = [2**32 - 1, 2**32 - 2, 2**32 - 3, 2**31, 2**31 - 1, 0xDEADBEEF]
    return ids.astype(np.uint32)


def _words(x):
    return np.asarray(x).astype(np.int64)


def _assert_state(js, ts):
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(_words(a), b.numpy())


@pytest.mark.parametrize("sample_id,seed", [
    (0, 0x9E3779B9), (7, 1), (2**32 - 1, 0x11671), (123456, 0xFFFFFFFF),
])
def test_make_state_and_draw_stream_bitwise(sample_id, seed):
    ids = _ids()
    js = jrng.make_state(jnp.asarray(ids), sample_id, seed=seed)
    ts = rng.make_state(torch.from_numpy(ids.astype(np.int64)), sample_id, seed=seed)
    _assert_state(js, ts)
    for _ in range(3):
        js, (ju, jv) = jrng.next_f32x2(js)
        ts, (tu, tv) = rng.next_f32x2(ts)
        _assert_state(js, ts)
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("draw", ["next_f32", "next_f32x2", "next_f32x3", "next_f32x4",
                                  "next_u32"])
def test_draw_helpers_bitwise(draw):
    ids = _ids()
    js = jrng.make_state(jnp.asarray(ids), 3)
    ts = rng.make_state(torch.from_numpy(ids.astype(np.int64)), 3)
    js, jv = getattr(jrng, draw)(js)
    ts, tv = getattr(rng, draw)(ts)
    _assert_state(js, ts)
    jv = jv if isinstance(jv, tuple) else (jv,)
    tv = tv if isinstance(tv, tuple) else (tv,)
    assert len(jv) == len(tv)
    for a, b in zip(jv, tv):
        if b.dtype == torch.int64:
            np.testing.assert_array_equal(_words(a), b.numpy())
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_pcg1_and_to_float_bitwise():
    ids = _ids()
    np.testing.assert_array_equal(_words(jrng.pcg1(jnp.asarray(ids))),
                                  rng.pcg1(torch.from_numpy(ids.astype(np.int64))).numpy())
    np.testing.assert_array_equal(np.asarray(jrng.to_float(jnp.asarray(ids))),
                                  rng.to_float(torch.from_numpy(ids.astype(np.int64))).numpy())


def test_sample_id_as_tensor_matches_int():
    ids = torch.arange(64)
    a = rng.make_state(ids, 5)
    b = rng.make_state(ids, torch.tensor(5))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n", [16, 5120])
def test_hammersley_2d_bitwise(n):
    ju, jv = jsamp.hammersley_2d(jnp.arange(n, dtype=jnp.uint32), n)
    tu, tv = sampling.hammersley_2d(torch.arange(n), n)
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def test_radical_inverse_near_2_32_bitwise():
    ids = _ids()
    np.testing.assert_array_equal(
        np.asarray(jsamp.radical_inverse_base2(jnp.asarray(ids))),
        sampling.radical_inverse_base2(torch.from_numpy(ids.astype(np.int64))).numpy())
