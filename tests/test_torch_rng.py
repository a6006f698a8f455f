"""pim_tpu_torch.core.rng and the Hammersley sequence, bitwise against
pim_tpu (the port carries 32-bit words in int64); the helpers' dispatch
between the plain form and the kernels of csrc/rng.cu, and the tracing
counters `rng.calls` and `rng.kernel`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pim_tpu.core import rng as jrng
from pim_tpu.math import sampling as jsamp
from pim_tpu_torch import native
from pim_tpu_torch.core import profiler, rng
from pim_tpu_torch.math import sampling
from pim_tpu_torch.tools import rng_check as rc

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


# --- the dispatch: CPU words take the plain form; CUDA words csrc/rng.cu's
# kernels (their bits are held on the card by tests/test_torch_rng_card.py)

def _make_state(_):
    return rng.make_state(torch.arange(64), 3), ()


HELPERS = {"make_state": _make_state, **{name: h for name, (h, _) in rc.HELPERS.items()}}


def test_edge_ids_are_the_bitwise_tests_ids():
    ids = rc.edge_ids(4096, "cpu")
    assert ids.dtype == torch.int64 and (ids[:3] < 0).any() and (ids[:3] >= 2**32).any()
    np.testing.assert_array_equal(ids[8:].numpy(), _ids().astype(np.int64)[8:])


@pytest.mark.parametrize("helper", sorted(rc.HELPERS))
def test_cpu_words_take_the_plain_form_and_launch_nothing(helper):
    state = rng.make_state(rc.edge_ids(4096, "cpu"), 11)
    before = dict(native.launches)
    diffs = rc.helper_differences(helper, state)
    assert native.launches == before
    outputs = {"next_state": 4, "next_f32": 5, "next_f32x2": 6, "next_f32x3": 7,
               "next_f32x4": 8, "next_u32": 5}
    assert len(diffs) == outputs[helper] and not any(diffs), diffs


def test_cpu_make_state_takes_the_plain_form_and_launches_nothing():
    ids = rc.edge_ids(4096, "cpu")
    before = dict(native.launches)
    for sample_id, seed in ((5, 7), (torch.tensor(5, dtype=torch.int32), torch.arange(4096))):
        assert not any(rc.seed_differences(ids, sample_id, seed))
    assert native.launches == before


@pytest.mark.parametrize("helper", sorted(HELPERS))
def test_a_card_word_without_the_library_raises(helper, monkeypatch):
    """Words the dispatch takes for a card's go to the kernels or raise:
    no quiet fall back to the plain form."""
    state = rng.make_state_plain(torch.arange(64), 0)

    def missing():
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(rng, "_on_card", lambda t: True)
    monkeypatch.setattr(native, "load", missing)
    before = dict(native.launches)
    with pytest.raises(RuntimeError, match="no kernel library"):
        HELPERS[helper](state)
    # with a library, the kernels still refuse words that are not on a card
    monkeypatch.setattr(native, "load", lambda: None)
    with pytest.raises(ValueError, match="CUDA"):
        HELPERS[helper](state)
    assert native.launches == before


@pytest.mark.parametrize("traced", [False, True])
def test_rng_counters_count_only_when_tracing(traced):
    profiler.reset_counters()
    profiler.set_tracing(traced)
    try:
        state, _ = _make_state(None)
        for name in sorted(rc.HELPERS):
            state, _ = rc.HELPERS[name][0](state)
        counts = profiler.counters()
    finally:
        profiler.set_tracing(False)
        profiler.reset_counters()
    assert counts == ({"rng.calls": 7, "rng.kernel": 0} if traced else {})


@pytest.mark.parametrize("helper", sorted(rc.HELPERS))
def test_rows_of_one_block_give_the_bits_of_separate_words(helper):
    """A state whose words are rows of one [4, N] block (as the kernels and
    bsdf_scatter return it) draws the bits of the same words held apart."""
    state = rng.make_state(rc.edge_ids(4096, "cpu"), 9)
    rows, apart = rc.block_state(state), rc.separate_state(state)
    assert rows.y.data_ptr() == rows.x.data_ptr() + 4096 * 8 and rows.y.is_contiguous()
    h = rc.HELPERS[helper][0]
    got, want = h(rows), h(apart)
    assert not any(rc.differing([*got[0], *got[1]], [*want[0], *want[1]]))
