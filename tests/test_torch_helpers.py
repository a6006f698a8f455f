"""The JAX package's public helpers that no path of the port calls, each
held against its JAX twin on the same seeded inputs: `sampling.hg_phase`
(rtol/atol 1e-6), `dist1d.sample_discrete`, `pdf_discrete` and
`sample_continuous` (indices bitwise, floats rtol/atol 1e-6), and
`rng.pcg4d` and `raysort.sort_perm` bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pim_tpu.core import rng as jrng
from pim_tpu.math import dist1d as jdist
from pim_tpu.math import sampling as jsamp
from pim_tpu.render import raysort as jraysort
from pim_tpu_torch.core import rng
from pim_tpu_torch.math import dist1d, sampling
from pim_tpu_torch.render import raysort

torch.set_num_threads(2)

N = 4096
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("g", [0.0, 0.76, -0.4, "tensor"])
def test_hg_phase(g):
    rs = np.random.default_rng(3)
    cos = (rs.random(N, dtype=np.float32) * 2.0 - 1.0).astype(np.float32)
    cos[:4] = [-1.0, 1.0, 0.0, -0.999]
    if g == "tensor":
        gv = (rs.random(N, dtype=np.float32) * 1.8 - 0.9).astype(np.float32)
        want = jsamp.hg_phase(jnp.asarray(cos), jnp.asarray(gv))
        got = sampling.hg_phase(torch.from_numpy(cos), torch.from_numpy(gv))
    else:
        want = jsamp.hg_phase(jnp.asarray(cos), g)
        got = sampling.hg_phase(torch.from_numpy(cos), g)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _dists():
    """Both packages' Dist1D of the same pdf rows: random rows, a zero row
    (uniform cdf) and a one-hot row (zero-width buckets)."""
    rs = np.random.default_rng(11)
    pdf = rs.random((6, 9), dtype=np.float32)
    pdf[2] = 0.0
    pdf[4] = 0.0
    pdf[4, 5] = 3.0
    return jdist.bake(jnp.asarray(pdf)), dist1d.bake(torch.from_numpy(pdf))


def _queries():
    rs = np.random.default_rng(12)
    cell = rs.integers(0, 6, N).astype(np.int32)
    u = rs.random(N, dtype=np.float32)
    u[:3] = [0.0, np.nextafter(np.float32(1.0), np.float32(0.0)), 0.5]
    return cell, u


def test_sample_and_pdf_discrete():
    jd, td = _dists()
    cell, u = _queries()
    want = np.asarray(jdist.sample_discrete(jd, jnp.asarray(cell), jnp.asarray(u)))
    got = dist1d.sample_discrete(td, torch.from_numpy(cell).long(), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    want_p = jdist.pdf_discrete(jd, jnp.asarray(cell), jnp.asarray(want))
    got_p = dist1d.pdf_discrete(td, torch.from_numpy(cell).long(), got)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)


def test_sample_continuous():
    jd, td = _dists()
    cell, u = _queries()
    want = jdist.sample_continuous(jd, jnp.asarray(cell), jnp.asarray(u))
    got = dist1d.sample_continuous(td, torch.from_numpy(cell).long(), torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert bool(((got >= 0.0) & (got <= 1.0)).all())


def test_pcg4d_bitwise():
    rs = np.random.default_rng(5)
    v = rs.integers(0, 2**32, (N, 4), dtype=np.uint64).astype(np.uint32)
    v[0] = [0, 0, 0, 0]
    v[1] = [2**32 - 1] * 4
    want = np.asarray(jrng.pcg4d(jnp.asarray(v))).astype(np.int64)
    got = rng.pcg4d(torch.from_numpy(v.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sort_perm_bitwise():
    """Keys with many ties: the permutation and its inverse are the JAX
    sort's, index for index."""
    keys = np.random.default_rng(9).integers(0, 50, N).astype(np.int32)
    jp, jinv = jraysort.sort_perm(jnp.asarray(keys))
    perm, inv = raysort.sort_perm(torch.from_numpy(keys).long())
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(keys[perm.numpy()][inv.numpy()], keys)
