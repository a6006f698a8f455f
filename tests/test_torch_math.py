"""pim_tpu_torch.math (sampling, BRDF, geometry, grid, dist1d) and the BSDF
evals against pim_tpu on the same seeded inputs (rtol/atol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pim_tpu.math import brdf as jbrdf
from pim_tpu.math import dist1d as jdist
from pim_tpu.math import geometry as jgeom
from pim_tpu.math import grid as jgrid
from pim_tpu.math import sampling as jsamp
from pim_tpu.math.vec3 import V3 as JV3
from pim_tpu_torch.math import brdf, dist1d, geometry, grid, sampling
from pim_tpu_torch.math.vec3 import V3

torch.set_num_threads(2)

N = 4096
TOL = dict(rtol=1e-6, atol=1e-6)


def _rs(seed=0):
    return np.random.default_rng(seed)


def _u(rs, n=N):
    return rs.random(n, dtype=np.float32)


def _unit(rs, n=N):
    d = rs.normal(size=(3, n))
    return (d / np.linalg.norm(d, axis=0)).astype(np.float32)


def _j(x):
    if isinstance(x, np.ndarray):
        return jnp.asarray(x)
    return x


def _t(x):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy())
    return x


def _jv3(a):
    return JV3(*(jnp.asarray(c) for c in a))


def _tv3(a):
    return V3(*(torch.from_numpy(c.copy()) for c in a))


def _flat(out):
    """Nested tuples / V3 of arrays -> list of numpy arrays."""
    if isinstance(out, (tuple, list)):
        res = []
        for o in out:
            res.extend(_flat(o))
        return res
    if isinstance(out, torch.Tensor):
        return [out.numpy()]
    return [np.asarray(out)]


def _close(jout, tout, **tol):
    a, b = _flat(jout), _flat(tout)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, **(tol or TOL))


SAMPLING_CASES = {
    "sample_unit_sphere": lambda rs: ((_u(rs), _u(rs)), {}),
    "sample_bary_coord": lambda rs: ((_u(rs), _u(rs)), {}),
    "sample_cosine_hemisphere": lambda rs: ((_u(rs), _u(rs)), {}),
    "sample_ggx_microfacet": lambda rs: ((_u(rs), _u(rs), _u(rs) * 0.99 + 0.01), {}),
    "power_heuristic": lambda rs: ((_u(rs) * 5, _u(rs) * 5), {}),
    "light_pdf": lambda rs: ((_u(rs), _u(rs), _u(rs) * 30), {}),
    "sample_gauss_pixel_filter": lambda rs: ((_u(rs), _u(rs)), {}),
}


@pytest.mark.parametrize("name", sorted(SAMPLING_CASES))
def test_sampling_matches_reference(name):
    args, kw = SAMPLING_CASES[name](_rs(1))
    _close(getattr(jsamp, name)(*map(_j, args), **kw),
           getattr(sampling, name)(*map(_t, args), **kw))


@pytest.mark.parametrize("blades", [5, 6, 666])
def test_aperture_samplers_match_reference(blades):
    rs = _rs(2)
    u, v = _u(rs), _u(rs)
    side = rs.integers(0, 2**32, N, dtype=np.uint64)
    if blades == 666:
        j = jsamp.sample_pentagram(jnp.asarray(u), jnp.asarray(v),
                                   jnp.asarray(side.astype(np.uint32)))
        t = sampling.sample_pentagram(_t(u), _t(v), torch.from_numpy(side.astype(np.int64)))
    else:
        rot = float(np.pi / 10.0)
        j = jsamp.sample_ngon(jnp.asarray(u), jnp.asarray(v), jnp.asarray(side.astype(np.uint32)),
                              blades, jnp.float32(rot))
        t = sampling.sample_ngon(_t(u), _t(v), torch.from_numpy(side.astype(np.int64)), blades,
                                 float(np.float32(rot)))
    _close(j, t)


def test_tan_to_world_matches_reference():
    rs = _rs(3)
    n, v = _unit(rs), _unit(rs)
    _close(jsamp.tan_to_world(_jv3(n), _jv3(v)), sampling.tan_to_world(_tv3(n), _tv3(v)))


BRDF_CASES = {
    "brdf_alpha": lambda rs: (_u(rs),),
    "d_gtr": lambda rs: (_u(rs), _u(rs) * 0.99 + 0.01),
    "v_smith_correlated": lambda rs: (_u(rs), _u(rs), _u(rs)),
    "fd_burley": lambda rs: (_u(rs), _u(rs), _u(rs), _u(rs)),
    "f_schlick1": lambda rs: (_u(rs), _u(rs), _u(rs)),
}


@pytest.mark.parametrize("name", sorted(BRDF_CASES))
def test_brdf_scalars_match_reference(name):
    args = BRDF_CASES[name](_rs(4))
    _close(getattr(jbrdf, name)(*map(_j, args)), getattr(brdf, name)(*map(_t, args)))


@pytest.mark.parametrize("etas", [(1.0, 1.5), (1.000293, 1.52)])
def test_f_dielectric_matches_reference(etas):
    c = _rs(5).uniform(-1.0, 1.0, N).astype(np.float32)
    ei, et = (float(np.float32(e)) for e in etas)
    _close(jbrdf.f_dielectric(jnp.asarray(c), jnp.float32(ei), jnp.float32(et)),
           brdf.f_dielectric(_t(c), ei, et))


def test_f0_f90_match_reference():
    rs = _rs(6)
    alb, met = rs.random((3, N), dtype=np.float32), _u(rs)
    jf0 = jbrdf.f_0(_jv3(alb), jnp.asarray(met))
    tf0 = brdf.f_0(_tv3(alb), _t(met))
    _close(jf0, tf0)
    _close(jbrdf.f_90(jf0), brdf.f_90(tf0))


@pytest.fixture(scope="module")
def lut_pair():
    j = jbrdf.bake_brdf_lut(num_samples=5120)
    t = brdf.bake_brdf_lut(num_samples=5120)
    return j, t


def test_bake_brdf_lut_matches_reference(lut_pair):
    """Sums over 5120 samples run in another order: atol 1e-6."""
    j, t = lut_pair
    np.testing.assert_allclose(t.texels.numpy(), np.asarray(j.texels), rtol=0, atol=1e-6)


@pytest.mark.parametrize("fn", ["brdf_lut_sample", "ggx_energy_compensation", "env_brdf"])
def test_lut_fetch_matches_reference(lut_pair, fn):
    """The port's 4-tap bilinear against the reference's tent contraction,
    on the same LUT; coordinates include both clamped edges."""
    j, _ = lut_pair
    rs = _rs(7)
    nov, alpha = rs.uniform(-0.1, 1.1, (2, N)).astype(np.float32)
    nov[:4] = [0.0, 1.0, 0.5, 1.0]
    alpha[:4] = [0.0, 1.0, 1.0, 0.0]
    t_lut = brdf.BrdfLut(texels=torch.from_numpy(np.asarray(j.texels).copy()))
    if fn == "brdf_lut_sample":
        _close(jbrdf.brdf_lut_sample(j, jnp.asarray(nov), jnp.asarray(alpha)),
               brdf.brdf_lut_sample(t_lut, _t(nov), _t(alpha)))
        return
    f0 = rs.random((3, N), dtype=np.float32)
    _close(getattr(jbrdf, fn)(j, _jv3(f0), jnp.asarray(nov), jnp.asarray(alpha)),
           getattr(brdf, fn)(t_lut, _tv3(f0), _t(nov), _t(alpha)))


def test_sd_triangle_matches_reference():
    rs = _rs(8)
    a, b, c, p = (rs.uniform(-3, 3, (3, N)).astype(np.float32) for _ in range(4))
    _close(jgeom.sd_triangle(_jv3(a), _jv3(b), _jv3(c), _jv3(p)),
           geometry.sd_triangle(_tv3(a), _tv3(b), _tv3(c), _tv3(p)))


def test_grid_index_and_position_match_reference():
    lo, hi = np.array([-5.05, -5.05, -5.05], np.float32), np.array([5.05, 5.05, 5.05], np.float32)
    jg = jgrid.make_grid(lo, hi, 1.0 / 1.5)
    tg = grid.make_grid(lo, hi, 1.0 / 1.5)
    assert tuple(jg.size) == tg.size
    p = _rs(9).uniform(-6.0, 6.0, (3, N)).astype(np.float32)
    np.testing.assert_array_equal(
        grid.grid_index_soa(tg, _tv3(p)).numpy(),
        np.asarray(jgrid.grid_index_soa(jg, _jv3(p))).astype(np.int64))
    g = grid.grid_len(tg)
    np.testing.assert_array_equal(
        grid.grid_position(tg, torch.arange(g)).numpy(),
        np.asarray(jgrid.grid_position(jg, jnp.arange(g, dtype=jnp.int32))))


def test_dist1d_bake_matches_reference():
    pdf = _rs(10).random((343, 12), dtype=np.float32) * 4.0
    pdf[::7] = 0.0  # zero-integral rows take the uniform cdf
    j = jdist.bake(jnp.asarray(pdf))
    t = dist1d.bake(torch.from_numpy(pdf.copy()))
    for name in ("pdf", "cdf", "integral"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)), **TOL)
