"""The JAX package's public helpers that no path of the port calls, each
held against its JAX twin on the same seeded inputs: `sampling.hg_phase`,
`importance_sample_ggx`, `importance_sample_lambert` and
`importance_sample_hg_phase`, `brdf.f_schlick`, `fd_lambert` and
`diffuse_color`, `camera.proj_dir` (rtol/atol 1e-6), `sky.earth_sky`
(rtol 1e-5, as the sky bake of test_torch_texture.py), `surface.get_emission`
on the Cornell box's camera hits (rtol/atol 1e-6 where the hit triangles
agree), `dist1d.sample_discrete`, `pdf_discrete` and `sample_continuous`
(indices bitwise, floats rtol/atol 1e-6), and `rng.pcg4d` and
`raysort.sort_perm` bitwise."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pim_tpu.core import rng as jrng
from pim_tpu.geom.cornell import build_cornell_box as jax_cornell
from pim_tpu.math import brdf as jbrdf
from pim_tpu.math import dist1d as jdist
from pim_tpu.math import sampling as jsamp
from pim_tpu.math.vec3 import V3 as JV3
from pim_tpu.render import camera as jcam
from pim_tpu.render import raysort as jraysort
from pim_tpu.render import scene as jscene
from pim_tpu.render import sky as jsky
from pim_tpu.render import surface as jsurface
from pim_tpu_torch.core import rng
from pim_tpu_torch.math import brdf, dist1d, sampling
from pim_tpu_torch.math.vec3 import V3
from pim_tpu_torch.render import camera, raysort, scene, sky, surface

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


def _unit(rs, n):
    d = rs.normal(size=(n, 3)).astype(np.float32)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _both_v3(a):
    """An [N, 3] float32 array as (the JAX V3, the port's V3)."""
    return (JV3(*(jnp.asarray(c) for c in a.T)),
            V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a.T)))


def _close_v3(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **(tol or TOL))


def test_importance_sample_ggx():
    rs = np.random.default_rng(21)
    (ji, ti), (jn, tn) = _both_v3(_unit(rs, N)), _both_v3(_unit(rs, N))
    u, v = (rs.random(N, dtype=np.float32) for _ in range(2))
    alpha = rs.uniform(0.01, 1.0, N).astype(np.float32)
    want = jsamp.importance_sample_ggx(ji, jn, jnp.asarray(u), jnp.asarray(v), jnp.asarray(alpha))
    got = sampling.importance_sample_ggx(ti, tn, torch.from_numpy(u), torch.from_numpy(v),
                                         torch.from_numpy(alpha))
    _close_v3(got, want, rtol=1e-5, atol=1e-5)


def test_importance_sample_lambert():
    rs = np.random.default_rng(22)
    jn, tn = _both_v3(_unit(rs, N))
    u, v = (rs.random(N, dtype=np.float32) for _ in range(2))
    want = jsamp.importance_sample_lambert(jn, jnp.asarray(u), jnp.asarray(v))
    got = sampling.importance_sample_lambert(tn, torch.from_numpy(u), torch.from_numpy(v))
    _close_v3(got, want)


@pytest.mark.parametrize("g", [0.0, 0.76, -0.4, 5e-4, "tensor"])
def test_importance_sample_hg_phase(g):
    rs = np.random.default_rng(23)
    u, v = (rs.random(N, dtype=np.float32) for _ in range(2))
    gv = (rs.random(N, dtype=np.float32) * 1.8 - 0.9).astype(np.float32) if g == "tensor" else g
    want = jsamp.importance_sample_hg_phase(jnp.asarray(u), jnp.asarray(v), jnp.asarray(gv))
    got = sampling.importance_sample_hg_phase(
        torch.from_numpy(u), torch.from_numpy(v),
        torch.from_numpy(gv) if g == "tensor" else gv)
    _close_v3(got, want, rtol=1e-5, atol=1e-5)


def test_brdf_helpers():
    rs = np.random.default_rng(24)
    (jf0, tf0), (jalb, talb) = (_both_v3(rs.random((N, 3), dtype=np.float32)) for _ in range(2))
    f90, cos, metal = (rs.random(N, dtype=np.float32) for _ in range(3))
    want = jbrdf.f_schlick(jf0, jnp.asarray(f90), jnp.asarray(cos))
    got = brdf.f_schlick(tf0, torch.from_numpy(f90), torch.from_numpy(cos))
    _close_v3(got, want)
    assert np.float32(brdf.fd_lambert()) == np.float32(jbrdf.fd_lambert())
    _close_v3(brdf.diffuse_color(talb, torch.from_numpy(metal)),
              jbrdf.diffuse_color(jalb, jnp.asarray(metal)))


def test_proj_dir():
    rs = np.random.default_rng(25)
    cam = jcam.Camera(position=np.array([1.0, 2.0, 3.0], np.float32))
    cam.look_at([0.0, -1.0, 0.5])
    right, up, fwd = (np.asarray(x, np.float32) for x in cam.basis())
    slope = jcam.proj_slope(np.radians(60.0), 1.5)
    coord = rs.uniform(-1.0, 1.0, (7, 9, 2)).astype(np.float32)
    want = jcam.proj_dir(jnp.asarray(right), jnp.asarray(up), jnp.asarray(fwd), slope,
                         jnp.asarray(coord))
    got = camera.proj_dir(right, up, fwd, camera.proj_slope(np.radians(60.0), 1.5), coord)
    assert got.shape == (7, 9, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ro", [(0.0, 0.0, 0.0), (10.0, 2500.0, -30.0)])
def test_earth_sky(ro):
    rs = np.random.default_rng(26)
    d = _unit(rs, 64)
    d[:, 1] = np.abs(d[:, 1])
    sun = np.asarray([0.35, 0.82, 0.45], np.float32)
    sun /= np.linalg.norm(sun)
    want = jsky.earth_sky(jnp.asarray(ro, jnp.float32), jnp.asarray(d), jnp.asarray(sun), 120.0, 4)
    got = sky.earth_sky(ro, _both_v3(d)[1], sun, 120.0, 4)
    for k, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want)[:, k], rtol=1e-5, atol=0)
    assert float(got.y.min()) > 0.0


def test_get_emission():
    """The Cornell box (its JAX `brute` scene, carried into the port) seen
    from the bench camera: emission at each hit, lights included."""
    jm, ja, jl = jscene.build_scene(*jax_cornell("boxes"), backend="brute")
    m, a, _ = scene.from_jax_scene(dataclasses.asdict(jm),
                                   {k: np.asarray(v) for k, v in ja._asdict().items()},
                                   {k: np.asarray(v) for k, v in jl._asdict().items()}, "cpu")
    rs = np.random.default_rng(27)
    ro = np.tile(np.float32([-4.0, 0.0, 4.0]), (N, 1))
    d = np.float32([4.0, -1.0, -4.0]) + rs.uniform(-2.5, 2.5, (N, 3)).astype(np.float32)
    light = np.float32([0.0, 4.9, 0.0]) + rs.uniform(-0.6, 0.6, (N // 2, 3)).astype(np.float32)
    d[: N // 2] = light - ro[: N // 2]  # half of them at the ceiling light
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    (jro, tro), (jrd, trd) = _both_v3(ro), _both_v3(d)
    jhit = jscene.scene_intersect(jm, ja, jro, jrd, 0.0, 1e6)
    hit = scene.scene_intersect(m, a, tro, trd, 0.0, 1e6)
    same = hit.tri.numpy() == np.asarray(jhit.tri)
    assert same.mean() >= 0.99
    want = jsurface.get_emission(jm, ja, jro, jrd, jhit)
    got = surface.get_emission(m, a, tro, trd, hit)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[same], np.asarray(w)[same], **TOL)
    assert float(got.x.max()) > 0.0
