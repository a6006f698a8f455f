"""pim_tpu_torch.math.{sphgauss, sh, geometry} and the hemisphere sampler
against pim_tpu on the same seeded numpy inputs.

Tolerances: rtol 1e-6 / atol 1e-6 where the formula has no transcendental
or only sqrt; rtol 2e-6 / atol 1e-6 through exp (an ulp of XLA:CPU's exp
against torch's, compounded by a sum of 5 lobes); the 1,024-sample
projections (sh_l1_project, ambcube_fit) at rtol 1e-5 / atol 1e-6, since
the two sum their samples in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pim_tpu.math import geometry as jgeom
from pim_tpu.math import sampling as jsamp
from pim_tpu.math import sh as jsh
from pim_tpu.math import sphgauss as jsg
from pim_tpu.math.vec3 import V3 as JV3
from pim_tpu.math.vec3 import length as jlength
from pim_tpu_torch.math import geometry, sampling, sh, sphgauss
from pim_tpu_torch.math.vec3 import V3, length

torch.set_num_threads(2)

N = 4096
TOL = dict(rtol=1e-6, atol=1e-6)
EXP_TOL = dict(rtol=2e-6, atol=1e-6)
SUM_TOL = dict(rtol=1e-5, atol=1e-6)
K = 5


def _rs(seed=0):
    return np.random.default_rng(seed)


def _unit(rs, n=N):
    d = rs.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _amps(rs, n=N):
    return rs.random((n, K, 4), dtype=np.float32) * np.float32(3.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_gi_axii_are_the_reference_values():
    assert sphgauss.GI_AXII.dtype == np.float32
    np.testing.assert_array_equal(sphgauss.GI_AXII, jsg.GI_AXII)


def test_sg_basis_and_eval():
    rs = _rs(1)
    dirs, amps = _unit(rs), _amps(rs)
    ax = jsg.GI_AXII
    _close(sphgauss.sg_basis_eval(_t(ax), _t(dirs)), jsg.sg_basis_eval(jnp.asarray(ax), dirs),
           EXP_TOL)
    _close(sphgauss.sg_eval(_t(ax), _t(amps), _t(dirs)),
           jsg.sg_eval(jnp.asarray(ax), jnp.asarray(amps), dirs), EXP_TOL)


def test_sg_basis_integral():
    sharp = np.linspace(0.5, 40.0, 64, dtype=np.float32)
    _close(sphgauss.sg_basis_integral(_t(sharp)), jsg.sg_basis_integral(jnp.asarray(sharp)),
           EXP_TOL)


def test_sg_irradiance():
    rs = _rs(2)
    nrm, amps = _unit(rs), _amps(rs)
    ax = jsg.GI_AXII
    _close(sphgauss.sg_irradiance(_t(ax), _t(amps), _t(nrm)),
           jsg.sg_irradiance(jnp.asarray(ax), jnp.asarray(amps), jnp.asarray(nrm)), EXP_TOL)


@pytest.mark.parametrize("weight", ["scalar", "per_texel"])
def test_sg_accumulate(weight):
    """The progressive fit over 8 samples, the first with weight 1 (the
    amplitudes reset) and the rest 1/n, a scalar or one weight a texel."""
    rs = _rs(3)
    n = 1024
    ax = jsg.GI_AXII
    ja = jnp.asarray(_amps(rs, n))
    ta = _t(np.asarray(ja))
    counts = rs.integers(1, 5, n).astype(np.float32)
    for s in range(8):
        dirs = _unit(rs, n)
        rad = rs.random((n, 3), dtype=np.float32) * np.float32(2.0)
        sw = 1.0 / (s + 1) if weight == "scalar" else (1.0 / (counts + s)).astype(np.float32)
        ja = jsg.sg_accumulate(sw, jnp.asarray(dirs), jnp.asarray(rad), jnp.asarray(ax), ja)
        ta = sphgauss.sg_accumulate(sw if weight == "scalar" else _t(sw), _t(dirs), _t(rad),
                                    _t(ax), ta)
        _close(ta, ja, dict(rtol=1e-5, atol=1e-5))


def test_sh_basis_eval_and_irradiance():
    rs = _rs(4)
    dirs = _unit(rs)
    coeffs = rs.normal(size=(4, 3)).astype(np.float32)
    _close(sh.sh_l1_basis(_t(dirs)), jsh.sh_l1_basis(jnp.asarray(dirs)), TOL)
    _close(sh.sh_l1_eval(_t(coeffs), _t(dirs)), jsh.sh_l1_eval(jnp.asarray(coeffs), dirs), TOL)
    _close(sh.sh_l1_irradiance(_t(coeffs), _t(dirs)),
           jsh.sh_l1_irradiance(jnp.asarray(coeffs), jnp.asarray(dirs)), TOL)


@pytest.mark.parametrize("samples", [256, 1024, 1000])
def test_sh_project_and_ambcube_fit(samples):
    rs = _rs(5)
    dirs = _unit(rs, samples)
    rad = rs.random((samples, 3), dtype=np.float32)
    _close(sh.sh_l1_project(_t(dirs), _t(rad)),
           jsh.sh_l1_project(jnp.asarray(dirs), jnp.asarray(rad)), SUM_TOL)
    cube = sh.ambcube_fit(_t(dirs), _t(rad))
    jcube = jsh.ambcube_fit(jnp.asarray(dirs), jnp.asarray(rad))
    _close(cube.faces, jcube.faces, SUM_TOL)
    nrm = _unit(rs, 512)
    _close(sh.ambcube_eval(cube, _t(nrm)),
           jsh.ambcube_eval(jsh.AmbCube(jnp.asarray(cube.faces.numpy())), jnp.asarray(nrm)), TOL)


def test_sample_unit_hemisphere():
    rs = _rs(6)
    u, v = rs.random(N, dtype=np.float32), rs.random(N, dtype=np.float32)
    got = sampling.sample_unit_hemisphere(_t(u), _t(v))
    want = jsamp.sample_unit_hemisphere(jnp.asarray(u), jnp.asarray(v))
    for g, w in zip(got, want):
        _close(g, w, TOL)
    assert bool((got.z >= 0.0).all())


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def _pts(rs, n=N, scale=4.0):
    return (rs.normal(size=(3, n)) * scale).astype(np.float32)


def _v(a):
    return V3(*(_t(c) for c in a)), JV3(*(jnp.asarray(c) for c in a))


def _close3(got, want, tol=TOL):
    for g, w in zip(got, want):
        _close(g, w, tol)


def test_length():
    p, jp = _v(_pts(_rs(7)))
    _close(length(p), jlength(jp), TOL)


def _geom_cases():
    rs = _rs(8)
    a, b, c, pt = (_v(_pts(rs)) for _ in range(4))
    ext = _v(np.abs(_pts(rs, scale=1.0)) + np.float32(0.1))
    radius = (np.abs(rs.normal(size=N)) + 0.2).astype(np.float32)
    r = (_t(radius), jnp.asarray(radius))
    d = _v(_unit(rs).T.copy())
    plane = (geometry.plane_new(d[0], a[0]), jgeom.plane_new(d[1], a[1]))
    return {
        "sd_sphere": lambda m, i: m.sd_sphere(a[i], r[i], pt[i]),
        "sd_plane": lambda m, i: m.sd_plane(plane[i], pt[i]),
        "sd_capsule": lambda m, i: m.sd_capsule(a[i], b[i], r[i], pt[i]),
        "sd_box": lambda m, i: m.sd_box(a[i], ext[i], pt[i]),
        "sd_plane_sphere": lambda m, i: m.sd_plane_sphere(plane[i], b[i], r[i]),
        "sd_plane_box": lambda m, i: m.sd_plane_box(plane[i], b[i], ext[i]),
        "sd_triangle": lambda m, i: m.sd_triangle(a[i], b[i], c[i], pt[i]),
        "isect_sphere": lambda m, i: m.isect_sphere(pt[i], d[i], a[i], r[i]),
        "isect_plane": lambda m, i: m.isect_plane(pt[i], d[i], plane[i]),
        "isect_box": lambda m, i: m.isect_box(pt[i], d[i], a[i], a[i] + ext[i]),
        "tri_area_3d": lambda m, i: m.tri_area_3d(a[i], b[i], c[i]),
    }


@pytest.mark.parametrize("name", list(_geom_cases()))
def test_geometry_matches(name):
    fn = _geom_cases()[name]
    got, want = fn(geometry, 0), fn(jgeom, 1)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        # isect_plane and isect_box divide by a direction component: near 0
        # the quotient is large, so the tolerance is relative there
        _close(g, w, dict(rtol=2e-6, atol=2e-5))


def test_box_ops_match():
    rs = _rs(9)
    lo = _pts(rs)
    hi = lo + np.abs(_pts(rs, scale=2.0))
    box = geometry.Box3D(_v(lo)[0], _v(hi)[0])
    jbox = jgeom.Box3D(_v(lo)[1], _v(hi)[1])
    lo2 = _pts(rs)
    box2 = geometry.Box3D(_v(lo2)[0], _v(lo2 + 3.0)[0])
    jbox2 = jgeom.Box3D(_v(lo2)[1], _v(lo2 + 3.0)[1])
    pt, jpt = _v(_pts(rs))
    for f in ("box_volume", "box_area"):
        _close(getattr(geometry, f)(box), getattr(jgeom, f)(jbox), TOL)
    np.testing.assert_array_equal(geometry.box_contains(box, pt).numpy(),
                                  np.asarray(jgeom.box_contains(jbox, jpt)))
    for f in ("box_union", "box_intersect"):
        got, want = getattr(geometry, f)(box, box2), getattr(jgeom, f)(jbox, jbox2)
        _close3(got.lo, want.lo)
        _close3(got.hi, want.hi)
    _close3(box.center, jbox.center)
    _close3(box.extents, jbox.extents)
    pts = _pts(rs, n=64).reshape(3, 4, 16)
    got, want = geometry.box_from_pts(_v(pts)[0]), jgeom.box_from_pts(_v(pts)[1])
    _close3(got.lo, want.lo)
    _close3(got.hi, want.hi)
    empty = geometry.box_empty()
    jempty = jgeom.box_empty()
    _close3(empty.lo, jempty.lo)
    _close3(empty.hi, jempty.hi)


def test_frustum_matches():
    def one(a):
        return _v(np.asarray(a, np.float32).reshape(3, 1))

    args = [one(v) for v in ([0.5, 1.0, -0.5], [1, 0, 0], [0, 1, 0], [0, 0, -1])]
    window = ((-0.5, -1.0), (1.0, 0.75), float(np.pi / 3), 1.5, 0.1, 50.0)
    frus = geometry.frustum_new(*(a[0] for a in args), *window)
    jfrus = jgeom.frustum_new(*(a[1] for a in args), *window)
    _close3(frus.n, jfrus.n, dict(rtol=1e-5, atol=1e-6))
    _close(frus.d, jfrus.d, dict(rtol=1e-5, atol=1e-5))
    rs = _rs(10)
    pt, jpt = _v(_pts(rs, scale=20.0))
    r = np.abs(rs.normal(size=N)).astype(np.float32)
    _close(geometry.sd_frustum(frus, pt), jgeom.sd_frustum(jfrus, jpt), dict(rtol=1e-5, atol=1e-4))
    _close(geometry.sd_frustum_sphere(frus, pt, _t(r)),
           jgeom.sd_frustum_sphere(jfrus, jpt, jnp.asarray(r)), dict(rtol=1e-5, atol=1e-4))
    hi = _pts(rs, scale=1.0)
    box = geometry.Box3D(pt, pt + _v(np.abs(hi))[0])
    jbox = jgeom.Box3D(jpt, jpt + _v(np.abs(hi))[1])
    _close(geometry.sd_frustum_box(frus, box), jgeom.sd_frustum_box(jfrus, jbox),
           dict(rtol=1e-5, atol=1e-4))
    # the reference test's cases: a point ahead inside, one behind outside
    fr = geometry.frustum_new(*(one(v)[0] for v in ([0, 0, 0], [1, 0, 0], [0, 1, 0],
                                                     [0, 0, -1])),
                              (-1.0, -1.0), (1.0, 1.0), np.pi / 2, 1.0, 0.1, 100.0)
    assert float(geometry.sd_frustum(fr, one([0, 0, -10])[0])) < 0.0
    assert float(geometry.sd_frustum(fr, one([0, 0, 10])[0])) > 0.0


@pytest.mark.parametrize("name,args", [("sphere_area", (2.0,)), ("disk_area", (1.5,)),
                                       ("tube_area", (0.5, 3.0)), ("rect_area", (2.0, 3.5))])
def test_areas_match(name, args):
    assert getattr(geometry, name)(*args) == pytest.approx(getattr(jgeom, name)(*args),
                                                           rel=1e-12)
