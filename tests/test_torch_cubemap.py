"""pim_tpu_torch.render.cubemap (and sky.sample_sky_cubemap) against
pim_tpu's on the same seeded inputs and the identical (converted) Cornell
scene.

- calc_mip_count and the mip chain, the tent map (sign(0) = 0) at rtol
  1e-6, calc_dirs_jittered at rtol 1e-6 / atol 1e-6 (rsqrt may differ by
  an ulp);
- sample_sky_cubemap at rtol 1e-6 / atol 1e-6 (no transcendental: only
  the reference's possible FMA contraction of u * ma + 0.5 separates
  them);
- bake_step at 8^2 (384 rays, 3 bounces) with the frame rule of
  test_torch_frame.py: 97% of values within rtol 1e-4 / atol 1e-5, means
  within 2%; the RNG words bit for bit;
- prefilter_mip of one shared color cube at every mip, and read_convolved
  of one shared mip chain, with the same 97% rule (a half-vector an ulp
  apart can fall on the other side of a texel or face edge) and means
  within 1e-4;
- the registry's origin rules: a bounded probe bakes from its bounds
  center, an unbounded one from the fallback origin frozen at its first
  bake, a moved origin restarts the average."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import pallas_interpret

from pim_tpu.core import rng as jrng
from pim_tpu.geom.cornell import build_cornell_box as jax_cornell
from pim_tpu.render import cubemap as jcube
from pim_tpu.render import sky as jsky
from pim_tpu.render.scene import build_scene as jax_build_scene
from pim_tpu_torch.core import rng
from pim_tpu_torch.render import cubemap, sky
from pim_tpu_torch.render.scene import from_jax_scene

torch.set_num_threads(2)

BOUNCES = 3
TOL = dict(rtol=1e-6, atol=1e-6)


def _rs(seed=0):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True)
def fresh_registries():
    """Each test starts from empty probe registries in both packages (the
    registries are module globals)."""
    cubemap._registry = jcube._registry = None
    yield
    cubemap._registry = jcube._registry = None


@pytest.fixture(scope="module")
def scenes():
    with pallas_interpret():
        jm, ja, jl = jax_build_scene(*jax_cornell("boxes"), backend="pallas")
    port = from_jax_scene(dataclasses.asdict(jm),
                          {k: np.asarray(v) for k, v in ja._asdict().items()},
                          {k: np.asarray(v) for k, v in jl._asdict().items()}, "cpu")
    return (jm, ja, jl), port


def _frame_rule(got, want, mean_rel=0.02):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).mean()
    assert close >= 0.97, close
    assert abs(got.mean() - want.mean()) <= mean_rel * abs(want.mean()) + 1e-7


@pytest.mark.parametrize("size", [1, 2, 7, 8, 16, 64])
def test_mip_chain(size):
    assert cubemap.calc_mip_count(size) == jcube.calc_mip_count(size)
    cm, jcm = cubemap.cubemap_new(size, "cpu"), jcube.cubemap_new(size)
    assert cm.size == jcm.size and cm.mip_count == jcm.mip_count
    assert [tuple(m.shape) for m in cm.mips] == [m.shape for m in jcm.mips]


def test_tent_and_jittered_dirs():
    rs = _rs(1)
    x = np.concatenate([rs.random(4000, dtype=np.float32),
                        np.float32([0.0, 0.5, 0.25, 0.75, 1.0 - 2 ** -24])])
    np.testing.assert_allclose(cubemap._tent(_t(x)).numpy(),
                               np.asarray(jcube._tent(jnp.asarray(x))), **TOL)
    assert float(cubemap._tent(_t(np.float32([0.5])))[0]) == 0.0
    for size in (4, 8):
        n = 6 * size * size
        xi = (rs.random((n, 2), dtype=np.float32) * 2 - 1).astype(np.float32)
        np.testing.assert_allclose(cubemap.calc_dirs_jittered(size, _t(xi)).numpy(),
                                   np.asarray(jcube.calc_dirs_jittered(size, jnp.asarray(xi))),
                                   **TOL)


def _dirs(rs, n):
    d = rs.normal(size=(n, 3))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    # axis-aligned directions and ties between components
    extra = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
                      [1, 1, 0], [-1, 0, 1], [1, -1, -1], [0.5, 0.5, -0.5]], np.float64)
    return np.concatenate([d, extra]).astype(np.float32)


@pytest.mark.parametrize("size", [1, 5, 16])
def test_sample_sky_cubemap_matches(size):
    rs = _rs(2)
    cube = rs.random((6, size, size, 3), dtype=np.float32)
    dirs = _dirs(rs, 4096) * np.float32(3.0)
    np.testing.assert_allclose(sky.sample_sky_cubemap(_t(cube), _t(dirs)).numpy(),
                               np.asarray(jsky.sample_sky_cubemap(jnp.asarray(cube),
                                                                  jnp.asarray(dirs))), **TOL)


@pytest.mark.parametrize("sample_idx", [0, 3])
def test_bake_step_matches(scenes, sample_idx):
    (jm, ja, jl), (m, a, l) = scenes
    size = 8
    n = 6 * size * size
    # the RNG words of the pass
    js = jrng.make_state(jnp.arange(n, dtype=jnp.uint32), sample_idx, seed=0x0C0B0E00)
    ts = rng.make_state(torch.arange(n), sample_idx, seed=cubemap.BAKE_SEED)
    for a_, b_ in zip(js, ts):
        np.testing.assert_array_equal(b_.numpy(), np.asarray(a_).astype(np.int64))
    rs = _rs(3)
    start = rs.random((6, size, size, 3), dtype=np.float32)
    cm = cubemap.cubemap_new(size, "cpu")._replace(color=_t(start))
    jcm = jcube.cubemap_new(size)._replace(color=jnp.asarray(start))
    origin = [0.5, -1.0, 0.25]
    with pallas_interpret():
        jout = jax.block_until_ready(jax.jit(
            lambda a_, l_, c: jcube.bake_step(jm, a_, l_, c, origin, sample_idx, 0.5, BOUNCES))(
                ja, jl, jcm))
    out = cubemap.bake_step(m, a, l, cm, origin, sample_idx, 0.5, BOUNCES)
    _frame_rule(out.color.numpy(), jout.color)


@pytest.fixture(scope="module")
def shared_cube():
    rs = _rs(4)
    # a smooth field (so an ulp-level shift of a read moves it by ~an ulp)
    # with one bright spot
    from pim_tpu_torch.render.sky import cubemap_dirs

    d = cubemap_dirs(16)
    cube = (0.5 + 0.5 * d * np.float32([1.0, 0.6, -0.3])).astype(np.float32)
    cube[2, 7, 8] = np.float32([20.0, 18.0, 15.0])
    cube += rs.random(cube.shape, dtype=np.float32) * np.float32(0.05)
    return cube


@pytest.mark.parametrize("mip", range(5))
def test_prefilter_mip_matches(shared_cube, mip):
    got = cubemap.prefilter_mip(_t(shared_cube), mip, 4.0, 16, 3)
    want = jcube.prefilter_mip(jnp.asarray(shared_cube), mip, 4.0, 16, 3)
    _frame_rule(got.numpy(), want, mean_rel=1e-4)


def test_convolve_and_read_convolved_match(shared_cube):
    cm = cubemap.cubemap_new(16, "cpu")._replace(color=_t(shared_cube))
    jcm = jcube.cubemap_new(16)._replace(color=jnp.asarray(shared_cube))
    cm = cubemap.convolve(cm, 8, 0.5, 2)
    jcm = jcube.convolve(jcm, 8, 0.5, 2)
    for got, want in zip(cm.mips, jcm.mips):
        _frame_rule(got.numpy(), want, mean_rel=1e-4)
    # read_convolved of one shared chain (the port's mips in both)
    jshared = jcm._replace(mips=tuple(jnp.asarray(m.numpy()) for m in cm.mips))
    rs = _rs(5)
    dirs = _dirs(rs, 2048)
    for rough in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(cubemap.read_convolved(cm, _t(dirs), rough).numpy(),
                                   np.asarray(jcube.read_convolved(jshared, jnp.asarray(dirs),
                                                                   rough)), **TOL)
    r = rs.random(len(dirs), dtype=np.float32) * np.float32(1.2)
    np.testing.assert_allclose(cubemap.read_convolved(cm, _t(dirs), _t(r)).numpy(),
                               np.asarray(jcube.read_convolved(jshared, jnp.asarray(dirs),
                                                               jnp.asarray(r))), **TOL)


def test_registry_origin_rules(scenes):
    _, (m, a, l) = scenes
    reg = cubemap.get_registry()
    assert cubemap.get_registry() is reg
    reg.add("boxed", 2, lo=[-1.0, -2.0, 0.0], hi=[1.0, 0.0, 2.0], device="cpu")
    reg.add("free", 2, device="cpu")
    with pytest.raises(KeyError):
        reg.add("free", 2, device="cpu")
    np.testing.assert_array_equal(reg.probe_origin("boxed", [9, 9, 9]), [0.0, -1.0, 1.0])
    # the fallback origin is frozen at its first use
    reg.bake("free", m, a, l, fallback_origin=[0.5, 0.0, 0.0], max_bounces=1,
             convolve_samples=2)
    reg.bake("free", m, a, l, fallback_origin=[-3.0, 1.0, 0.0], max_bounces=1,
             convolve_samples=2)
    np.testing.assert_array_equal(reg.probe_origin("free"), [0.5, 0.0, 0.0])
    assert reg._samples["free"] == 2
    # a moved origin restarts the average; reset_samples restarts it too
    reg.bake("boxed", m, a, l, max_bounces=1, convolve_samples=2)
    reg._bounds["boxed"] = (np.float32([0, 0, 0]), np.float32([1, 1, 1]))
    reg.bake("boxed", m, a, l, max_bounces=1, convolve_samples=2)
    assert reg._samples["boxed"] == 1
    reg.reset_samples()
    assert reg._samples == {"boxed": 0, "free": 0}
    assert reg.remove("free") and not reg.remove("free") and reg.names() == ["boxed"]
    # the same rules in the reference's registry
    jreg = jcube.get_registry()
    jreg.add("boxed", 2, lo=[-1.0, -2.0, 0.0], hi=[1.0, 0.0, 2.0])
    jreg.add("free", 2)
    np.testing.assert_array_equal(jreg.probe_origin("boxed", [9, 9, 9]), [0.0, -1.0, 1.0])
    assert np.array_equal(jreg.probe_origin("free", [0.5, 0.0, 0.0]), [0.5, 0.0, 0.0])
    assert np.array_equal(jreg.probe_origin("free", [-3.0, 1.0, 0.0]), [0.5, 0.0, 0.0])
