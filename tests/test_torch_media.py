"""Participating media and light learning in the port against pim_tpu.

The same seeded numpy inputs go through the JAX function and the port's:
RNG words and integers must match bit for bit, floats at ulp scale.  A
single evaluation (the noise, the medium's coefficients, the phase, the
light-pdf fold) is held at rtol 1e-6.  The marches compound an ulp a step
over MEDIA_STEPS = 32 steps: the reference's scan body is compiled, XLA:CPU
contracts FMAs there (ROADMAP F5) and its log, sin and cos differ from
torch's by an ulp (the JAX package's own jitted and op-by-op marches differ
at the same scale), so march outputs are held at rtol 1e-5 and positions,
whose magnitude reaches 40, at atol 1e-5 (under 3 ulp at 32).

The media frames (Cornell 16^2, 3 bounces, a dense medium; the small
textured map of test_torch_map_frame.py at the default medium, cluster
backend) are held as test_torch_frame.py holds its frame: at least 97% of
pixels at rtol 1e-4 / atol 1e-5, means within 2%, and the light histogram
bit for bit.  The port's in-media NEE traces only the lanes that
scattered (the others get t_far = 0), where the reference traces every
lane; the frames show the two agree.

The slow test is the counterpart of
tests/test_media.py::test_media_brute_vs_framework: the port's media
integrator against a brute random walk of its own, a z-test on image
means."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import pallas_interpret

from pim_tpu.core import rng as jrng
from pim_tpu.geom.cornell import build_cornell_box as jax_cornell
from pim_tpu.math import dist1d as jdist
from pim_tpu.math import noise as jnoise
from pim_tpu.math.vec3 import V3 as JV3
from pim_tpu.render import camera as jcam
from pim_tpu.render import integrator as jint
from pim_tpu.render import media as jmedia
from pim_tpu.render import scene as jscene
from pim_tpu.render.scene import build_scene as jax_build_scene
from pim_tpu_torch import app, native
from pim_tpu_torch.core import rng
from pim_tpu_torch.math import dist1d, noise
from pim_tpu_torch.math.vec3 import V3
from pim_tpu_torch.render import camera, integrator, media
from pim_tpu_torch.render.scene import LightState, from_jax_scene, update_light_state

torch.set_num_threads(2)

N = 512
DENSE = dict(constant_mfp=15.0, noise_mfp=1e9, absorption=0.2)
BANDED = dict(constant_mfp=30.0, noise_mfp=2.0, noise_octaves=3, noise_height=0.5,
              noise_scale=1.5, phase_dir_a=0.4, phase_dir_b=-0.3, phase_blend=0.3)
DESCS = {"default": {}, "dense": DENSE, "banded": BANDED}


def _descs(name):
    kw = DESCS[name]
    return jmedia.make_media_desc(**kw), media.make_media_desc(**kw)


def _points(seed, n=N, scale=4.0):
    r = np.random.default_rng(seed)
    return r.uniform(-scale, scale, (n, 3)).astype(np.float32)


def _dirs(seed, n=N):
    r = np.random.default_rng(seed)
    d = r.normal(size=(n, 3)).astype(np.float32)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _v3(a):
    return JV3(*(jnp.asarray(a[:, i]) for i in range(3))), V3(
        *(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _states(sample):
    return (jrng.make_state(jnp.arange(N, dtype=jnp.uint32), sample),
            rng.make_state(torch.arange(N), sample))


def _same_state(js, ts):
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())


def _close(tv, jv, rtol=1e-6, atol=1e-7):
    if isinstance(tv, V3):
        for a, b in zip(tv, jv):
            _close(a, b, rtol, atol)
        return
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=rtol, atol=atol)


def test_pcg_cell_hash_bitwise():
    r = np.random.default_rng(0)
    w = r.integers(-2**31, 2**31, (4, N), dtype=np.int64)
    want = jnoise._pcg4_x(*(jnp.asarray(x.astype(np.int32)).astype(jnp.uint32) for x in w))
    got = noise._pcg4_x(*(torch.from_numpy(x & 0xFFFFFFFF) for x in w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("octaves", [1, 3])
def test_fbm_noise_matches(octaves):
    jp, tp = _v3(_points(1, scale=40.0))
    want = jnoise.fbm_gradient_noise3(jp, jnp.float32(2.0666), jnp.float32(0.9), octaves)
    got = noise.fbm_gradient_noise3(tp, np.float32(2.0666).item(), np.float32(0.9).item(),
                                    octaves)
    _close(got, want, atol=1e-6)
    assert float(got.abs().max()) > 0.1


def test_interleaved_gradient_noise_matches():
    xy = np.random.default_rng(2).uniform(0, 512, (2, N)).astype(np.float32)
    want = jnoise.interleaved_gradient_noise(jnp.asarray(xy[0]), jnp.asarray(xy[1]))
    got = noise.interleaved_gradient_noise(torch.from_numpy(xy[0]), torch.from_numpy(xy[1]))
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize("name", sorted(DESCS))
def test_media_desc_matches(name):
    jd, td = _descs(name)
    for f in jmedia.MediaDesc._fields:
        want = getattr(jd, f)
        got = getattr(td, f)
        if isinstance(want, JV3):
            want = [want.x, want.y, want.z]
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      np.asarray(want, np.float32), err_msg=f)


@pytest.mark.parametrize("name", sorted(DESCS))
def test_media_sample_matches(name):
    jd, td = _descs(name)
    pts = _points(3)
    pts[:, 1] = np.random.default_rng(4).uniform(-2.0, 3.0, N).astype(np.float32)
    jp, tp = _v3(pts)
    for got, want in zip(media.media_sample(td, tp), jmedia.media_sample(jd, jp)):
        _close(got, want, atol=1e-9)


def test_calc_phase_matches():
    jd, td = _descs("banded")
    ct = np.random.default_rng(5).uniform(-1, 1, N).astype(np.float32)
    _close(media.calc_phase(td, torch.from_numpy(ct)), jmedia.calc_phase(jd, jnp.asarray(ct)))


@pytest.mark.parametrize("name", sorted(DESCS))
def test_calc_transmittance_matches(name):
    jd, td = _descs(name)
    (jro, tro), (jrd, trd) = _v3(_points(6)), _v3(_dirs(7))
    length = np.random.default_rng(8).uniform(0.1, 12.0, N).astype(np.float32)
    js, ts = _states(11)
    js, jtr = jmedia.calc_transmittance(jd, js, jro, jrd, jnp.asarray(length))
    ts, ttr = media.calc_transmittance(td, ts, tro, trd, torch.from_numpy(length))
    _same_state(js, ts)
    _close(ttr, jtr, rtol=1e-5)
    if name == "dense":
        assert float(ttr.x.mean()) < 0.9


def test_sample_phase_dir_matches():
    jd, td = _descs("banded")
    _, (jrd, trd) = None, _v3(_dirs(9))
    js, ts = _states(12)
    js, jl, jph = jmedia.sample_phase_dir(jd, js, jrd)
    ts, tl, tph = media.sample_phase_dir(td, ts, trd)
    _same_state(js, ts)
    _close(tl, jl, rtol=1e-5, atol=1e-6)
    _close(tph, jph, rtol=1e-5)


@pytest.mark.parametrize("name", ["dense", "banded"])
@pytest.mark.parametrize("with_light", [False, True])
def test_scatter_ray_matches(name, with_light):
    jd, td = _descs(name)
    (jro, tro), (jrd, trd) = _v3(_points(13, scale=1.0)), _v3(_dirs(14))
    length = np.random.default_rng(15).uniform(1.0, 40.0, N).astype(np.float32)
    js, ts = _states(16)

    # a stand-in for the in-media NEE: one RNG word, a light direction and
    # luminance from the point
    def jlight(st, p):
        st, u = jrng.next_f32(st)
        d = JV3(p.y - 0.5, jnp.ones_like(p.x), u - 0.5)
        return st, JV3(u, p.x * p.x, jnp.abs(p.z)), d * jax.lax.rsqrt(
            d.x * d.x + d.y * d.y + d.z * d.z), u > 0.25

    def tlight(st, p, active):
        st, u = rng.next_f32(st)
        d = V3(p.y - 0.5, torch.ones_like(p.x), u - 0.5)
        return st, V3(u, p.x * p.x, torch.abs(p.z)), d * torch.rsqrt(
            d.x * d.x + d.y * d.y + d.z * d.z), u > 0.25

    js, jms = jmedia.scatter_ray(jd, js, jro, jrd, jnp.asarray(length),
                                 evaluate_light=jlight if with_light else None)
    ts, tms = media.scatter_ray(td, ts, tro, trd, torch.from_numpy(length),
                                evaluate_light=tlight if with_light else None)
    _same_state(js, ts)
    np.testing.assert_array_equal(tms.scattered.numpy(), np.asarray(jms.scattered))
    assert 0.1 < float(tms.scattered.float().mean()) < 1.0
    for f in ("pos", "luminance"):
        _close(getattr(tms, f), getattr(jms, f), rtol=1e-5, atol=1e-5)
    for f in ("dir", "attenuation", "pdf"):
        _close(getattr(tms, f), getattr(jms, f), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# light learning
# ---------------------------------------------------------------------------


def _light_state(seed, g=24, e=12, big=False):
    r = np.random.default_rng(seed)
    pdf = r.random((g, e), dtype=np.float32) * (r.random((g, 1)) > 0.2)
    d = jdist.bake(jnp.asarray(pdf))
    prev = r.integers(0, 4000, g).astype(np.uint32) * (r.random(g) > 0.3)
    live = r.integers(0, 40, (g, e)).astype(np.uint32)
    if big:  # row sums past 2^32 wrap as the reference's uint32 sums
        live[:4] = np.uint32(2**31 + 5)
    return (jscene.LightState(pdf=d.pdf, cdf=d.cdf, integral=d.integral,
                              sum=jnp.asarray(prev), live=jnp.asarray(live)),
            LightState(pdf=torch.from_numpy(np.array(d.pdf)),
                       cdf=torch.from_numpy(np.array(d.cdf)),
                       integral=torch.from_numpy(np.array(d.integral)),
                       sum=torch.from_numpy(prev.astype(np.int64)),
                       live=torch.from_numpy(live.astype(np.int64))))


@pytest.mark.parametrize("seed,big", [(0, False), (1, False), (2, True)])
def test_dist1d_update_matches(seed, big):
    jl, tl = _light_state(seed, big=big)
    jd = jdist.Dist1D(pdf=jl.pdf, cdf=jl.cdf, integral=jl.integral, sum=jl.sum)
    td = dist1d.Dist1D(pdf=tl.pdf, cdf=tl.cdf, integral=tl.integral, sum=tl.sum)
    (jd2, jlive), (td2, tlive) = jdist.update(jd, jl.live), dist1d.update(td, tl.live)
    np.testing.assert_array_equal(tlive.numpy(), np.asarray(jlive).astype(np.int64))
    np.testing.assert_array_equal(td2.sum.numpy(), np.asarray(jd2.sum).astype(np.int64))
    for f in ("pdf", "cdf", "integral"):
        _close(getattr(td2, f), getattr(jd2, f), atol=1e-7)


def test_update_light_state_matches_over_frames():
    jl, tl = _light_state(3)
    r = np.random.default_rng(4)
    for _ in range(3):
        jl, tl = jscene.update_light_state(jl), update_light_state(tl)
        for f in ("sum", "live"):
            np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                          np.asarray(getattr(jl, f)).astype(np.int64))
        for f in ("pdf", "cdf", "integral"):
            _close(getattr(tl, f), getattr(jl, f), atol=1e-7)
        add = r.integers(0, 30, tl.live.shape).astype(np.uint32)
        jl = jl._replace(live=jl.live + jnp.asarray(add))
        tl = dataclasses.replace(tl, live=(tl.live + torch.from_numpy(add.astype(np.int64)))
                                 & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# media frames against the reference's
# ---------------------------------------------------------------------------

W = H = 16
BOUNCES = 3
SAMPLE = 7


def _convert(jm, ja, jl):
    return from_jax_scene(dataclasses.asdict(jm),
                          {k: np.asarray(v) for k, v in ja._asdict().items()},
                          {k: np.asarray(v) for k, v in jl._asdict().items()}, "cpu")


@functools.lru_cache(maxsize=None)
def _jax_trace(jm, desc_name):
    jd = jmedia.make_media_desc(**DESCS[desc_name])
    return jax.jit(lambda a, l, ro, rd, s: jint.trace_rays(jm, a, l, ro, rd, s, BOUNCES,
                                                           media_desc=jd))


def _render_both(scenes, eye, at, desc_name):
    (jm, ja, jl), (m, a, l) = scenes
    jc = jcam.Camera(position=np.array(eye, np.float32))
    jc.look_at(list(at))
    tc = camera.Camera(position=np.array(eye, np.float32))
    tc.look_at(list(at))
    jca = jcam.camera_arrays(jc, jcam.DofInfo(autofocus=False), W, H)
    tca = camera.camera_arrays(tc, camera.DofInfo(autofocus=False), W, H)
    js, jro, jrd = jcam.generate_primary_rays(
        jca, W, H, jrng.make_state(jnp.arange(W * H, dtype=jnp.uint32), SAMPLE))
    ts, tro, trd = camera.generate_primary_rays(tca, W, H,
                                                rng.make_state(torch.arange(W * H), SAMPLE))
    with pallas_interpret():
        jres = jax.block_until_ready(_jax_trace(jm, desc_name)(ja, jl, jro, jrd, js))
    before = dict(native.launches)
    tres = integrator.trace_rays(m, a, l, tro, trd, ts, BOUNCES,
                                 media_desc=media.make_media_desc(**DESCS[desc_name]))
    assert native.launches == before
    return jres, tres


@pytest.fixture(scope="module")
def cornell_frames():
    with pallas_interpret():
        jscn = jax_build_scene(*jax_cornell("boxes"), backend="pallas", media_enabled=True)
    port = _convert(*jscn)
    assert port[0].media_enabled
    return _render_both((jscn, port), (-4, 0, 4), (0, -1, 0), "dense")


@pytest.fixture(scope="module")
def map_frames():
    from test_torch_map_frame import AT, EYE, _map

    ents, pool, sky = _map()
    with pallas_interpret():
        jscn = jax_build_scene(ents, pool, backend="cluster", sky=sky, sort_rays=True,
                               media_enabled=True)
    port = _convert(*jscn)
    assert port[0].backend == "cluster" and port[0].media_enabled
    return _render_both((jscn, port), EYE, AT, "default")


def _check_frame(frames):
    jres, tres = frames
    jc, tc = np.asarray(jres.color), tres.color.numpy()
    assert tc.shape == jc.shape == (W * H, 3) and np.isfinite(tc).all()
    close = np.all(np.isclose(tc, jc, rtol=1e-4, atol=1e-5), axis=-1)
    assert close.mean() >= 0.97, close.mean()
    jmean, tmean = float(jc.mean()), float(tc.mean())
    assert jmean > 0 and abs(tmean - jmean) <= 0.02 * jmean
    jr, tr = float(jres.rays_traced), float(tres.rays_traced)
    assert abs(tr - jr) <= 0.01 * jr
    np.testing.assert_array_equal(tres.live.numpy(), np.asarray(jres.live).astype(np.int64))


def test_cornell_dense_media_frame_matches(cornell_frames):
    _check_frame(cornell_frames)


def test_cornell_dense_media_changes_the_frame(cornell_frames):
    """The dense medium really scatters: the frame is not the vacuum one."""
    _, tres = cornell_frames
    vac = app.render_step(app.build_cornell_scene("cpu"), app.bench_camera("cornell", W, H),
                          W, H, BOUNCES, 1, SAMPLE)
    assert abs(float(vac.color.mean()) - float(tres.color.mean())) > 1e-3


def test_map_default_media_frame_matches(map_frames):
    _check_frame(map_frames)


# ---------------------------------------------------------------------------
# the brute media arbiter (slow)
# ---------------------------------------------------------------------------


def _trace_brute_media(meta, arrays, desc, ro, rd, state, vertices):
    """Brute random walk: emission at every surface vertex with weight 1, no
    NEE and no MIS -- another estimator family than trace_rays, the same
    transport (the port's copy of tests/test_media.py::_trace_brute_media)."""
    from pim_tpu_torch.math.brdf import BrdfLut
    from pim_tpu_torch.math.vec3 import EPS, RCP_EPS, avg_lum3, saturate, where3
    from pim_tpu_torch.render.bsdf import scatter_principled
    from pim_tpu_torch.render.scene import scene_intersect
    from pim_tpu_torch.render.surface import (fetch_hit_attribs, get_emission_from_attribs,
                                              get_surface)

    n = ro.x.shape[0]
    lum = V3.zeros(n, "cpu")
    atten = V3.ones(n, "cpu")
    alive = torch.ones((n,), dtype=torch.bool)
    lut = BrdfLut(texels=arrays.brdf_lut)
    for _ in range(vertices):
        state, u_rr = rng.next_f32(state)
        p = saturate(avg_lum3(atten))
        survive = u_rr < p
        atten = atten * torch.where(alive & survive, 1.0 / torch.clamp_min(p, EPS), 1.0)
        alive = alive & survive
        hit = scene_intersect(meta, arrays, ro, rd, 0.0, torch.where(alive, RCP_EPS, 0.0))
        missed = hit.tri < 0
        state, ms = media.scatter_ray(desc, state, ro, rd, torch.where(missed, RCP_EPS, hit.t))
        scattered = alive & ms.scattered
        atten = where3(scattered, atten * ms.attenuation * (1.0 / torch.clamp_min(ms.pdf, EPS)),
                       where3(alive, atten * ms.attenuation, atten))
        surf_alive = alive & ~scattered & ~missed & ~hit.backface
        at = fetch_hit_attribs(meta, arrays, hit)
        lum = lum + get_emission_from_attribs(meta, at) * atten * surf_alive.to(torch.float32)
        surf = get_surface(meta, rd, hit, at)
        state, scat = scatter_principled(lut, surf, rd, state)
        cont = surf_alive & (scat.pdf > EPS)
        atten = where3(cont, atten * scat.attenuation * (1.0 / torch.clamp_min(scat.pdf, EPS)),
                       atten)
        ro = where3(scattered, ms.pos, where3(cont, scat.pos, ro))
        rd = where3(scattered, ms.dir, where3(cont, scat.dir, rd))
        alive = cont | scattered
    return lum


@pytest.mark.slow
def test_media_brute_vs_framework():
    """The port's media integrator against the brute walk: a two-sample
    z-test on image means over independent chunks (|z| < 4), as the
    reference's test."""
    from pim_tpu_torch.geom.cornell import build_cornell_box
    from pim_tpu_torch.geom.material import Material
    from pim_tpu_torch.render.scene import build_scene
    from tests.oracle.pt_oracle import pinhole_rays

    ents, pool = build_cornell_box("boxes")
    for i in range(ents.count):
        if ents.names[i] == "Cornell_Ceil":
            m = ents.materials[i]
            ents.materials[i] = Material(albedo_tex=m.albedo_tex,
                                         rome_tex=pool.add_flat((0.9, 1.0, 0.0, 0.1)),
                                         flags=m.flags, ior=m.ior)
    ents.touch()
    meta, arrays, lights = build_scene(ents, pool, "cpu", media_enabled=True)
    desc = media.make_media_desc(**DENSE)
    w = h = 16
    bounces = 8
    ro_np, rd_np = pinhole_rays(w, h, (-4, 0, 4), (4, -1, -4), (0, 1, 0), 60)
    n = w * h
    ro = V3(*(torch.from_numpy(np.ascontiguousarray(ro_np[:, i], np.float32)) for i in range(3)))
    rd = V3(*(torch.from_numpy(np.ascontiguousarray(rd_np[:, i], np.float32)) for i in range(3)))
    pix = torch.arange(n)

    def fw(s, seed):
        st = rng.make_state(pix, s, seed=seed)
        return integrator.trace_rays(meta, arrays, lights, ro, rd, st, bounces,
                                     media_desc=desc).color

    def br(s, seed):
        return _trace_brute_media(meta, arrays, desc, ro, rd, rng.make_state(pix, s, seed=seed),
                                  bounces + 4).aos()

    chunks, spp = 4, 64

    def render(fn, seed0):
        return np.asarray([np.mean(sum(fn(s, seed0 + c).double().numpy() for s in range(spp))
                                   / spp) for c in range(chunks)])

    f, b = render(fw, 40), render(br, 80)
    f_m, f_se = f.mean(), f.std(ddof=1) / np.sqrt(chunks)
    b_m, b_se = b.mean(), b.std(ddof=1) / np.sqrt(chunks)
    z = (f_m - b_m) / np.sqrt(f_se**2 + b_se**2 + 1e-20)
    print(f"[media] port={f_m:.5f}+-{f_se:.5f} brute={b_m:.5f}+-{b_se:.5f} z={z:+.2f}")
    assert abs(z) < 4.0, (f_m, f_se, b_m, b_se, z)
