"""The slice as a whole: the port's 16^2, 3-bounce, 1-spp Cornell frame
against pim_tpu's on the identical (converted) scene and seed.

At least 97% of pixels must agree at rtol 1e-4 / atol 1e-5: the rest are
paths that diverged after an ulp-level compare flip (light slot, Russian
roulette).  The image means must agree within 2% and rays_traced within
1%.  The camera's primary rays (with the DoF draws) agree at rtol 1e-6.

The app's frame step at SPP_STEP samples folds them as the reference's
frame step does: its light histogram is bit for bit the 32-bit-wrapped sum
of the reference's per-sample histograms for the same sample ids, and its
AOVs are the samples' mean (the pixel tolerance above).  Media frames are
held in test_torch_media.py."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import pallas_interpret

from pim_tpu.core import rng as jrng
from pim_tpu.geom.cornell import build_cornell_box as jax_cornell
from pim_tpu.render import camera as jcam
from pim_tpu.render import integrator as jint
from pim_tpu.render.scene import build_scene as jax_build_scene
from pim_tpu_torch import app, native
from pim_tpu_torch.core import rng
from pim_tpu_torch.render import camera, integrator, render_system
from pim_tpu_torch.render.scene import from_jax_scene

torch.set_num_threads(2)

W = H = 16
BOUNCES = 3
SAMPLE = 5
SPP_STEP = 2
STEP = 3  # the frame step's sample ids: STEP * SPP_STEP + i


@pytest.fixture(scope="module")
def scenes():
    with pallas_interpret():
        jm, ja, jl = jax_build_scene(*jax_cornell("boxes"), backend="pallas")
    port = from_jax_scene(dataclasses.asdict(jm),
                          {k: np.asarray(v) for k, v in ja._asdict().items()},
                          {k: np.asarray(v) for k, v in jl._asdict().items()}, "cpu")
    return (jm, ja, jl), port


def _cams(width=W, height=H):
    jc = jcam.Camera(position=np.array([-4, 0, 4], np.float32))
    jc.look_at([0, -1, 0])
    return (jcam.camera_arrays(jc, jcam.DofInfo(autofocus=False), width, height),
            app.bench_camera("cornell", width, height))


def _rays(enable_dof=True):
    jca, tca = _cams()
    js = jrng.make_state(jnp.arange(W * H, dtype=jnp.uint32), SAMPLE)
    js, jro, jrd = jcam.generate_primary_rays(jca, W, H, js, enable_dof=enable_dof)
    ts = rng.make_state(torch.arange(W * H), SAMPLE)
    ts, tro, trd = camera.generate_primary_rays(tca, W, H, ts, enable_dof=enable_dof)
    return (js, jro, jrd), (ts, tro, trd)


@functools.lru_cache(maxsize=None)
def _jax_trace(jm):
    # one executable, finished before anything else is dispatched (see
    # pallas_interpret)
    return jax.jit(lambda a, l, ro, rd, s: jint.trace_rays(jm, a, l, ro, rd, s, BOUNCES))


@pytest.fixture(scope="module")
def frames(scenes):
    (jm, ja, jl), (m, a, l) = scenes
    (js, jro, jrd), (ts, tro, trd) = _rays()
    with pallas_interpret():
        jres = jax.block_until_ready(_jax_trace(jm)(ja, jl, jro, jrd, js))
    tres = integrator.trace_rays(m, a, l, tro, trd, ts, BOUNCES)
    return jres, tres


@pytest.fixture(scope="module")
def frame_step(scenes):
    """(the reference's per-sample trace results, the app's frame step) for
    the sample ids STEP * SPP_STEP + i, i < SPP_STEP."""
    (jm, ja, jl), port = scenes
    jca, tca = _cams()
    jres = []
    for i in range(SPP_STEP):
        js = jrng.make_state(jnp.arange(W * H, dtype=jnp.uint32), STEP * SPP_STEP + i)
        js, jro, jrd = jcam.generate_primary_rays(jca, W, H, js)
        with pallas_interpret():
            jres.append(jax.block_until_ready(_jax_trace(jm)(ja, jl, jro, jrd, js)))
    return jres, app.render_step(port, tca, W, H, BOUNCES, SPP_STEP, STEP)


@pytest.mark.parametrize("enable_dof", [True, False])
def test_primary_rays_match(enable_dof):
    (js, jro, jrd), (ts, tro, trd) = _rays(enable_dof)
    for a, b in zip(js, ts):  # the same RNG words were drawn
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())
    for a, b in zip(list(jro) + list(jrd), list(tro) + list(trd)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)


def test_frame_pixels_agree(frames):
    jres, tres = frames
    jc, tc = np.asarray(jres.color), tres.color.numpy()
    assert tc.shape == jc.shape == (W * H, 3) and np.isfinite(tc).all()
    close = np.all(np.isclose(tc, jc, rtol=1e-4, atol=1e-5), axis=-1)
    assert close.mean() >= 0.97, close.mean()


def test_frame_mean_and_rays_agree(frames):
    jres, tres = frames
    jmean, tmean = float(np.mean(np.asarray(jres.color))), float(tres.color.mean())
    assert jmean > 0 and abs(tmean - jmean) <= 0.02 * jmean
    jr, tr = float(jres.rays_traced), float(tres.rays_traced)
    assert abs(tr - jr) <= 0.01 * jr


@pytest.mark.parametrize("aov", ["albedo", "normal"])
def test_frame_aovs_agree(frames, aov):
    jres, tres = frames
    close = np.all(np.isclose(getattr(tres, aov).numpy(), np.asarray(getattr(jres, aov)),
                              rtol=1e-4, atol=1e-5), axis=-1)
    assert close.mean() >= 0.97, close.mean()


def test_accumulate_and_stddev_match(frames):
    jres, _ = frames
    rs = np.random.default_rng(0)
    prev = [rs.random((W * H, 3), dtype=np.float32) for _ in range(3)]
    tres = integrator.TraceResult(*(torch.from_numpy(np.array(jres[i])) for i in range(3)),
                                  live=None, rays_traced=None)
    jb = jint.accumulate(jint.TraceBuffers(*map(jnp.asarray, prev)), jres, 1.0 / 3.0)
    tb = integrator.accumulate(integrator.TraceBuffers(*map(torch.from_numpy, prev)), tres,
                               1.0 / 3.0)
    for a, b in zip(jb, tb):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    col = rs.random((W * H, 3), dtype=np.float32)
    np.testing.assert_allclose(float(integrator.luminance_stddev(torch.from_numpy(col))),
                               float(jint.luminance_stddev(jnp.asarray(col))), rtol=1e-5)


def test_app_frame_on_cpu_runs_plain_path(scenes):
    _, port = scenes
    before = dict(native.launches)
    fr = app.render_frame(port, "cornell", 8, 8, 2, 2, 2)
    assert native.launches == before and all(v == 0 for v in fr.launches.values())
    assert fr.buffers.color.shape == (64, 3) and bool(torch.isfinite(fr.buffers.color).all())
    assert fr.rays > 2 * 64 and fr.mean > 0 and fr.warmup_seconds > 0 and fr.ms_per_step > 0


def test_app_main_prints_the_frame_report(capsys):
    app.main(["--device", "cpu", "--width", "8", "--height", "8", "--bounces", "2",
              "--spp", "1", "--steps", "2"])
    lines = dict(ln.split(": ", 1) for ln in capsys.readouterr().out.splitlines())
    assert set(lines) == {"image mean", "luminance_stddev", "rays traced", "ms/step", "Mrays/s",
                          "launches"}
    assert float(lines["image mean"]) > 0 and float(lines["rays traced"]) > 2 * 64
    assert lines["launches"] == " ".join(f"{k}=0" for k in native.launches)
    assert "dense_isect=0" in lines["launches"] and "gather_cols=0" in lines["launches"]


def test_frame_step_sums_the_light_histograms(frame_step):
    jres, tres = frame_step
    want = np.zeros(np.asarray(jres[0].live).shape, np.uint32)
    for r in jres:
        want = want + np.asarray(r.live, np.uint32)  # the reference's wrapping uint32 sum
    assert tres.live.dtype == torch.int64 and int(want.sum()) > 0
    np.testing.assert_array_equal(tres.live.numpy(), want.astype(np.int64))


def test_frame_step_wraps_the_histogram_sum_to_32_bits(scenes, monkeypatch):
    _, port = scenes
    near = np.uint32(2**32 - 3)
    jl = port[2].live

    def trace(meta, arrays, lights, ro, rd, state, bounces):
        n = ro.x.shape[0]
        z = torch.zeros((n, 3))
        return integrator.TraceResult(color=z, albedo=z, normal=z,
                                      live=torch.full(jl.shape, int(near), dtype=torch.int64),
                                      rays_traced=torch.tensor(float(n)))

    monkeypatch.setattr(render_system, "trace_rays", trace)
    res = app.render_step(port, _cams(4, 4)[1], 4, 4, 1, SPP_STEP, 0)
    want = np.full(jl.shape, near, np.uint32) + np.full(jl.shape, near, np.uint32)
    np.testing.assert_array_equal(res.live.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("aov", ["color", "albedo", "normal"])
def test_frame_step_means_the_samples(frame_step, aov):
    jres, tres = frame_step
    want = np.asarray(jres[0]._asdict()[aov]) + np.asarray(jres[1]._asdict()[aov])
    want = want * np.float32(1.0 / SPP_STEP)
    got = getattr(tres, aov).numpy()
    assert got.shape == want.shape == (W * H, 3) and np.abs(want).sum() > 0
    close = np.all(np.isclose(got, want, rtol=1e-4, atol=1e-5), axis=-1)
    assert close.mean() >= 0.97, close.mean()



@pytest.mark.parametrize("tag", ["cornell512", "e1m1_128", "e1m1_512"])
def test_gate_band(tag):
    """app.gate_band: the band of render/gate_bands.json as (lo, hi), its
    mean -/+ its half width."""
    with open(app.GATE_BANDS) as fh:
        band = json.load(fh)[tag]
    assert app.gate_band(tag) == (band["mean"] - band["half"], band["mean"] + band["half"])


def test_gate_band_without_a_band():
    assert app.gate_band("no_such_band") is None
