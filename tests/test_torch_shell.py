"""The port's engine shell against pim_tpu's.

- The frame step (`render_system.frame_step`) against the reference's
  `_make_frame_step` on the identical (converted) Cornell scene at 16^2,
  3 bounces, over 3 frames with autofocus and light learning, at 1 and 2
  samples a step: the color at the frame tolerance of
  test_torch_frame.py (97% of pixels at rtol 1e-4 / atol 1e-5), the light
  histogram and its row sums bit for bit, the learned light pdf and cdf,
  the exposure state and the autofocus focal length at rtol 1e-6.
- The display path: the tonemap at rtol 1e-6, the dithered u8 screenshot
  within 1 of the reference's on at most 0.1% of its values and equal
  elsewhere (with the fitted tonemap of `r_tonemap_fit 1`, whose curve
  each package fits from its own random population: within 1 on at most
  3%), the denoiser at rtol 1e-5, the PNG writer and reader across
  packages, the color helpers at rtol 1e-6 (2e-6 where a power or a
  3-term matrix row compounds; 5e-5 through PQ's m2 = 78.84 power, which
  magnifies an ulp of its base 79 times), the curve fit's quality.
- The shell (counterparts of tests/test_core.py and
  tests/test_render_system.py): the command queue, progressive frames,
  checkpoints that resume bit for bit (also a crate pim_tpu wrote, resumed
  by the port, and the other way round), map save/load and mapgen,
  cvar-driven rebuilds (pt_media among them), pt_gate pass and fail on the
  port's own bands, pt_spp batching, the batch exit code and the CLI run
  that writes two PNGs.
- The bakes through the shell on Cornell (lm_gen 1 at 1 texel/m,
  r_refl_gen 1 with an 8^2 probe, probe_bake with 256 rays, 3 bounces,
  2 frames) against pim_tpu's shell: the lightmap's sample counts bit for
  bit and its probes, the reflection probe's color and mips by the frame
  rule above (97% of values, means within 2%), the light probe within 2%
  of its largest value (a few of its 256 rays may diverge); a bake
  checkpoint resumed bit for bit; a pim_tpu crate with a lightmap (no
  `axii`) and a light probe resumed by the port, which pim_tpu cannot
  load (ROADMAP F11).
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import pallas_interpret

from pim_tpu.core import cvars as jcv
from pim_tpu.geom.cornell import build_cornell_box as jax_cornell
from pim_tpu.math import color as jcolor
from pim_tpu.math import cubic_fit as jfit
from pim_tpu.render import camera as jcam
from pim_tpu.render import denoise as jdenoise
from pim_tpu.render import exposure as jexp
from pim_tpu.render import integrator as jint
from pim_tpu.render import render_system as jrs
from pim_tpu.render import screenshot as jshot
from pim_tpu.render.scene import build_scene as jax_build_scene
from pim_tpu_torch import app
from pim_tpu_torch.core import cvars as cv
from pim_tpu_torch.core import profiler
from pim_tpu_torch.core.cmd import CmdStat, CmdSystem, cmd_getopt, get_cmd_system
from pim_tpu_torch.core.crate import Crate
from pim_tpu_torch.math import color, cubic_fit
from pim_tpu_torch.render import camera, denoise, exposure, render_system, screenshot
from pim_tpu_torch.render.integrator import make_trace_buffers
from pim_tpu_torch.render.render_system import RenderSystem
from pim_tpu_torch.render.scene import from_jax_scene

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_calibrator():
    """tools/calibrate_torch_pt_gate.py, the JAX-side tool that derived the
    port's bands (it is no module of either package)."""
    path = os.path.join(ROOT, "tools", "calibrate_torch_pt_gate.py")
    spec = importlib.util.spec_from_file_location("calibrate_torch_pt_gate", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


calibrate_pt_gate = _load_calibrator()
W = H = 16
BOUNCES = 3
FRAMES = 3
DT = 1.0 / 60.0
SEED = 0x9E3779B9


def _frame_close(got, want):
    close = np.all(np.isclose(got, want, rtol=1e-4, atol=1e-5), axis=-1)
    assert close.mean() >= 0.97, close.mean()


# ---------------------------------------------------------------------------
# the frame step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scenes():
    with pallas_interpret():
        jm, ja, jl = jax_build_scene(*jax_cornell("boxes"), backend="pallas")
    port = from_jax_scene(dataclasses.asdict(jm),
                          {k: np.asarray(v) for k, v in ja._asdict().items()},
                          {k: np.asarray(v) for k, v in jl._asdict().items()}, "cpu")
    return (jm, ja, jl), port


def _run_steps(scenes, spp):
    """FRAMES frames of both frame steps; per frame (jax out, port out).  The
    light histograms start from the same seeded counts, so cells cross the
    fold's 30-hit threshold from the first frame on (a 16^2 frame alone
    reaches it in no cell)."""
    (jm, ja, jl), (m, a, l) = scenes
    live0 = np.random.default_rng(9).integers(0, 40, jl.live.shape).astype(np.uint32)
    jl = jl._replace(live=jnp.asarray(live0))
    l = dataclasses.replace(l, live=torch.from_numpy(live0.astype(np.int64)))
    jc, tc = jcam.Camera(), camera.Camera()
    for c in (jc, tc):
        c.position = np.array([-4, 0, 4], np.float32)
        c.look_at([0, -1, 0])
    jdof, tdof = jcam.DofInfo(), camera.DofInfo()
    jstep = jrs._make_frame_step(jm, W, H, BOUNCES, jdof.blade_count, jdof.blade_rot,
                                 jdof.autofocus_speed, False, spp)
    tcfg = render_system.FrameConfig(m, W, H, BOUNCES, tdof.blade_count, tdof.blade_rot,
                                     tdof.autofocus_speed, False, spp)
    jbuf, tbuf = jint.make_trace_buffers(W, H), make_trace_buffers(W, H, "cpu")
    jes, tes = jexp.make_exposure_state(), exposure.make_exposure_state()
    out = []
    count = 0
    for _ in range(FRAMES):
        base = count
        count += spp
        jcam_a = jcam.camera_arrays(jc, jdof, W, H, focal_length=jdof.focal_length)
        tcam_a = camera.camera_arrays(tc, tdof, W, H, focal_length=tdof.focal_length)
        with pallas_interpret():
            jbuf, jl, jes, jfocal = jax.block_until_ready(jstep(
                ja, jl, jbuf, jes, jexp.ExposureParams.from_cvars(), jcam_a, jnp.uint32(base),
                jnp.float32(spp / count), jnp.float32(DT), jnp.asarray(True), jnp.uint32(SEED)))
        tbuf, l, tes, tfocal = render_system.frame_step(
            tcfg, a, l, tbuf, tes, exposure.ExposureParams.from_cvars(), tcam_a, base,
            np.float32(spp / count).item(), np.float32(DT).item(), True, SEED)
        jdof.focal_length = float(jfocal)
        tdof.focal_length = float(tfocal)
        out.append(((jbuf, jl, jes, float(jfocal)), (tbuf, l, tes, float(tfocal))))
    return out


@pytest.fixture(scope="module", params=[1, 2], ids=["spp1", "spp2"])
def steps(request, scenes):
    return _run_steps(scenes, request.param)


def test_frame_step_color_matches(steps):
    for (jbuf, *_), (tbuf, *_) in steps:
        got, want = tbuf.color.numpy(), np.asarray(jbuf.color)
        assert np.isfinite(got).all() and got.mean() > 0
        _frame_close(got, want)


def test_frame_step_light_learning_matches(steps):
    learned = False
    for (_, jl, _, _), (_, tl, _, _) in steps:
        for f in ("live", "sum"):
            np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                          np.asarray(getattr(jl, f)).astype(np.int64), err_msg=f)
        for f in ("pdf", "cdf", "integral"):
            np.testing.assert_allclose(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)),
                                       rtol=1e-6, atol=1e-7, err_msg=f)
        learned = learned or int(tl.sum.max()) > 0
    assert learned  # some cell folded its histogram


def test_frame_step_exposure_and_focus_match(steps):
    for (_, _, jes, jf), (_, _, tes, tf) in steps:
        np.testing.assert_allclose(float(tes.avg_lum), float(jes.avg_lum), rtol=1e-6)
        np.testing.assert_allclose(float(tes.exposure), float(jes.exposure), rtol=1e-6)
        np.testing.assert_allclose(tf, jf, rtol=1e-6)
    assert steps[-1][1][3] != camera.DofInfo().focal_length  # autofocus moved


# ---------------------------------------------------------------------------
# the display path
# ---------------------------------------------------------------------------


def _hdr(seed=0, h=24, w=20):
    r = np.random.default_rng(seed)
    return (r.random((h, w, 3), dtype=np.float32) ** 3 * 8.0).astype(np.float32)


@pytest.mark.parametrize("use_fit", [False, True])
def test_tonemap_matches(use_fit):
    """The GT tonemap at rtol 1e-6.  With `r_tonemap_fit 1` each package
    fits its own rational curve from its own random population (the port a
    seeded torch.Generator, the reference jax.random), so the fitted curves
    differ: the display values by at most 5e-4 (0.13 of a u8 step; 2.2e-4
    seen) and the dithered u8 screenshot by at most 1 on at most 3% of its
    values (1.3-1.6% seen).  Either fit departs from the exact curve by up
    to 6 u8 steps on three quarters of the values."""
    hdr = _hdr()
    want = np.asarray(jshot.tonemap_for_display(jnp.asarray(hdr), jnp.float32(0.7),
                                                use_fit=use_fit))
    got = screenshot.tonemap_for_display(torch.from_numpy(hdr), torch.tensor(0.7),
                                         use_fit=use_fit).numpy()
    if not use_fit:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
    hdr = _hdr(0, 64, 48)
    want = jshot.quantize_dithered(jshot.tonemap_for_display(jnp.asarray(hdr), jnp.float32(1.3),
                                                             use_fit=True))
    got = screenshot.quantize_dithered(screenshot.tonemap_for_display(
        torch.from_numpy(hdr), torch.tensor(1.3), use_fit=True))
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.03, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("seed", [0, 1])
def test_screenshot_u8_matches(seed):
    hdr = _hdr(seed, 64, 48)
    want = jshot.quantize_dithered(jshot.tonemap_for_display(jnp.asarray(hdr), jnp.float32(1.3),
                                                             use_fit=False))
    got = screenshot.quantize_dithered(screenshot.tonemap_for_display(
        torch.from_numpy(hdr), torch.tensor(1.3), use_fit=False))
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_dither_words_are_the_reference_words():
    """quantize_dithered's noise: a flat 0.5 image lands on the RNG words."""
    flat = np.full((8, 8, 3), 0.5, np.float32)
    np.testing.assert_array_equal(screenshot.quantize_dithered(torch.from_numpy(flat)),
                                  jshot.quantize_dithered(jnp.asarray(flat)))


def test_png_round_trip_across_packages(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (9, 13, 3), dtype=np.uint8)
    screenshot.write_png(str(tmp_path / "a.png"), img, flip_vertical=True)
    jshot.write_png(str(tmp_path / "b.png"), img, flip_vertical=True)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    np.testing.assert_array_equal(screenshot.read_png(str(tmp_path / "b.png")), img[::-1])
    np.testing.assert_array_equal(jshot.read_png(str(tmp_path / "a.png")), img[::-1])


@pytest.mark.parametrize("kind", ["Image", "Lightmap"])
@pytest.mark.parametrize("aovs", [True, False])
def test_denoise_matches(kind, aovs):
    r = np.random.default_rng(4)
    h, w = 12, 20
    c = (r.random((h * w, 3), dtype=np.float32) * 3).astype(np.float32)
    al = r.random((h * w, 3), dtype=np.float32)
    nn = r.normal(size=(h * w, 3)).astype(np.float32)
    jargs = (jnp.asarray(al), jnp.asarray(nn)) if aovs else (None, None)
    targs = (torch.from_numpy(al), torch.from_numpy(nn)) if aovs else (None, None)
    want = np.asarray(jdenoise.denoise(getattr(jdenoise.DenoiseType, kind), w, h,
                                       jnp.asarray(c), *jargs))
    got = denoise.denoise(getattr(denoise.DenoiseType, kind), w, h, torch.from_numpy(c),
                          *targs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dy,dx", [(0, 0), (3, -2), (-16, 16), (32, -32)])
def test_denoise_shift_keeps_the_edges(dy, dx):
    img = np.random.default_rng(5).random((12, 20, 3), dtype=np.float32)
    np.testing.assert_array_equal(denoise._shift2d(torch.from_numpy(img), dy, dx).numpy(),
                                  np.asarray(jdenoise._shift2d(jnp.asarray(img), dy, dx)))


_COLOR_FNS = [("srgb_oetf", 1e-6), ("srgb_eotf", 2e-6), ("gt_tonemap", 2e-6),
              ("reinhard", 1e-6), ("aces_fitted", 1e-6), ("pq_eotf", 2e-6),
              ("pq_inverse_eotf", 5e-5), ("pq_oetf", 5e-5), ("pq_oetf_fit", 1e-6),
              ("hlg_oetf", 2e-6), ("g_rec709", 2e-6), ("pack_emission", 1e-6),
              ("luminance_709", 1e-6), ("avg_lum", 1e-6), ("rec709_to_rec2020", 2e-6),
              ("ap0_to_rec709", 2e-6), ("rec2020_to_ap1", 2e-6), ("hlg_ootf", 2e-6),
              ("color_scene_to_hdr", 2e-6)]


@pytest.mark.parametrize("name,rtol", _COLOR_FNS, ids=[n for n, _ in _COLOR_FNS])
def test_color_function_matches(name, rtol):
    x = np.random.default_rng(6).random((257, 3), dtype=np.float32) * 2.0
    want = np.asarray(getattr(jcolor, name)(jnp.asarray(x)))
    got = getattr(color, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)


def test_dither_u8_matches():
    r = np.random.default_rng(7)
    x, nz = r.random((2, 513), dtype=np.float32)
    np.testing.assert_array_equal(color.dither_u8(torch.from_numpy(x), torch.from_numpy(nz)),
                                  np.asarray(jcolor.dither_u8(jnp.asarray(x), jnp.asarray(nz))))


@pytest.mark.parametrize("kind", ["cubic", "sqrtic", "tmap", "poly"])
def test_curve_models_match(kind):
    r = np.random.default_rng(8)
    xs = np.linspace(0.0, 4.0, 64, dtype=np.float32)
    coeffs = r.random(8, dtype=np.float32)
    want = np.asarray(jfit._EVALS[kind](jnp.asarray(xs), jnp.asarray(coeffs)))
    got = cubic_fit._EVALS[kind](torch.from_numpy(xs), torch.from_numpy(coeffs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_profile_marks_wait_on_a_device():
    """`profile(name, block_on=device)` ends its mark after the device's
    queued work; a CPU device (by name or torch.device) has none."""
    prof = profiler.Profiler()
    for dev in ("cpu", torch.device("cpu")):
        with prof.mark("Pt_Trace", block_on=dev):
            torch.ones(4).sum()
    with prof.mark("Pt_Trace"):
        pass
    assert prof.stats["Pt_Trace"].calls == 3


def test_curve_fit_quality():
    """The port draws its mutations from a torch.Generator, not from
    jax.random, so its fit is held by its error: a GT-tonemap fit close to
    the reference's (within 2x its rms error), seeded and reproducible."""
    xs = np.linspace(0.0, 4.0, 64, dtype=np.float32)
    ys = np.array(jcolor.gt_tonemap(jnp.asarray(xs), m=0.5))
    _, jerr = jfit.curve_fit(jnp.asarray(xs), jnp.asarray(ys), kind="tmap", iterations=150,
                             population=64, seed=7)
    c1, e1 = cubic_fit.curve_fit(torch.from_numpy(xs), torch.from_numpy(ys), kind="tmap",
                                 iterations=150, population=64, seed=7)
    c2, _ = cubic_fit.curve_fit(torch.from_numpy(xs), torch.from_numpy(ys), kind="tmap",
                                iterations=150, population=64, seed=7)
    assert torch.equal(c1, c2)
    assert float(e1) <= 2.0 * float(jerr) + 1e-4, (float(e1), float(jerr))


# ---------------------------------------------------------------------------
# the shell
# ---------------------------------------------------------------------------

_SAVED = (cv.cv_pt_trace, cv.cv_pt_max_bounces, cv.cv_r_width, cv.cv_r_height, cv.cv_r_scale,
          cv.cv_pt_backend, cv.cv_exp_manual, cv.cv_pt_media, cv.cv_pt_spp, cv.cv_pt_seed,
          cv.cv_pt_denoise, cv.cv_exp_evoffset, cv.cv_basedir, cv.cv_lm_gen, cv.cv_r_refl_gen,
          cv.cv_lm_density)


@pytest.fixture()
def rs(tmp_path, monkeypatch):
    """A small CPU render system of Cornell in a scratch cwd; the cvars and
    the command queue are restored afterwards."""
    monkeypatch.chdir(tmp_path)
    saved = [(c, c.get()) for c in _SAVED]
    cv.cv_pt_max_bounces.set(BOUNCES)
    cv.cv_pt_trace.set(True)
    cv.cv_exp_manual.set(True)
    get_cmd_system().reset()
    sys = RenderSystem(width=W, height=H, device="cpu")
    sys.init()
    assert get_cmd_system().immediate("cornell_box") == CmdStat.OK
    sys.camera.position = np.asarray([-4.0, 0.0, 4.0], np.float32)
    sys.camera.look_at([0.0, -1.0, 0.0])
    sys.dof.autofocus = False
    yield sys
    for c, v in saved:
        c.set(v)
    get_cmd_system().reset()


def _frames(rs, k):
    for _ in range(k):
        rs.update()


def test_render_system_defaults_to_the_card():
    assert RenderSystem.__dataclass_fields__["device"].default == "cuda"
    assert app.Engine.__dataclass_fields__["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RenderSystem()


def test_cmd_queue_wait_semantics():
    sys = CmdSystem()
    log = []
    sys.reg("mark", lambda argv: (log.append(argv[1]), CmdStat.OK)[1])
    sys.enqueue("mark a; wait 2; mark b")
    sys.update()
    assert log == ["a"]
    sys.update()
    assert log == ["a"]
    sys.update()
    assert log == ["a", "b"] and not sys.pending()
    assert cmd_getopt(["pt_test", "-frames", "100"], "frames") == "100"
    assert cmd_getopt(["pt_test", "-nogate"], "nogate", flag=True)


def test_crate_round_trip(tmp_path):
    c = Crate()
    c.set("a", {"x": np.arange(6, dtype=np.float32).reshape(2, 3), "n": "s", "v": 3})
    c.save(str(tmp_path / "t.crate"))
    got = Crate.load(str(tmp_path / "t.crate")).get("a")
    np.testing.assert_array_equal(got["x"], np.arange(6, dtype=np.float32).reshape(2, 3))
    assert (got["n"], got["v"]) == ("s", 3)


def test_progressive_frames_accumulate(rs):
    _frames(rs, 2)
    assert rs.sample_count == 2
    img = rs.buffers.color.numpy()
    assert np.isfinite(img).all() and img.mean() > 0.0


def test_checkpoint_resume_bit_identical(rs):
    _frames(rs, 2)
    rs.checkpoint_save("maps/t.ckpt.crate")
    _frames(rs, 2)
    ref_img = rs.buffers.color.clone()
    ref_live = rs.lights.live.clone()

    fresh = RenderSystem(width=4, height=4, device="cpu")  # the checkpoint fixes the size
    fresh.init()
    fresh.checkpoint_load("maps/t.ckpt.crate")
    assert (fresh.width, fresh.height, fresh.sample_count) == (W, H, 2)
    _frames(fresh, 2)
    assert fresh.sample_count == 4
    assert torch.equal(fresh.buffers.color, ref_img)
    assert torch.equal(fresh.lights.live, ref_live)


def _jax_rs(tmp_path):
    """pim_tpu's RenderSystem of the same Cornell view (its CPU backend)."""
    jcv.cv_pt_max_bounces.set(BOUNCES)
    jcv.cv_pt_trace.set(True)
    jcv.cv_exp_manual.set(True)
    sys = jrs.RenderSystem(width=W, height=H)
    sys.entities, sys.pool = jax_cornell("boxes")
    sys.camera.position = np.asarray([-4.0, 0.0, 4.0], np.float32)
    sys.camera.look_at([0.0, -1.0, 0.0])
    sys.dof.autofocus = False
    return sys


def test_checkpoint_from_the_reference_resumes_in_the_port(rs, tmp_path):
    """pim_tpu renders 2 frames and saves; the port loads its crate (the same
    state, bit for bit) and renders 2 more frames, as pim_tpu does: the two
    continuations agree at the frame tolerance."""
    saved = [(c, c.get()) for c in (jcv.cv_pt_max_bounces, jcv.cv_pt_trace, jcv.cv_exp_manual)]
    try:
        jsys = _jax_rs(tmp_path)
        for _ in range(2):
            jsys.update()
        jsys.checkpoint_save(str(tmp_path / "j.ckpt.crate"))
        rs.checkpoint_load(str(tmp_path / "j.ckpt.crate"))
        np.testing.assert_array_equal(rs.buffers.color.numpy(), np.asarray(jsys.buffers.color))
        for f in ("live", "sum"):
            np.testing.assert_array_equal(getattr(rs.lights, f).numpy(),
                                          np.asarray(getattr(jsys.lights, f)).astype(np.int64))
        np.testing.assert_array_equal(rs.lights.pdf.numpy(), np.asarray(jsys.lights.pdf))
        assert float(rs.exp_state.exposure) == float(jsys.exp_state.exposure)
        assert rs.sample_count == 2 and rs.meta.tri_count == jsys.meta.tri_count
        for _ in range(2):
            jsys.update()
        _frames(rs, 2)
        assert rs.sample_count == jsys.sample_count == 4
        _frame_close(rs.buffers.color.numpy(), np.asarray(jsys.buffers.color))

        # and the port's crate loads in pim_tpu
        rs.checkpoint_save(str(tmp_path / "t.ckpt.crate"))
        back = jrs.RenderSystem()
        back.checkpoint_load(str(tmp_path / "t.ckpt.crate"))
        np.testing.assert_array_equal(np.asarray(back.buffers.color), rs.buffers.color.numpy())
        np.testing.assert_array_equal(np.asarray(back.lights.live).astype(np.int64),
                                      rs.lights.live.numpy())
        assert back.sample_count == 4
    finally:
        for c, v in saved:
            c.set(v)


def test_mapsave_round_trips_textures(rs):
    q = get_cmd_system()
    assert q.immediate("mapsave t1") == CmdStat.OK
    n_tex = len(rs.pool)
    fresh = RenderSystem(width=W, height=H, device="cpu")
    fresh.init()
    assert get_cmd_system().immediate("mapload t1") == CmdStat.OK
    assert len(fresh.pool) == n_tex > 0
    for i in range(n_tex):
        np.testing.assert_array_equal(fresh.pool.get(i), rs.pool.get(i))
    fresh.camera.position = np.asarray([-4.0, 0.0, 4.0], np.float32)
    fresh.camera.look_at([0.0, -1.0, 0.0])
    fresh.dof.autofocus = False
    _frames(fresh, 1)
    assert float(fresh.buffers.color.mean()) > 0.0


def test_mapload_gltf_and_loadtest(rs):
    cv.cv_basedir.set(os.path.join(ROOT, "data"))
    q = get_cmd_system()
    assert q.immediate("mapload e1m1") == CmdStat.OK
    assert rs.entities.count > 100
    assert q.immediate("mapload no_such_map") == CmdStat.ERR


def test_mapgen_writes_the_reference_asset(rs, tmp_path):
    """mapgen exports the procedural map as the JAX package's exporter does
    (the same glTF, buffers and textures), loads it, and loadtest walks it."""
    from pim_tpu.geom.maps import export_map as jexport

    cv.cv_basedir.set(str(tmp_path / "base"))
    q = get_cmd_system()
    assert q.immediate("mapgen tiny -rooms 1x1 -steps 6") == CmdStat.OK
    assert rs.entities.count > 10
    jdir = jexport("tiny", base_dir=str(tmp_path / "jbase"), rooms=(1, 1), seed=1,
                   sphere_steps=6)
    pdir = tmp_path / "base" / "tiny" / "glTF"
    jfiles = sorted(os.listdir(os.path.dirname(jdir)))
    assert sorted(os.listdir(pdir)) == jfiles
    for f in jfiles:
        assert (pdir / f).read_bytes() == open(os.path.join(os.path.dirname(jdir), f),
                                               "rb").read(), f
    assert q.immediate("loadtest") == CmdStat.OK
    assert rs.entities.names[0].startswith("tiny")  # the session's scene is back


def test_cvar_bounce_change_rebuilds_step(rs):
    _frames(rs, 1)
    step_before = rs._step
    cv.cv_pt_max_bounces.set(1)
    _frames(rs, 1)
    assert rs._step is not step_before and rs.sample_count == 1


def test_cvar_resolution_change_applies(rs):
    _frames(rs, 1)
    cv.cv_r_width.set(8)
    cv.cv_r_height.set(8)
    cv.cv_r_scale.set(1.0)
    _frames(rs, 1)
    assert (rs.width, rs.height) == (8, 8) and rs.buffers.color.shape[0] == 64


def test_cvar_media_rebuilds_the_scene(rs):
    _frames(rs, 1)
    assert not rs.meta.media_enabled
    arrays_before = rs.arrays
    cv.cv_pt_media.set(True)
    _frames(rs, 1)
    assert rs.meta.media_enabled and rs.arrays is not arrays_before and rs.sample_count == 1
    assert np.isfinite(rs.buffers.color.numpy()).all()
    cv.cv_pt_media.set(False)
    _frames(rs, 1)
    assert not rs.meta.media_enabled


def test_cvar_seed_restarts_the_accumulation(rs):
    _frames(rs, 2)
    cv.cv_pt_seed.set(1234)
    _frames(rs, 1)
    assert rs.sample_count == 1


def test_pt_gate(rs):
    _frames(rs, 2)
    q = get_cmd_system()
    assert q.immediate("pt_gate -maxstddev 1e9 -meanlo 0 -meanhi 1e9") == CmdStat.OK
    assert q.immediate("pt_gate -maxstddev 1e-9") == CmdStat.ERR
    assert q.immediate("pt_gate -meanlo 1e8 -meanhi 1e9") == CmdStat.ERR
    assert q.immediate("pt_gate -scene no_such_scene") == CmdStat.ERR  # no band: a failure
    before = q.error_count
    q.enqueue("pt_gate -maxstddev 1e-9")
    q.update()
    assert q.error_count == before + 1


def test_pt_gate_reads_the_ports_bands(rs):
    """The port's pt_gate judges by pim_tpu_torch/render/pt_gate_bands.json:
    an image whose mean lies inside the JAX package's (TPU-seeded) e1m1
    16-sample band but outside the port's fails."""
    assert os.path.dirname(render_system.BANDS_PATH) == os.path.join(ROOT, "pim_tpu_torch",
                                                                     "render")
    port_band = render_system.load_gate_band(16, "e1m1")
    jax_band = jrs._load_gate_band(16, "e1m1")
    assert port_band is not None and port_band != jax_band
    mean = 0.5 * (jax_band[1] + port_band[1])  # inside the JAX band, below the port's
    assert jax_band[1] <= mean < port_band[1]
    _frames(rs, 1)
    rs.sample_count = 16
    rs.buffers = rs.buffers._replace(color=torch.full_like(rs.buffers.color, mean))
    assert get_cmd_system().immediate("pt_gate -scene e1m1") == CmdStat.ERR
    rs.buffers = rs.buffers._replace(color=torch.full_like(rs.buffers.color, port_band[1] + 0.1))
    assert get_cmd_system().immediate("pt_gate -scene e1m1") == CmdStat.OK


def test_port_bands_are_cpu_derived_and_pool_their_runs():
    with open(render_system.BANDS_PATH) as f:
        data = json.load(f)
    for scene, rec in data["calibrations"].items():
        assert rec["device"] == "cpu" and rec["package"] == "pim_tpu" and len(rec["seeds"]) == 3
        for tier, runs in rec["runs"].items():
            want = calibrate_pt_gate.pool_band(scene, int(tier), runs)
            got = [e for e in data["entries"]
                   if e["scene"] == scene and e["min_samples"] == int(tier)]
            assert got == [want]
    tiers = {(e["scene"], e["min_samples"]) for e in data["entries"]}
    assert {("e1m1", 8), ("e1m1", 16), ("cornell", 8), ("cornell", 16),
            ("cornell", 64)} <= tiers


def test_pt_spp_batching_matches_sequential(rs):
    _frames(rs, 4)
    seq = rs.buffers.color.numpy().copy()
    cv.cv_pt_spp.set(2)
    fresh = RenderSystem(width=W, height=H, device="cpu")
    fresh.init()
    fresh.entities, fresh.pool = rs.entities, rs.pool
    fresh.camera.position = np.asarray(rs.camera.position).copy()
    fresh.camera.rotation = np.asarray(rs.camera.rotation).copy()
    fresh.dof.autofocus = False
    _frames(fresh, 2)
    assert fresh.sample_count == 4
    np.testing.assert_allclose(fresh.buffers.color.numpy(), seq, rtol=2e-5, atol=2e-6)


# ---------------------------------------------------------------------------
# the bakes: lm_gen, r_refl_gen, probe_bake / probe_report
# ---------------------------------------------------------------------------

LM_DENSITY = 1.0  # a 64^2 atlas of 1,858 live texels
PROBE_RES = 8     # the reflection probe registered before the first frame
PROBE_RAYS = 256
PROBE_CMD = f"probe_bake -samples {PROBE_RAYS} -at 0 -1 0.5"
_JSAVED = ("cv_pt_max_bounces", "cv_pt_trace", "cv_exp_manual", "cv_lm_gen", "cv_r_refl_gen",
           "cv_lm_density")


@pytest.fixture()
def bakes(rs):
    """The bake cvars on in both packages (lm_gen, r_refl_gen, a 1 texel/m
    lightmap), each package's probe registry emptied (a module global) and
    given an 8^2 "default" probe; all restored afterwards."""
    from pim_tpu.render import cubemap as jcubemap
    from pim_tpu_torch.render import cubemap

    saved = [(getattr(jcv, n), getattr(jcv, n).get()) for n in _JSAVED]
    cubemap._registry = jcubemap._registry = None
    for c in (cv, jcv):
        c.cv_lm_gen.set(True)
        c.cv_r_refl_gen.set(True)
        c.cv_lm_density.set(LM_DENSITY)
    cubemap.get_registry().add("default", PROBE_RES, device="cpu")
    jcubemap.get_registry().add("default", PROBE_RES)
    yield cubemap.get_registry(), jcubemap.get_registry()
    cubemap._registry = jcubemap._registry = None
    for c, v in saved:
        c.set(v)


def _rule(got, want, mean_rel=0.02):
    """test_torch_frame.py's rule: 97% of values within rtol 1e-4 / atol
    1e-5, the means within 2%."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).mean()
    assert close >= 0.97, close
    assert abs(got.mean() - want.mean()) <= mean_rel * abs(want.mean())


def _probe_close(got, want):
    """A light probe against the reference's: 256 rays, of which a few may
    diverge after an ulp-level flip, so within 2% of the largest value."""
    assert int(got.sample_count) == int(want.sample_count)
    for f in ("faces", "sh"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert np.abs(g - w).max() <= 0.02 * np.abs(w).max(), f


def _jax_bake_rs(tmp_path):
    from pim_tpu.core.cmd import get_cmd_system as jcmds

    jsys = _jax_rs(tmp_path)
    jsys.init()
    return jsys, jcmds()


def test_bakes_match_the_reference_shell(rs, bakes, tmp_path):
    """lm_gen 1 and r_refl_gen 1 over 2 frames, then probe_bake and
    probe_report, in the port's shell and in pim_tpu's on Cornell."""
    reg, jreg = bakes
    jsys, jcmds = _jax_bake_rs(tmp_path)
    for _ in range(2):
        jsys.update()
        rs.update()
    assert jcmds.immediate(PROBE_CMD) == CmdStat.OK
    assert get_cmd_system().immediate(PROBE_CMD) == CmdStat.OK
    assert get_cmd_system().immediate("probe_report") == CmdStat.OK
    from pim_tpu_torch.core.console import get_console

    lines = [m for _, tag, m in get_console().lines() if tag == "probe"]
    assert sum(m.startswith("camera ") and "cube(" in m for m in lines[-6:]) == 6
    assert get_cmd_system().immediate("probe_report nowhere") == CmdStat.ERR

    pack, jpack = rs.lm_pack, jsys.lm_pack
    assert rs._lm_frame == jsys._lm_frame == 2 and pack.size == jpack.size == 64
    np.testing.assert_array_equal(pack.sample_counts.numpy(), np.asarray(jpack.sample_counts))
    live = pack.sample_counts.numpy() > 0
    assert int(live.sum()) == 1858 and (pack.sample_counts.numpy()[live] == 3).all()
    _rule(pack.probes.numpy()[live], np.asarray(jpack.probes)[live])

    cm, jcm = reg.find("default"), jreg.find("default")
    assert reg._samples["default"] == jreg._samples["default"] == 2
    _rule(cm.color.numpy(), jcm.color)
    for got, want in zip(cm.mips, jcm.mips):
        _rule(got.numpy(), want)

    _probe_close(rs.probes["camera"], jsys.probes["camera"])
    np.testing.assert_array_equal(rs.probes["camera"].origin.numpy(), [0.0, -1.0, 0.5])


def test_bake_checkpoint_resumes_bit_for_bit(rs, bakes):
    """ckpt_save after 2 frames with the bakes on and a light probe, then 2
    more frames and a probe pass, against a fresh render system resumed
    from the crate: the frame, the lightmap, its bake frame and the light
    probe bit for bit (the reflection probes are not in a crate, as in the
    reference)."""
    _frames(rs, 2)
    assert get_cmd_system().immediate(PROBE_CMD) == CmdStat.OK
    rs.checkpoint_save("maps/b.ckpt.crate")
    _frames(rs, 2)
    assert get_cmd_system().immediate(PROBE_CMD) == CmdStat.OK

    fresh = RenderSystem(width=4, height=4, device="cpu")
    fresh.init()
    fresh.checkpoint_load("maps/b.ckpt.crate")
    assert fresh._lm_frame == 2 and int(fresh.probes["camera"].sample_count) == 1
    _frames(fresh, 2)
    assert get_cmd_system().immediate(PROBE_CMD) == CmdStat.OK
    assert fresh._lm_frame == rs._lm_frame == 4
    assert torch.equal(fresh.buffers.color, rs.buffers.color)
    for f in ("probes", "sample_counts", "position", "normal", "axii"):
        assert torch.equal(getattr(fresh.lm_pack, f), getattr(rs.lm_pack, f)), f
    for f in rs.probes["camera"]._fields:
        assert torch.equal(getattr(fresh.probes["camera"], f), getattr(rs.probes["camera"], f))


def test_reference_bake_crate_resumes_in_the_port(rs, bakes, tmp_path):
    """A crate that pim_tpu's checkpoint_save wrote with a lightmap and a
    light probe (its lmpack entry has no axii) resumes in the port with the
    reference's state bit for bit, and both continue alike.  pim_tpu itself
    cannot load such a crate, from either package (ROADMAP F11)."""
    jsys, jcmds = _jax_bake_rs(tmp_path)
    for _ in range(2):
        jsys.update()
    assert jcmds.immediate(PROBE_CMD) == CmdStat.OK
    jsys.checkpoint_save(str(tmp_path / "j.ckpt.crate"))
    assert "axii" not in Crate.load(str(tmp_path / "j.ckpt.crate")).get("lmpack")

    rs.checkpoint_load(str(tmp_path / "j.ckpt.crate"))
    assert rs._lm_frame == 2
    for f in ("position", "normal", "probes", "sample_counts"):
        np.testing.assert_array_equal(getattr(rs.lm_pack, f).numpy(),
                                      np.asarray(getattr(jsys.lm_pack, f)), err_msg=f)
    np.testing.assert_array_equal(rs.lm_pack.axii.numpy(), np.asarray(jsys.lm_pack.axii))
    for f in ("origin", "faces", "sh", "sample_count"):
        np.testing.assert_array_equal(getattr(rs.probes["camera"], f).numpy(),
                                      np.asarray(getattr(jsys.probes["camera"], f)))
    for _ in range(2):
        jsys.update()
    _frames(rs, 2)
    np.testing.assert_array_equal(rs.lm_pack.sample_counts.numpy(),
                                  np.asarray(jsys.lm_pack.sample_counts))
    live = rs.lm_pack.sample_counts.numpy() > 0
    _rule(rs.lm_pack.probes.numpy()[live], np.asarray(jsys.lm_pack.probes)[live])
    _frame_close(rs.buffers.color.numpy(), np.asarray(jsys.buffers.color))

    rs.checkpoint_save(str(tmp_path / "t.ckpt.crate"))
    assert "axii" in Crate.load(str(tmp_path / "t.ckpt.crate")).get("lmpack")
    for path in ("j.ckpt.crate", "t.ckpt.crate"):
        with pytest.raises(TypeError, match="axii"):
            jrs.RenderSystem().checkpoint_load(str(tmp_path / path))


def test_pt_debug_raises_on_a_poisoned_frame(rs):
    _frames(rs, 1)
    cfg = render_system.FrameConfig(rs.meta, W, H, BOUNCES, 5, 0.3, 3.0, debug=True)
    bad = rs.buffers._replace(color=torch.full_like(rs.buffers.color, float("nan")))
    cam = camera.camera_arrays(rs.camera, rs.dof, W, H)
    with pytest.raises(FloatingPointError, match="pt_debug: non-finite radiance"):
        render_system.frame_step(cfg, rs.arrays, rs.lights, bad, rs.exp_state,
                                 exposure.ExposureParams.from_cvars(), cam, 1, 0.5, DT, False, 1)


def test_engine_exit_code_follows_failed_commands(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    saved = [(c, c.get()) for c in _SAVED]
    try:
        eng = app.Engine(width=8, height=8, device="cpu")
        eng.init()
        assert eng.run("cornell_box; pt_max_bounces 2; pt_trace 1; wait 2; "
                       "pt_gate -maxstddev 0; quit") == 1
        eng = app.Engine(width=8, height=8, device="cpu")
        eng.init()
        assert eng.run("cornell_box; pt_max_bounces 2; pt_trace 1; wait 2; "
                       "pt_gate -maxstddev 1e9; quit") == 0
        # the frame that runs `quit` still renders: 3 frames
        assert eng.render.sample_count == 3
    finally:
        for c, v in saved:
            c.set(v)


def _cli_pt_test_pngs(tmp_path, monkeypatch, frames: int) -> list:
    monkeypatch.chdir(tmp_path)
    saved = [(c, c.get()) for c in _SAVED]
    try:
        with pytest.raises(SystemExit) as ex:
            app.main(["--device", "cpu", "--width", "16", "--height", "16", "--exec",
                      f"pt_test -frames {frames} -nogate"])
        assert ex.value.code == 0
    finally:
        for c, v in saved:
            c.set(v)
    return sorted(os.listdir(tmp_path / "screenshots"))


def test_cli_pt_test_writes_two_pngs(tmp_path, monkeypatch):
    """pt_test's two screenshots, the denoised and the raw one, beside
    pt_stddev's image."""
    pngs = _cli_pt_test_pngs(tmp_path, monkeypatch, 8)
    assert len(pngs) == 3 and sum(p.startswith("pt_stddev_") for p in pngs) == 1
    for p in pngs:
        img = screenshot.read_png(str(tmp_path / "screenshots" / p))
        assert img.shape == (16, 16, 3) and img.max() > 0


@pytest.mark.parametrize("same_second", [True, False])
def test_pt_test_screenshots_do_not_depend_on_the_clock(tmp_path, monkeypatch, same_second):
    """The denoised and raw screenshots are both kept whether or not a
    second passes between them (unnamed screenshots are named by the
    second; a second one in the same second gets a suffix)."""
    ticks = iter(range(1000))
    strftime = render_system.time.strftime

    def clock(fmt, *args):
        if fmt != "%Y_%m_%d_%H_%M_%S":  # the console's stamps
            return strftime(fmt, *args)
        return "2026_01_01_00_00_" + ("00" if same_second else f"{next(ticks):02d}")

    monkeypatch.setattr(render_system.time, "strftime", clock)
    pngs = _cli_pt_test_pngs(tmp_path, monkeypatch, 2)
    stamps = [p for p in pngs if not p.startswith("pt_stddev_")]
    want = (["2026_01_01_00_00_00.png", "2026_01_01_00_00_00_1.png"] if same_second
            else ["2026_01_01_00_00_00.png", "2026_01_01_00_00_01.png"])
    assert stamps == want and len(pngs) == 3


def test_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["--exec", "quit"], ["--scene", "cornell"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            app.main(["--device", "cuda", *argv])


@pytest.mark.slow
def test_rederive_the_cornell_8_sample_tier():
    """pim_tpu renders the 128^2 runs of the committed Cornell tiers again,
    seed after seed in one render system as the tool does (the light pdf
    keeps learning across seeds, so every tier's frames are rendered); the
    8-sample tier's runs match their recorded stddev and mean."""
    with open(render_system.BANDS_PATH) as f:
        data = json.load(f)
    rec = data["calibrations"]["cornell"]
    seeds = [int(s, 16) for s in rec["seeds"]]
    tiers = sorted(int(t) for t in rec["runs"])
    _, record = calibrate_pt_gate.calibrate("cornell", [128], tiers, seeds)
    want = {(r["res"], r["seed"]): r for r in rec["runs"]["8"]}
    for r in record["runs"]["8"]:
        w = want[(r["res"], r["seed"])]
        np.testing.assert_allclose([r["stddev"], r["mean"]], [w["stddev"], w["mean"]],
                                   rtol=1e-4)
