"""The participating medium on the port's normal path, on the CPU: a
scene carries its medium from `build_scene` through
`render_system.trace_samples` to the integrator (the defaults where none
is given); the port's plain marches against the benchmark's frozen
reference (`pimbench/reference/render_media.py`) on the Cornell box at
16^2, 3 bounces, through seeded random media; CPU words taking the plain
form; and the operation counts of the media kernels' bound
(`pimbench/metrics/media_roofline.py`, `tools/media_check.py`) against a
dispatch count of the plain form."""

import contextlib
import dataclasses
import json
import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pim_tpu_torch import native
from pim_tpu_torch.core import profiler, rng
from pim_tpu_torch.math import noise
from pim_tpu_torch.render import integrator, media, render_system
from pim_tpu_torch.render.camera import generate_primary_rays
from pim_tpu_torch.tools import media_check as mc
from pimbench import scenes
from pimbench.metrics import media_roofline
from pimbench.reference import render_media as RM

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED32 = 0x5EED1234
RANDOM_MEDIA = (11, 12, 13)


def _cfg(size: int, bounces: int) -> dict:
    with open(os.path.join(REPO, "pimbench", "configs", "cornell-media.json")) as f:
        cfg = json.load(f)
    cfg.update(width=size, height=size, bounces=bounces)
    return cfg


@pytest.fixture(scope="module")
def small():
    cfg = _cfg(8, 2)
    return cfg, scenes.build(cfg, "cpu", "program", media_enabled=True), scenes.camera(
        cfg, "program")


def _trace_rays(scene, cam, cfg, desc, sample):
    """trace_rays through `desc`, on the rays trace_samples makes."""
    meta, arrays, lights = scene
    w = h = cfg["width"]
    state = rng.make_state(torch.arange(w * h), sample, seed=SEED32)
    state, ro, rd = generate_primary_rays(cam, w, h, state)
    return integrator.trace_rays(meta, arrays, lights, ro, rd, state, cfg["bounces"],
                                 media_desc=desc)


def _samples(scene, cam, cfg, sample):
    return render_system.trace_samples(scene, cam, cfg["width"], cfg["height"], cfg["bounces"],
                                       1, sample, seed=SEED32)


def test_trace_samples_renders_the_scenes_medium(small):
    cfg, (meta, arrays, lights), cam = small
    desc = media.make_media_desc(**cfg["media"])
    scene = (dataclasses.replace(meta, media=desc), arrays, lights)
    got = _samples(scene, cam, cfg, 3)
    want = _trace_rays(scene, cam, cfg, desc, 3)
    assert torch.equal(got.color, want.color) and torch.equal(got.normal, want.normal)
    vacuum = _samples((dataclasses.replace(meta, media_enabled=False), arrays, lights), cam,
                      cfg, 3)
    assert not torch.equal(got.color, vacuum.color)


def test_trace_samples_takes_the_default_medium_when_none_is_given(small):
    cfg, scene, cam = small
    assert scene[0].media_enabled and scene[0].media is None
    got = _samples(scene, cam, cfg, 4)
    want = _trace_rays(scene, cam, cfg, media.make_media_desc(), 4)
    assert torch.equal(got.color, want.color)
    dense = _trace_rays(scene, cam, cfg, media.make_media_desc(**cfg["media"]), 4)
    assert not torch.equal(got.color, dense.color)


def test_build_scene_carries_the_medium():
    from pim_tpu_torch.geom.cornell import build_cornell_box
    from pim_tpu_torch.render.scene import build_scene

    desc = media.make_media_desc(**mc.CELL)
    meta, _, _ = build_scene(*build_cornell_box("boxes"), "cpu", media_enabled=True, media=desc)
    assert meta.media_enabled and meta.media == desc


@pytest.fixture(scope="module")
def frames():
    cfg = _cfg(16, 3)
    return (cfg, scenes.build(cfg, "cpu", "program", media_enabled=True),
            scenes.camera(cfg, "program"), RM.build(cfg, "cpu"), scenes.camera(cfg, "reference"))


@pytest.mark.parametrize("medium_seed", RANDOM_MEDIA)
def test_plain_form_matches_the_frozen_reference(frames, medium_seed):
    cfg, (meta, arrays, lights), cam, ref_scene, ref_cam = frames
    kw = mc.random_medium(medium_seed)
    cfg = dict(cfg, media=kw)
    scene = (dataclasses.replace(meta, media=media.make_media_desc(**kw)), arrays, lights)
    before = dict(native.launches)
    got = _samples(scene, cam, cfg, 5)
    assert native.launches == before
    pix = torch.arange(cfg["width"] * cfg["height"])
    want = RM.trace_pixels(ref_scene, ref_cam, cfg, RM.medium(cfg), 1, 5, SEED32, pix)
    got = torch.cat([got.color, got.albedo, got.normal], dim=1)
    assert torch.equal(got, want), float((got - want).abs().max())
    assert float(got[:, :3].mean()) > 0


def _traced(fn):
    """fn()'s result and the profiler's counters while it ran traced."""
    profiler.reset_counters()
    profiler.set_tracing(True)
    try:
        out = fn()
        return out, profiler.counters()
    finally:
        profiler.set_tracing(False)
        profiler.reset_counters()


def test_cpu_words_take_the_plain_form_and_count_calls():
    ro, rd, length, state = mc.random_lanes(64, 7)
    desc = media.make_media_desc(**mc.CELL)
    before = dict(native.launches)

    def both():
        s1, m = media.march(desc, state, ro, rd, length)
        return s1, m, media.calc_transmittance(desc, s1, ro, rd, length)

    (s1, m, _), counts = _traced(both)
    assert native.launches == before
    assert counts["media.calls"] == 2 and counts["media.kernel"] == 0
    assert counts["media.march_lanes"] == counts["media.tr_lanes"] == 64
    assert counts["media.lanes"] == counts["media.tr_live"] == 64
    assert counts["media.scattered"] == int(m.scattered.sum())
    for k in ("march", "tr"):
        assert 0 < counts[f"media.{k}_band"] < counts[f"media.{k}_steps"] < 32 * 64
    ps, pm = media.march_plain(desc, state, ro, rd, length)
    assert all(torch.equal(a, b) for a, b in zip(s1, ps))
    assert torch.equal(m.scattered, pm.scattered) and 0 < int(m.scattered.sum()) < 64


def test_recording_keeps_the_kernels_calls_and_their_tally(monkeypatch):
    """media_check.recording (chip_smoke's main-path check) wraps the
    kernel entry points as `march` calls them, tally included: here a
    stand-in computes ME1 with the plain form on the CPU."""
    def scatter(desc, fields, tally=None):
        ro, rd, ray_len, state = mc._split(fields)
        if tally is not None:
            tally.zero_()   # the kernel overwrites its tally; the plain form adds
        state, m = media.march_plain(desc, state, ro, rd, ray_len, tally)
        out = torch.stack([*m.atten, *m.pos, *m.dir, *m.attenuation, m.pdf])
        return out, m.scattered, torch.stack(list(state))

    monkeypatch.setattr(media, "media_scatter", scatter)
    monkeypatch.setattr(media, "takes_kernels", lambda fields: True)
    ro, rd, length, state = mc.random_lanes(16, 12)
    desc = media.make_media_desc(**mc.CELL)
    with mc.recording(1) as calls:
        (_, m), counts = _traced(lambda: media.march(desc, state, ro, rd, length))
    assert len(calls["scatter"]) == 1 and counts["media.kernel"] == 1
    assert torch.equal(calls["scatter"][0][1][2], length)
    assert counts["media.march_steps"] > 0
    assert torch.equal(m.scattered, media.march_plain(desc, state, ro, rd, length)[1].scattered)


def test_the_counters_count_the_lanes_whose_result_is_used():
    ro, rd, length, state = mc.random_lanes(64, 9)
    desc = media.make_media_desc(**mc.CELL)
    used = torch.arange(64) % 3 == 0
    (_, m), counts = _traced(lambda: media.march(desc, state, ro, rd, length, active=used))
    _, tr_counts = _traced(lambda: media.calc_transmittance(desc, state, ro, rd, length,
                                                            active=used))
    counts.update(tr_counts)
    for k, plain in (("march", media.march_plain), ("tr", media.calc_transmittance_plain)):
        tally = torch.zeros((2, 64), dtype=torch.int32)
        plain(desc, state, ro, rd, length, tally)
        assert counts[f"media.{k}_lanes"] == 64
        assert counts[f"media.{k}_steps"] == int(tally[0][used].sum())
        assert counts[f"media.{k}_band"] == int(tally[1][used].sum())
    assert counts["media.lanes"] == counts["media.tr_live"] == int(used.sum())
    assert counts["media.scattered"] == int((m.scattered & used).sum())


@pytest.mark.parametrize("band", ["everywhere", "nowhere"])
def test_the_tally_counts_the_steps_in_the_band(band):
    ro, rd, length, state = mc.random_lanes(64, 10)
    # a band 3 km about y = 0 holds every point of the lanes' marches (32
    # free paths of at most 54 m); one at y = 1e4 none
    kw = dict(noise_scale=2000.0) if band == "everywhere" else dict(noise_height=1e4)
    desc = media.make_media_desc(**dict(mc.CELL, **kw))
    for plain in (media.march_plain, media.calc_transmittance_plain):
        tally = torch.zeros((2, 64), dtype=torch.int32)
        plain(desc, state, ro, rd, length, tally)
        assert int(tally[0].sum()) > 0
        want = tally[0] if band == "everywhere" else torch.zeros_like(tally[0])
        assert torch.equal(tally[1], want)


class _Ops(TorchDispatchMode):
    """Counts the ops whose result has n elements (one operation a lane),
    by category: "band" inside `media.band_density`, "phase" from
    `sample_phase_dir` on, "lane" before the first RNG draw and inside
    every draw, "step" the rest."""

    def __init__(self, n):
        super().__init__()
        self.n = n
        self.cat = "lane"
        self.count = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.numel() == self.n:
            self.count[self.cat] = self.count.get(self.cat, 0) + 1
        return out

    def within(self, cat, fn, stays=False):
        def wrapped(*a, **k):
            prev, self.cat = self.cat, cat
            try:
                return fn(*a, **k)
            finally:
                if not stays:
                    self.cat = "step" if prev == cat == "lane" else prev
        return wrapped


@contextlib.contextmanager
def _categorised(ops):
    """mul32 and add32 as the one 32-bit operation each stands for, and
    the plain form's parts in `ops`' categories."""
    saved = (rng.mul32, rng.add32, noise.mul32, noise.add32, rng.next_f32, rng.next_f32x2,
             media.band_density, media.sample_phase_dir)
    rng.mul32 = noise.mul32 = lambda a, b: a * b
    rng.add32 = noise.add32 = lambda a, b: a + b
    rng.next_f32, rng.next_f32x2 = ops.within("lane", saved[4]), ops.within("lane", saved[5])
    media.band_density = ops.within("band", saved[6])
    media.sample_phase_dir = ops.within("phase", saved[7], stays=True)
    try:
        yield
    finally:
        (rng.mul32, rng.add32, noise.mul32, noise.add32, rng.next_f32, rng.next_f32x2,
         media.band_density, media.sample_phase_dir) = saved


@pytest.mark.parametrize("kernel", ["scatter", "tr"])
@pytest.mark.parametrize("octaves", [1, 3])
def test_the_bounds_operation_count_is_the_plain_forms(kernel, octaves):
    """Every lane live at every step, in the band, and scattered: the
    bound's operations are then the plain form's, category by category."""
    n, steps = 5, media.MEDIA_STEPS
    ro, rd, length, state = mc.random_lanes(n, 8)
    desc = media.make_media_desc(**dict(mc.CELL, noise_octaves=octaves))
    fn = media.march_plain if kernel == "scatter" else media.calc_transmittance_plain
    ops = _Ops(n)
    with _categorised(ops), ops:
        fn(desc, state, ro, rd, length)
    o = media_roofline.OPS[kernel]
    assert ops.count == {"lane": o["lane"], "step": steps * o["step"],
                         "band": steps * (o["band"] + octaves * o["octave"]),
                         **({"phase": o["phase"]} if kernel == "scatter" else {})}
    scattered = n if kernel == "scatter" else 0
    assert media_roofline.work(kernel, n, n * steps, n * steps, octaves, scattered)[1] == n * sum(
        ops.count.values())
    assert mc.OPS == media_roofline.OPS and mc.LANE_BYTES == media_roofline.LANE_BYTES
    assert mc.work(kernel, 3, 7, 2, octaves, 1) == media_roofline.work(kernel, 3, 7, 2, octaves, 1)
