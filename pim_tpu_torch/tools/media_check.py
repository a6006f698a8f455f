"""What the media kernels (csrc/media.cu) are checked on and held against,
shared by chip_smoke.py and the tests.

- Media: `DENSE` (the room-scale haze of tests/test_media.py and the
  shell's media frames), `CELL` (the benchmark's cornell-media medium: that
  haze and an fBm fog band over y in [-4, -1]) and `random_medium`, every
  field of `make_media_desc` drawn from a seed within RANGES.
- Lanes: `random_lanes` (seeded origins in a 10 m room, unit directions,
  segment lengths from a few cm to 30 m and a seventh of them the 1e6 of a
  ray that left the scene, and RNG words from `make_state`);
  `main_path_calls`, the lanes the kernels get in one render step
  (`render_system.trace_samples`), kept by wrapping the kernels' wrappers.
- References: `scatter_differences` (`media.march`) and
  `transmittance_differences` run the dispatching functions and the plain
  forms on the same lanes and count, per output, the lanes whose bits
  differ (`bsdf_check.differing`); `tally_differences` likewise the
  kernels' tallies (live steps, steps in the band) on CUDA lanes.
- `step_launches`: the device ops one render step dispatches (aten ops on
  the scene's device, views left out, plus the port's kernels), with the
  media kernels or with the plain form forced, counted without a profiler.
- `work` and `call_work`: each kernel's bytes (a live lane's inputs read
  once, its outputs written once) and operations (the plain form's
  elementwise ops that the lanes' result needs, each 32-bit product or sum
  once; tests/test_torch_media_system.py holds them to a dispatch count),
  from counts of live lanes, live steps, steps in the noise band and lanes
  that scattered; `call_work` takes them from a kernel call's tally.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from pim_tpu_torch.core import rng
from pim_tpu_torch.math.vec3 import V3
from pim_tpu_torch.render import media
from pim_tpu_torch.tools.bsdf_check import differing

DENSE = dict(constant_mfp=15.0, noise_mfp=1e9, absorption=0.2)
CELL = dict(constant_mfp=15.0, noise_mfp=15.0, absorption=0.2, noise_height=-2.5)
# (low, high) of each field random_medium draws; colours per channel
RANGES = dict(constant_color=(0.0, 1.0), noise_color=(0.0, 1.0), constant_mfp=(2.0, 100.0),
              noise_mfp=(1.0, 100.0), absorption=(0.0, 1.0), noise_octaves=(1, 4),
              noise_gain=(0.3, 0.95), noise_lacunarity=(1.5, 2.5), noise_freq=(0.25, 2.0),
              noise_scale=(0.25, 2.0), noise_height=(-4.5, 4.5), phase_dir_a=(-0.9, 0.9),
              phase_dir_b=(-0.9, 0.9), phase_blend=(0.0, 1.0))
ROOM = 5.0          # the Cornell box's half extent (m)
MISSED = 1.0e6      # a segment that left the scene (integrator: RCP_EPS)


def random_medium(seed: int) -> dict:
    """make_media_desc's keyword arguments, each drawn within RANGES."""
    r = np.random.default_rng(seed)
    kw = {}
    for k, (lo, hi) in RANGES.items():
        if k.endswith("_color"):
            kw[k] = tuple(float(v) for v in r.uniform(lo, hi, 3))
        elif isinstance(lo, int):
            kw[k] = int(r.integers(lo, hi + 1))
        else:
            kw[k] = float(r.uniform(lo, hi))
    return kw


def random_lanes(n: int, seed: int, device="cpu"):
    """(ro V3, rd V3, ray_len [N], state) of n seeded lanes."""
    r = np.random.default_rng(seed)
    ro = r.uniform(-ROOM, ROOM, (3, n)).astype(np.float32)
    d = r.normal(size=(3, n))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    length = np.exp(r.uniform(np.log(0.05), np.log(30.0), n)).astype(np.float32)
    length[r.random(n) < 1.0 / 7.0] = MISSED

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    state = rng.make_state(torch.arange(n, device=device), int(r.integers(0, 2**31)),
                           seed=int(r.integers(0, 2**32)))
    return V3(*map(t, ro)), V3(*map(t, d)), t(length), state


def _split(fields):
    """(ro V3, rd V3, ray_len, state) of a kernel call's LANE_FIELDS."""
    return V3(*fields[0:3]), V3(*fields[3:6]), fields[6], rng.RngState(*fields[7:11])


@contextlib.contextmanager
def recording(keep: int):
    """Yields {"scatter": [...], "tr": [...]}, filled while the block runs
    with (desc, (ro, rd, ray_len, state)) copies of the first `keep` calls
    of each media kernel."""
    calls = {"scatter": [], "tr": []}
    saved = media.media_scatter, media.media_transmittance

    def wrap(kind, fn):
        def wrapper(desc, fields, tally=None):
            if len(calls[kind]) < keep:
                calls[kind].append((desc, _split([t.clone() for t in fields])))
            return fn(desc, fields, tally)
        return wrapper

    media.media_scatter = wrap("scatter", saved[0])
    media.media_transmittance = wrap("tr", saved[1])
    try:
        yield calls
    finally:
        media.media_scatter, media.media_transmittance = saved


def main_path_calls(scene, cam, width: int, height: int, bounces: int, keep: int = 3):
    """The first `keep` calls of each media kernel in one 1-spp render step
    of `scene` (whose meta carries the medium): {"scatter": [(desc, lanes)],
    "tr": [...]}."""
    from pim_tpu_torch.render.render_system import trace_samples

    with recording(keep) as calls:
        trace_samples(scene, cam, width, height, bounces, 1, 0)
    return calls


# aten ops that launch nothing on the device
_NO_LAUNCH = ("view", "_unsafe_view", "alias", "as_strided", "expand", "reshape", "select",
              "slice", "squeeze", "unsqueeze", "permute", "t", "transpose", "unbind", "detach",
              "lift_fresh", "_local_scalar_dense", "split", "chunk")


def step_launches(scene, cam, width: int, height: int, bounces: int, plain: bool) -> dict:
    """{"aten": ops dispatched on the scene's device, "port": the port's
    kernel launches} of one 1-spp render step; with `plain` the media
    marches take the plain form on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from pim_tpu_torch import native
    from pim_tpu_torch.render.render_system import trace_samples

    dev = scene[1].tri_table.device

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if (func.overloadpacket.__name__ not in _NO_LAUNCH
                    and any(isinstance(o, torch.Tensor) and o.device == dev for o in outs)):
                Ops.n += 1
            return out

    saved = media.takes_kernels
    if plain:
        media.takes_kernels = lambda fields: False
    before = sum(native.launches.values())
    try:
        with Ops():
            trace_samples(scene, cam, width, height, bounces, 1, 0)
    finally:
        media.takes_kernels = saved
    return {"aten": Ops.n, "port": sum(native.launches.values()) - before}


MARCH_OUTPUTS = ("state.x", "state.y", "state.z", "state.w",
                 *(f"{f}.{c}" for f in ("atten", "pos", "dir", "attenuation") for c in "xyz"),
                 "pdf", "scattered")


def _march_outputs(result) -> list:
    state, m = result
    return [*state, *m.atten, *m.pos, *m.dir, *m.attenuation, m.pdf, m.scattered]


def scatter_differences(desc, ro: V3, rd: V3, ray_len, state) -> dict:
    """`media.march` (the kernel on CUDA) against `march_plain` on the same
    lanes: per output the lanes whose bits differ."""
    got = _march_outputs(media.march(desc, state, ro, rd, ray_len))
    want = _march_outputs(media.march_plain(desc, state, ro, rd, ray_len))
    return dict(zip(MARCH_OUTPUTS, differing(got, want)))


def transmittance_differences(desc, ro: V3, rd: V3, ray_len, state) -> dict:
    """`calc_transmittance` (the kernel on CUDA) against
    `calc_transmittance_plain`: per output the lanes whose bits differ."""
    s_k, tr_k = media.calc_transmittance(desc, state, ro, rd, ray_len)
    s_p, tr_p = media.calc_transmittance_plain(desc, state, ro, rd, ray_len)
    names = ["state.x", "state.y", "state.z", "state.w", "tr.x", "tr.y", "tr.z"]
    return dict(zip(names, differing([*s_k, *tr_k], [*s_p, *tr_p])))


def tally_differences(kernel: str, desc, ro: V3, rd: V3, ray_len, state) -> dict:
    """A kernel call's tally ("scatter" ME1, "tr" ME2; CUDA lanes) against
    the plain form's on the same lanes: per row (live steps, steps in the
    band) the lanes whose counts differ."""
    plain = torch.zeros((2, ray_len.shape[0]), dtype=torch.int32, device=ray_len.device)
    got = torch.empty_like(plain)
    fields = [t.contiguous() for t in media.lane_fields(ro, rd, ray_len, state)]
    if kernel == "scatter":
        media.march_plain(desc, state, ro, rd, ray_len, plain)
        media.media_scatter(desc, fields, got)
    else:
        media.calc_transmittance_plain(desc, state, ro, rd, ray_len, plain)
        media.media_transmittance(desc, fields, got)
    return dict(zip(("tally.steps", "tally.band"), differing(list(got), list(plain))))


# The bound's arithmetic, pimbench/metrics/media_roofline.py's (the port
# imports nothing of pimbench; tests/test_torch_media_system.py holds both
# copies to one dispatch count of the plain form).  Bytes a live lane: the
# ray (28) and four RNG words (32) read; the scatter writes four words, 13
# floats and a flag, the transmittance four words and three floats.
LANE_BYTES = {"scatter": 28 + 32 + 85, "tr": 28 + 32 + 44}
# operations: a live lane's RNG words and set-up, a live step, a step in
# the band (and each octave there), a lane that scattered
OPS = {"scatter": dict(lane=2828, step=61, band=11, octave=450, phase=456),
       "tr": dict(lane=1123, step=49, band=11, octave=450, phase=0)}


def work(kernel: str, lanes, steps, band, octaves: int, scattered=0):
    """(bytes, operations) of "scatter" (ME1) or "tr" (ME2) for `lanes`
    live lanes, `steps` live steps, `band` of them in the noise band and
    `scattered` lanes that scattered."""
    o = OPS[kernel]
    ops = (lanes * o["lane"] + steps * o["step"] + band * (o["band"] + octaves * o["octave"])
           + scattered * o["phase"])
    return lanes * LANE_BYTES[kernel], ops


def call_work(kernel: str, desc, fields):
    """(bytes, operations) of one kernel call on every lane of `fields`
    (LANE_FIELDS' CUDA tensors), from the kernel's own tally."""
    n = fields[0].shape[0]
    tally = torch.empty((2, n), dtype=torch.int32, device=fields[0].device)
    if kernel == "scatter":
        scattered = int(media.media_scatter(desc, fields, tally)[1].sum())
    else:
        media.media_transmittance(desc, fields, tally)
        scattered = 0
    steps, band = (int(v) for v in tally.sum(1))
    return work(kernel, n, steps, band, desc.noise_octaves, scattered)
