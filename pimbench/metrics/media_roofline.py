"""media_roofline.<kind>: the media kernels' share (percent) of their
bound: 100 x the bound over the device time of `media_scatter` (ME1) and
`media_transmittance` (ME2) in the stack pass's traced window.

The bound is the kernel table's rule, max(bytes / 3.35 TB/s, operations /
67 TFLOP/s), of each kernel, summed, and counts only the work whose result
is used:
- lanes: those whose result the caller keeps (`media.lanes`, the live
  lanes of a segment's march; `media.tr_live`, the lanes whose shadow ray
  counts), not every lane a call hands the kernel;
- bytes: each such lane's ray (origin, direction, segment length: 28 B)
  and four int64 RNG words (32 B) read once, and its outputs written once:
  ME1 the four new words, 13 floats and a flag (85 B), ME2 the four words
  and the transmittance (44 B);
- operations: what the plain form (`render/media.py:march_plain`,
  `calc_transmittance_plain`) computes, counted as its elementwise ops on
  [N] tensors with each 32-bit product or sum that the int64 form splits
  (`core/rng.py:mul32`, `add32`) counted once.  A lane pays its RNG words
  (every one: the stream goes on) and set-up ("lane"); each step at which
  it is still live pays the free path, attenuation and scatter test
  ("step", `media.march_steps`/`media.tr_steps`); each such step whose
  point lies in the noise band pays the band's density, the fBm's octaves
  ("band", "octave"; `media.march_band`/`media.tr_band`; outside the band
  the density does not depend on the fBm); each lane that scattered pays
  the phase sampling and the continuation ("phase", `media.scattered`).
  A CPU test holds OPS to a dispatch count of the plain form, category by
  category.  They read the same whatever implements the march.
The counters are the program's, over the stackless pass; the octaves are
the configuration's medium's."""

from pimbench import spans
from pimbench.metrics.peaks import HBM_BYTES_PER_S

FLOPS = 67e12                 # the H100 SXM's float32 rate (the kernel table's rule)
KERNELS = {"scatter": "media_scatter_kernel", "tr": "media_transmittance_kernel"}
LANE_BYTES = {"scatter": 28 + 32 + 85, "tr": 28 + 32 + 44}
OPS = {"scatter": dict(lane=2828, step=61, band=11, octave=450, phase=456),
       "tr": dict(lane=1123, step=49, band=11, octave=450, phase=0)}
# (lanes, steps, band, scattered) counters of each kernel
COUNTERS = {"scatter": ("media.lanes", "media.march_steps", "media.march_band", "media.scattered"),
            "tr": ("media.tr_live", "media.tr_steps", "media.tr_band", None)}


def work(kernel: str, lanes, steps, band, octaves: int, scattered=0):
    """(bytes, operations) of ME1 ("scatter") or ME2 ("tr") for `lanes`
    live lanes, `steps` live steps, `band` of them in the band, `scattered`
    lanes that scattered, through a medium of `octaves` fBm octaves."""
    o = OPS[kernel]
    ops = (lanes * o["lane"] + steps * o["step"] + band * (o["band"] + octaves * o["octave"])
           + scattered * o["phase"])
    return lanes * LANE_BYTES[kernel], ops


def bound_s(kernel: str, lanes, steps, band, octaves: int, scattered=0) -> float:
    nbytes, ops = work(kernel, lanes, steps, band, octaves, scattered)
    return max(nbytes / HBM_BYTES_PER_S, ops / FLOPS)


def read(t, kind):
    if t.steps <= 0:
        return None
    found = spans._harness_run()
    s = spans.of(t)
    if s is None or found is None or "media" not in getattr(found[0], "cfg", {}):
        return None
    octaves = int(found[0].cfg["media"]["noise_octaves"])
    secs = bound = 0.0
    for kernel, name in KERNELS.items():
        us = sum(e.dur for e in t.device if e.cat == "kernel" and name in e.name)
        counts = [spans.counter(s, c) / max(s.steps, 1) if c else 0.0 for c in COUNTERS[kernel]]
        if us <= 0 or counts[0] <= 0:
            continue
        secs += us / 1e6 / t.steps
        bound += bound_s(kernel, *counts[:3], octaves, counts[3])
    return 100.0 * bound / secs if secs > 0 else None
