"""The port's headline benchmark: path-tracing throughput (Mrays/s) on the card.

    python -m pim_tpu_torch.bench [--device cuda|cpu]

Counterpart of the JAX package's `bench.py`, which stays that package's
benchmark.  Two configurations, the scenes and cameras of `app.SCENES`:

  * Cornell "boxes" 512^2, 10 bounces, SPP_PER_STEP samples a step (the
    headline metric; K1-K3);
  * e1m1 512^2, 10 bounces, 1 sample a step and the exposure pass (K3-K6,
    the cluster kernels with ray sorting).

`_measure` runs WARMUP steps, synchronises, then queues ITERS steps, each
returning its image mean and its rays traced as device tensors, and
synchronises once: a host sync a step would put host round trips into what
is timed.  The loop is `app.timed_steps`, which the app's bench frames
(`app.render_frame`) time with too.  The rays are summed on the host after
the sync.  On the card the timed steps run in torch's sync debug mode
("warn"), and the syncs it reports inside them are counted by source line
(`syncs_in_timed_steps`).

Before a number is printed, each frame is held to a band of
`render/gate_bands.json`: Cornell's mean of step means to `cornell512`, and
e1m1 to `e1m1_128` through a separate GATE_RES^2, GATE_STEPS-step, 1-spp
accumulated render (the CPU-anchored band).  The 512^2 e1m1 mean is printed
beside the TPU-seeded `e1m1_512` band for information only.  Gate lines go
to stderr.  The last stdout line is one JSON object in `bench.py`'s shape
(`metric`, `value`, `unit`, `vs_baseline`, `extra`), `extra` also holding
the card's name and power limit and the kernel launches of the timed
steps.  The exit code is 1 when a gate fails or the e1m1 run raises (the
line is still printed, with `e1m1_error`).

`--device cuda` (the default) with no GPU is an error; `--device cpu` runs
the plain versions of the kernels and is meant for tests at small sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import traceback
import warnings

import torch

from pim_tpu_torch.app import (
    EXPOSURE_DT,
    SCENES,
    bench_camera,
    card,
    check_device,
    render_frame,
    render_step,
    timed_steps,
)
from pim_tpu_torch.render.exposure import ExposureParams, exposure_pass, make_exposure_state

BASELINE_MRAYS = 30.0
WIDTH = HEIGHT = 512
MAX_BOUNCES = 10
WARMUP = 3
ITERS = 10
SPP_PER_STEP = 16
GATE_RES = 128   # e1m1's gate render: the e1m1_128 band's resolution,
GATE_STEPS = 16  # steps and 1 spp a step
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANDS = os.path.join(ROOT, "pim_tpu_torch", "render", "gate_bands.json")


def _repo_site(filename: str, lineno: int) -> str:
    """The innermost line of this repository on the stack of a warning
    being shown (skipping the hook's own frames), else the warning's own
    location."""
    for f in reversed(traceback.extract_stack()[:-2]):
        if f.filename.startswith(ROOT + os.sep):
            return f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"
    return f"{filename}:{lineno}"


@contextlib.contextmanager
def _sync_watch(device: torch.device, syncs: dict):
    """Fills `syncs` ({"count": n, "at": {"file:line": n}}) while the block
    runs with the host syncs torch reports on the card (sync debug mode
    "warn"), each at the innermost line of this repository that led to it.
    The switch into the mode happens before the block, unwatched: its first
    use in a process reports a sync of its own."""
    if device.type != "cuda":
        yield
        return

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return shown(message, category, filename, lineno, file, line)
        at = _repo_site(filename, lineno)
        syncs["count"] += 1
        syncs["at"][at] = syncs["at"].get(at, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            shown, warnings.showwarning = warnings.showwarning, note
            yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _measure(step, device: torch.device, iters: int, warmup: int):
    """step(i) -> (image mean, rays traced), both tensors on the device,
    through `app.timed_steps`.  Returns (Mrays/s, seconds a step, mean of
    the step means, launches of the timed steps, the host syncs torch
    reported during them: see `_sync_watch`)."""
    syncs = {"count": 0, "at": {}}
    handles, elapsed, launches = timed_steps(step, device, iters, warmup,
                                             _sync_watch(device, syncs))
    total_rays = sum(float(rays) for _, rays in handles)
    img_mean = sum(float(mean) for mean, _ in handles) / iters
    return total_rays / elapsed / 1e6, elapsed / iters, img_mean, launches, syncs


def _band(tag: str):
    with open(BANDS) as f:
        return json.load(f).get(tag)


def _check_gate(tag: str, img_mean: float) -> str:
    """'ok' when the image mean lies inside band `tag` of gate_bands.json,
    else a FAIL message ('uncalibrated' when the band is missing)."""
    band = _band(tag)
    if band is None:
        return "uncalibrated"
    lo = band["mean"] - band["half"]
    hi = band["mean"] + band["half"]
    ok = lo <= img_mean <= hi
    print(f"# gate[{tag}] mean={img_mean:.5f} band=[{lo:.5f}, {hi:.5f}] ({band['kind']}): "
          f"{'ok' if ok else 'FAIL'}", file=sys.stderr)
    return "ok" if ok else f"FAIL mean={img_mean:.5f} outside [{lo:.5f}, {hi:.5f}]"


def _bench_cornell(device: torch.device):
    """Cornell 512^2: a step is SPP_PER_STEP one-sample traces with sample
    ids step * SPP_PER_STEP + i, averaged.  Returns (Mrays/s, seconds a
    step, mean of the step means, launches, syncs)."""
    scene = SCENES["cornell"].build(device)
    cam = bench_camera("cornell", WIDTH, HEIGHT)

    def step(i: int):
        res = render_step(scene, cam, WIDTH, HEIGHT, MAX_BOUNCES, SPP_PER_STEP, i)
        return torch.mean(res.color), res.rays_traced

    return _measure(step, device, ITERS, WARMUP)


def _bench_e1m1(device: torch.device):
    """e1m1 512^2: a step is one one-sample trace (sample id = step) and
    the exposure pass on its image; then the GATE_RES^2 gate render.
    Returns (Mrays/s, seconds a step, tris, backend, 512^2 mean of the step
    means, gate render mean, launches, syncs)."""
    scene = SCENES["e1m1"].build(device)
    cam = bench_camera("e1m1", WIDTH, HEIGHT)
    exp_params = ExposureParams.from_cvars()

    def step(i: int):
        res = render_step(scene, cam, WIDTH, HEIGHT, MAX_BOUNCES, 1, i)
        exposure_pass(res.color, exp_params, make_exposure_state(device), EXPOSURE_DT)
        return torch.mean(res.color), res.rays_traced

    mrays, step_s, mean512, launches, syncs = _measure(step, device, ITERS, WARMUP)
    gate = render_frame(scene, "e1m1", GATE_RES, GATE_RES, MAX_BOUNCES, 1, GATE_STEPS)
    meta = scene[0]
    return mrays, step_s, meta.tri_count, meta.backend, mean512, gate.mean, launches, syncs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    check_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index if device.index is not None
                              else torch.cuda.current_device())
        torch.cuda.set_device(device)
    name, power_limit = card(device)
    print(f"# {name}, {power_limit}", file=sys.stderr)

    cornell_mrays, cornell_step, cornell_mean, cornell_launches, cornell_syncs = (
        _bench_cornell(device))
    gates = {"cornell512": _check_gate("cornell512", cornell_mean)}
    extra = {}
    try:
        (e1m1_mrays, e1m1_step, e1m1_tris, e1m1_backend, e1m1_mean, gate_mean, e1m1_launches,
         e1m1_syncs) = _bench_e1m1(device)
        gates["e1m1_128"] = _check_gate("e1m1_128", gate_mean)
        band = _band("e1m1_512")
        print(f"# band[e1m1_512] mean={e1m1_mean:.5f} band=[{band['mean'] - band['half']:.5f}, "
              f"{band['mean'] + band['half']:.5f}] ({band['kind']}): tpu-seeded, not gated",
              file=sys.stderr)
        extra.update(e1m1_mrays_per_s=round(e1m1_mrays, 4),
                     e1m1_step_ms=round(e1m1_step * 1e3, 3),
                     e1m1_tris=int(e1m1_tris),
                     e1m1_backend=str(e1m1_backend),
                     e1m1_mean_512=e1m1_mean,
                     e1m1_gate_mean_128=gate_mean)
    except Exception as ex:  # the headline metric still reports; the exit code says it failed
        traceback.print_exc()
        extra["e1m1_error"] = repr(ex)[:200]
        e1m1_launches, e1m1_syncs = None, None
    extra["gate"] = ("ok" if all(g == "ok" for g in gates.values()) else dict(gates))
    extra.update(cornell_step_ms=round(cornell_step * 1e3, 3), cornell_mean=cornell_mean,
                 device=name, power_limit=power_limit,
                 launches={"cornell": cornell_launches, "e1m1": e1m1_launches},
                 syncs_in_timed_steps={"cornell": cornell_syncs, "e1m1": e1m1_syncs})
    print(json.dumps({
        "metric": "cornell512_pathtrace_throughput",
        "value": round(cornell_mrays, 4),
        "unit": "Mrays/s",
        "vs_baseline": round(cornell_mrays / BASELINE_MRAYS, 4),
        "extra": extra,
    }))
    return 1 if "e1m1_error" in extra or extra["gate"] != "ok" else 0


if __name__ == "__main__":
    sys.exit(main())
