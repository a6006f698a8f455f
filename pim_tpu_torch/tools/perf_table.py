"""Where one step's time goes on a CUDA device: by subsystem and kernel group.

    python -m pim_tpu_torch.tools.perf_table [--scene cornell|e1m1] [--train] [--media]
        [--bounces N] [--out DIR]

Counterpart of `tools/make_perf_table.py`.  A path is a scene of
`app.SCENES` built on the card (both, Cornell first, unless `--scene`
names one) and one step of its 512^2 bench frame (`frame_step`): one
sample at `--bounces` bounces (10), e1m1's step also running the exposure
pass (a 16-spp Cornell step's trace holds about 330k kernels, one
sample's about 20k).  With `--media` the step marches the default
participating medium (csrc/media.cu's kernels on the card, about 250
launches a segment with the in-media NEE; `--bounces` cuts the depth).
With `--train`
a step is instead one training step of the differentiable path
(render/diff.py): 512^2, TRAIN_BOUNCES bounces, 1 spp, every parameter
group trainable, Adam against a target rendered with the albedos moved
(x0.8); the sky is re-baked at the scene's own bake steps.

For each path: a warm-up step (on a CUDA device the peak memory torch
allocated up to its end is reported as `max_memory_allocated`), then one
step traced by `torch.profiler` with `with_stack=True` inside a host span
named WINDOW, which closes after the step's device sync, exported as a
Chrome trace.  It prints the device
time by subsystem (with the share left in "other"), the top kernels by
device time, the device time by kernel group (GROUPS: a kernel goes to the
first group whose name fragment its name holds, else to "other"), and the
busy share: the union of the device events' intervals (kernels, copies,
sets) inside the WINDOW span over the span's length, both from the one
trace, as `pimbench/metrics/device_idle_share.py` reads a window.  The
profiler slows the host several times over, so the share is that of the
traced step; the benchmark's `--trace 0` runs give the untraced numbers.

Attribution.  The port's kernels launch through ctypes (native.py), so no
aten op holds them.  Each `kernel` event is linked to its launch (a
`cuda_runtime` or `cuda_driver` event) by `args.correlation`; the launch's
Python stack is the `python_function` events of its host thread that
contain it; the stack goes to the first subsystem of SUBSYSTEMS whose
pattern names one of its files, else to "other".  Memcpy and memset events
form the "copies" row.  Kernels on one stream do not nest, so a kernel's
self time is its duration and the rows sum to the traced device time; the
sum is checked against the profiler's own (`key_averages`) within SUM_RTOL.

SUBSYSTEMS is make_perf_table's list (`:106-122`) with the port's files
(`render/dense_kernels.py` for `pallas_kernels.py` and `intersect.py`,
`math/noise.py` beside `media.py`, `render/render_system.py`, whose
`trace_samples` folds a step's samples, beside `integrator.py`), except
that its two kernel rows lead: a kernel and the torch ops of its wrapper
are named by the wrapper's module (`intersect` for K1, K2, K4 and K5,
`table-gather` for K3, K6 and K7), so the other rows hold the torch work of
their own modules.  In the JAX tool `sky` and `nee-light` came first, and
the NEE's any-hit kernel counted as `nee-light`.

The tables are written only to `--out DIR` (DIR/perf_table.md and
DIR/perf_table.json), never to PERF.md.  The Chrome traces always go to
build/perf_table/ (gitignored).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TRACE_DIR = os.path.join(ROOT, "build", "perf_table")
PATHS = ("cornell", "e1m1")  # the scenes profiled when --scene names none
WIDTH = HEIGHT = 512
BOUNCES = 10
TRAIN_BOUNCES = 3  # make_render_fn's default
WINDOW = "perf_table.step"  # the host span around the traced step
SUM_RTOL = 0.01
OTHER = "other"
COPIES = "copies"

# (subsystem, pattern of the files that name it), in priority order
SUBSYSTEMS = (
    ("intersect", re.compile(r"render/dense_kernels\.py|render/cluster\.py")),
    ("table-gather", re.compile(r"render/table_gather\.py|render/gather_kernel\.py")),
    ("sky", re.compile(r"render/sky\.py")),
    ("media", re.compile(r"render/media\.py|math/noise\.py")),
    ("nee-light", re.compile(r"render/lights\.py")),
    ("bsdf", re.compile(r"render/bsdf\.py|math/brdf\.py")),
    ("exposure", re.compile(r"render/exposure\.py")),
    ("raygen", re.compile(r"render/camera\.py")),
    ("raysort", re.compile(r"render/raysort\.py")),
    ("surface-fetch", re.compile(r"render/surface\.py|render/fetch\.py")),
    ("light-learn", re.compile(r"math/dist1d\.py|math/grid\.py")),
    ("sampling", re.compile(r"math/sampling\.py")),
    ("integrator-glue", re.compile(
        r"render/integrator\.py|render/scene\.py|render/render_system\.py")),
    ("rng", re.compile(r"core/rng\.py")),
    ("vec-math", re.compile(r"math/vec3\.py")),
)
# (group, name fragments), in the order a kernel name is matched
GROUPS = (
    ("K1 dense_isect", ("dense_isect_kernel",)),
    ("K2 dense_anyhit", ("dense_anyhit_kernel",)),
    ("K3 gather_cols", ("gather_cols_kernel", "gather_cols_rows_kernel")),
    ("K3-bwd gather_cols_bwd", ("gather_cols_bwd_kernel", "gather_cols_bwd_rows_kernel")),
    ("K4 cluster_isect", ("cluster_isect_kernel",)),
    ("K5 cluster_anyhit", ("cluster_anyhit_kernel",)),
    ("K6 gather_bilinear", ("gather_bilinear_kernel",)),
    ("K7 gather_texels", ("gather_texels_kernel",)),
    ("K7-bwd gather_texels_bwd", ("gather_texels_bwd_kernel", "gather_texels_bwd_rows_kernel")),
    ("torch index/gather/scatter", ("index", "scatter", "gather")),
    ("torch sort/scan", ("sort", "scan", "radix")),
    ("torch reduce", ("reduce",)),
    ("torch elementwise", ("elementwise",)),
)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
COPY_CATS = ("gpu_memcpy", "gpu_memset")
DEVICE_CATS = ("kernel",) + COPY_CATS


def kernel_group(name: str) -> str:
    for group, fragments in GROUPS:
        if any(f in name for f in fragments):
            return group
    return OTHER


def _device_ms(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
        us = evt.self_cuda_time_total
    return us / 1e3


def _is_kernel(evt) -> bool:
    return evt.device_type == torch.autograd.DeviceType.CUDA


def device_time(avgs):
    """(device events, their summed device ms, their count) of a
    profiler's key_averages, less the WINDOW span's device-side copy, which
    covers the step's kernels and would count them twice."""
    kernels = [e for e in avgs if _is_kernel(e) and e.key != WINDOW]
    return kernels, sum(_device_ms(e) for e in kernels), sum(e.count for e in kernels)


def classify(stack) -> str:
    """The subsystem of a Python stack (frame names, any order): the first
    of SUBSYSTEMS that names one of its files, else OTHER."""
    for label, pattern in SUBSYSTEMS:
        if any(pattern.search(frame) for frame in stack):
            return label
    return OTHER


def _complete(events, cat):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == cat]


def python_frames(events):
    """{(pid, tid): [(start, end, name)]} of the python_function events,
    sorted by start, outer frames first."""
    frames = defaultdict(list)
    for e in _complete(events, "python_function"):
        frames[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    for fs in frames.values():
        fs.sort(key=lambda f: (f[0], -f[1]))
    return frames


def stacks_at(frames, points):
    """The Python stack (frame names, outermost first) at each point
    ((pid, tid), ts).  A point on a thread without Python frames takes the
    stacks of the thread with the most frames (the main thread)."""
    main = max(frames, key=lambda k: len(frames[k])) if frames else None
    by_thread = defaultdict(list)
    for i, (key, ts) in enumerate(points):
        by_thread[key if key in frames else main].append((ts, i))
    out = [()] * len(points)
    for key, pts in by_thread.items():
        fs = frames.get(key, [])
        stack, j = [], 0
        for ts, i in sorted(pts):
            while j < len(fs) and fs[j][0] <= ts:
                while stack and stack[-1][1] <= fs[j][0]:
                    stack.pop()
                stack.append(fs[j])
                j += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[i] = tuple(f[2] for f in stack)
    return out


def attribute_device(events):
    """[(name, subsystem, us)] for every kernel, memcpy and memset event of
    a trace: a kernel by the stack of its launch, a copy to COPIES."""
    launches = {}
    for cat in LAUNCH_CATS:
        for e in _complete(events, cat):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ((e["pid"], e["tid"]), e["ts"])
    kernels = _complete(events, "kernel")
    found = [launches.get(e.get("args", {}).get("correlation")) for e in kernels]
    stacks = iter(stacks_at(python_frames(events), [p for p in found if p is not None]))
    rows = [(e["name"], classify(next(stacks)) if p is not None else OTHER, e["dur"])
            for e, p in zip(kernels, found)]
    for cat in COPY_CATS:
        rows += [(e["name"], COPIES, e["dur"]) for e in _complete(events, cat)]
    return rows


def busy_share(events):
    """(busy share, window ms) of a trace: the union of its device events'
    intervals, clipped to the one host span named WINDOW, over that span's
    length."""
    spans = [e for e in _complete(events, "user_annotation") if e["name"] == WINDOW]
    if len(spans) != 1:
        raise RuntimeError(f"{len(spans)} '{WINDOW}' spans in the trace, expected 1")
    lo = float(spans[0]["ts"])
    hi = lo + float(spans[0]["dur"])
    busy, cursor = 0.0, lo
    for start, end in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                             for cat in DEVICE_CATS for e in _complete(events, cat)):
        start, end = max(start, cursor), min(end, hi)
        if end > start:
            busy += end - start
            cursor = end
    return (busy / (hi - lo) if hi > lo else 0.0), (hi - lo) / 1e3


def summarize(rows, top: int = 15) -> dict:
    """Rows (name, subsystem, us) -> total ms, {subsystem: [calls, ms,
    share]} (largest first), OTHER's share and the `top` (name, subsystem)
    pairs by time as [name, subsystem, calls, ms, share]."""
    total = sum(us for _, _, us in rows) / 1e3
    subs = defaultdict(lambda: [0, 0.0])
    pairs = defaultdict(lambda: [0, 0.0])
    for name, sub, us in rows:
        for acc in (subs[sub], pairs[(name, sub)]):
            acc[0] += 1
            acc[1] += us / 1e3
    share = (lambda ms: ms / total) if total > 0 else (lambda ms: 0.0)
    by_sub = {k: [c, ms, share(ms)]
              for k, (c, ms) in sorted(subs.items(), key=lambda kv: -kv[1][1])}
    tops = sorted(pairs.items(), key=lambda kv: -kv[1][1])[:top]
    return {"ms": total, "subsystems": by_sub,
            "other_share": by_sub.get(OTHER, [0, 0.0, 0.0])[2],
            "top": [[name, sub, c, ms, share(ms)] for (name, sub), (c, ms) in tops]}


def port_kernel_subsystems(rows) -> dict:
    """{kernel group (K1 ... K7-bwd): {subsystem: calls}}."""
    out = defaultdict(lambda: defaultdict(int))
    for name, sub, _ in rows:
        group = kernel_group(name)
        if group.startswith("K"):
            out[group][sub] += 1
    return {k: dict(v) for k, v in out.items()}


def _train_step_fn(scene, cam, dev):
    """step(i) of the differentiable path: one Adam step of every group,
    then a sync of a CUDA device."""
    from pim_tpu_torch.app import SKY_STEPS, SUN_DIR, SUN_LUM, sync
    from pim_tpu_torch.render import diff

    meta, arrays, lights = scene
    params = diff.extract_params(meta, arrays, cam, sun_dir=SUN_DIR, sun_lum=(SUN_LUM,) * 3)
    with torch.no_grad():
        target, _ = diff.make_render_fn(meta, WIDTH, HEIGHT, TRAIN_BOUNCES, SKY_STEPS)(
            params._replace(mat_albedo=params.mat_albedo * 0.8), arrays, lights, cam, 0)
    init, train = diff.make_train_step(meta, WIDTH, HEIGHT, TRAIN_BOUNCES, SKY_STEPS)
    opt = init(params)

    def step(i: int):
        train(params, opt, arrays, lights, cam, target, i)
        sync(dev)

    return step


def frame_step(scene_name: str, scene, dev, bounces: int):
    """step(i) of the WIDTH x HEIGHT bench frame: sample i (the exposure
    pass too where the scene runs it), then a sync of a CUDA device."""
    from pim_tpu_torch.app import EXPOSURE_DT, SCENES, bench_camera, render_step, sync
    from pim_tpu_torch.render.exposure import (
        ExposureParams,
        exposure_pass,
        make_exposure_state,
    )

    cam = bench_camera(scene_name, WIDTH, HEIGHT)
    exp_params = ExposureParams.from_cvars() if SCENES[scene_name].exposed else None

    def step(i: int):
        res = render_step(scene, cam, WIDTH, HEIGHT, bounces, 1, i)
        if exp_params is not None:
            exposure_pass(res.color, exp_params, make_exposure_state(dev), EXPOSURE_DT)
        sync(dev)
        return res

    return step


def traced_step(step, i: int, device: torch.device, trace_path: str):
    """Run step(i) inside the WINDOW span under torch.profiler (with_stack;
    CUDA activity on a CUDA device) and export its Chrome trace.  Returns
    (the trace's events, key_averages, host wall s of the traced step)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, with_stack=True) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            step(i)
        wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return events, prof.key_averages(), wall


def run_path(name: str, scene, device: torch.device, bounces: int = BOUNCES,
             train: bool = False, trace_dir: str = TRACE_DIR) -> dict:
    """The tables of one path (see the module docstring) on `scene`, built
    as SCENES[name] on `device`."""
    from pim_tpu_torch import native
    from pim_tpu_torch.app import bench_camera

    if train:
        bounces = TRAIN_BOUNCES
        step = _train_step_fn(scene, bench_camera(name, WIDTH, HEIGHT), device)
    else:
        step = frame_step(name, scene, device, bounces)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    step(0)  # warm-up: the kernel library and torch's own kernels load here
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    native.reset_launches()
    events, avgs, traced_s = traced_step(step, 1, device,
                                         os.path.join(trace_dir, f"{name}.trace.json"))
    launches = dict(native.launches)
    rows = attribute_device(events)
    dev = summarize(rows)
    _, profiler_ms, n_kernels = device_time(avgs)
    if cuda and profiler_ms <= 0.0:
        raise RuntimeError("the trace holds no device time; time with CUDA events instead")
    busy, window_ms = busy_share(events)
    meta = scene[0]
    return {
        "path": name, "train": train, "media": meta.media_enabled, "width": WIDTH,
        "height": HEIGHT, "bounces": bounces, "tris": meta.tri_count,
        "backend": meta.backend, "sort_rays": meta.sort_rays, "traced_wall_s": traced_s,
        "max_memory_allocated": peak, "window_ms": window_ms, "busy_share": busy,
        "device_events": len(rows),
        "profiler_events": n_kernels, "device_ms": dev["ms"], "profiler_device_ms": profiler_ms,
        "sum_rel_diff": abs(dev["ms"] - profiler_ms) / max(profiler_ms, 1e-12),
        "launches": launches, "device": dev,
        "groups": summarize([(n, kernel_group(n), us) for n, sub, us in rows
                             if sub != COPIES])["subsystems"],
        "port_kernels": port_kernel_subsystems(rows),
    }


def check(result: dict) -> None:
    """Raise unless the rows sum to the profiler's device time within
    SUM_RTOL and no launched port kernel fell to OTHER."""
    if not result["sum_rel_diff"] <= SUM_RTOL:
        raise AssertionError(f"{result['path']}: the subsystem rows sum to "
                             f"{result['device_ms']:.4f} ms, the profiler's device time is "
                             f"{result['profiler_device_ms']:.4f} ms")
    lost = {k: v[OTHER] for k, v in result["port_kernels"].items() if OTHER in v}
    if lost:
        raise AssertionError(f"{result['path']}: port kernels in '{OTHER}': {lost}")


def _step_label(r: dict) -> str:
    kind = "training step" if r["train"] else "1 spp"
    return (f"{r['path']} {r['width']}x{r['height']}, {kind}, {r['bounces']} bounces"
            f"{', media' if r['media'] else ''}")


def _table(title: str, rows: dict, label: str) -> list:
    lines = [title, "", f"| {label} | calls | device ms | share |", "|---|---|---|---|"]
    lines += [f"| {k} | {c} | {ms:.4f} | {share:.4f} |" for k, (c, ms, share) in rows.items()]
    return lines + [""]


def markdown(results, card: str) -> str:
    out = [f"# Device time by subsystem ({card})", "",
           "`python -m pim_tpu_torch.tools.perf_table`: one traced step of each path; "
           "the rows sum to the traced device time; the busy share is the union of the "
           "device events over the traced step's window.", ""]
    for r in results:
        dev = r["device"]
        out += [f"## {_step_label(r)} ({r['tris']} tris, {r['backend']}, sort_rays "
                f"{r['sort_rays']})", "",
                f"Traced device time {dev['ms']:.4f} ms in {r['device_events']} events "
                f"(profiler's sum {r['profiler_device_ms']:.4f} ms); window "
                f"{r['window_ms']:.3f} ms, busy share {r['busy_share']:.4f}; '{OTHER}' "
                f"{dev['other_share']:.4f} of the device time.", ""]
        out += _table("Device time by subsystem:", dev["subsystems"], "subsystem")
        out += _table("Device time by kernel group:", r["groups"], "group")
        out += ["Top kernels by device time:", "",
                "| kernel | subsystem | calls | device ms | share |", "|---|---|---|---|---|"]
        out += [f"| `{name[:90]}` | {sub} | {c} | {ms:.4f} | {share:.4f} |"
                for name, sub, c, ms, share in dev["top"]] + [""]
    return "\n".join(out)


def print_result(r: dict, card: str) -> None:
    dev = r["device"]
    print(f"perf_table {_step_label(r)}: traced device {dev['ms']:.4f} ms (profiler "
          f"{r['profiler_device_ms']:.4f}, rel diff {r['sum_rel_diff']:.2e}), window "
          f"{r['window_ms']:.3f} ms, busy {r['busy_share']:.4f}, other "
          f"{dev['other_share']:.4f}, traced wall {r['traced_wall_s']:.2f} s, "
          f"max_memory_allocated {r['max_memory_allocated']}, launches {r['launches']} "
          f"[{card}]")
    for k, (c, ms, share) in dev["subsystems"].items():
        print(f"  device {k}: calls={c} ms={ms:.4f} share={share:.4f}")
    for k, (c, ms, share) in r["groups"].items():
        print(f"  group {k}: calls={c} ms={ms:.4f} share={share:.4f}")
    for name, sub, c, ms, share in dev["top"]:
        print(f"  top {ms:.4f} ms {share:.4f} {sub} x{c} {name[:100]}")
    print(f"  port kernels by subsystem: {r['port_kernels']}")


def main(argv=None) -> int:
    from pim_tpu_torch.app import SCENES, card

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default=None, choices=PATHS,
                    help="profile this scene only (default: each of PATHS)")
    ap.add_argument("--train", action="store_true",
                    help="profile a training step of the differentiable path")
    ap.add_argument("--media", action="store_true",
                    help="march the default medium (render/media.py)")
    ap.add_argument("--bounces", type=int, default=BOUNCES)
    ap.add_argument("--out", default=None, help="directory for perf_table.md and .json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("perf_table: no CUDA device is available")
    dev = torch.device("cuda", 0)
    smi = ", ".join(card(dev))
    print(smi)
    results = []
    for name in (args.scene,) if args.scene else PATHS:
        scene = SCENES[name].build(dev)
        if args.media:
            scene = (dataclasses.replace(scene[0], media_enabled=True),) + tuple(scene[1:])
        r = run_path(name, scene, dev, args.bounces, args.train)
        print_result(r, smi)
        results.append(r)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "perf_table.md"), "w") as f:
            f.write(markdown(results, smi) + "\n")
        with open(os.path.join(args.out, "perf_table.json"), "w") as f:
            json.dump({"card": smi, "paths": results}, f, indent=1)
    for r in results:
        check(r)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
