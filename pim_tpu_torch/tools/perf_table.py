"""Time of one progressive step by subsystem, on a CUDA device.

    python -m pim_tpu_torch.tools.perf_table [--out DIR]

Counterpart of `tools/make_perf_table.py`.  Two paths, each set up as
`prof_frame` sets up its step (`prof_frame.frame_step`, 512^2, 10 bounces):

  cornell   one sample of the bench frame (a 16-spp step's trace holds
            about 330k kernels; one sample's about 20k);
  e1m1      one sample and the exposure pass.

For each path: a warm-up step, WALLS untraced steps, then one step traced
by `torch.profiler` with `with_stack=True` and exported as a Chrome trace.
It prints the device time by subsystem (with the share left in "other"),
the top kernels by device time, the host self time of the torch ops by
subsystem, and the busy share (traced device time over the median untraced
wall, as prof_frame computes it).

Attribution.  The port's kernels launch through ctypes (native.py), so no
aten op holds them.  Each `kernel` event is linked to its launch (a
`cuda_runtime` or `cuda_driver` event) by `args.correlation`; the launch's
Python stack is the `python_function` events of its host thread that
contain it; the stack goes to the first subsystem of SUBSYSTEMS whose
pattern names one of its files, else to "other".  Memcpy and memset events
form the "copies" row.  Kernels on one stream do not nest, so a kernel's
self time is its duration and the rows sum to the traced device time; the
sum is checked against the profiler's own (`key_averages`) within SUM_RTOL.
A host op's self time is its duration less its child ops', and its stack
is taken at its start.

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
import json
import os
import re
import time
from collections import defaultdict

import torch

from pim_tpu_torch.tools import prof_frame

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TRACE_DIR = os.path.join(ROOT, "build", "perf_table")
PATHS = (("cornell", 1), ("e1m1", 1))  # (scene, samples in the traced step)
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
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
COPY_CATS = ("gpu_memcpy", "gpu_memset")


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


def attribute_host(events):
    """[(name, subsystem, self us)] for every host op (cpu_op event): its
    duration less its direct children's on its thread, by its stack."""
    by_thread = defaultdict(list)
    for e in _complete(events, "cpu_op"):
        by_thread[(e["pid"], e["tid"])].append(e)
    ops, selfs = [], []
    for key, evs in by_thread.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        open_ops = []  # (end, index into selfs)
        for e in evs:
            while open_ops and e["ts"] >= open_ops[-1][0]:
                open_ops.pop()
            if open_ops:
                selfs[open_ops[-1][1]] -= e["dur"]
            ops.append((key, e))
            selfs.append(e["dur"])
            open_ops.append((e["ts"] + e["dur"], len(selfs) - 1))
    stacks = stacks_at(python_frames(events), [(key, e["ts"]) for key, e in ops])
    return [(e["name"], classify(st), max(s, 0.0)) for (_, e), st, s in zip(ops, stacks, selfs)]


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
    """{kernel group of prof_frame (K1 ... K7-bwd): {subsystem: calls}}."""
    out = defaultdict(lambda: defaultdict(int))
    for name, sub, _ in rows:
        group = prof_frame.kernel_group(name)
        if group.startswith("K"):
            out[group][sub] += 1
    return {k: dict(v) for k, v in out.items()}


def traced_step(step, i: int, device: torch.device, trace_path: str):
    """Run step(i) under torch.profiler (with_stack; CUDA activity on a
    CUDA device) and export its Chrome trace.  Returns (the trace's events,
    key_averages, host wall s of the traced step)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, with_stack=True) as prof:
        t0 = time.perf_counter()
        step(i)
        wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return events, prof.key_averages(), wall


def run_path(name: str, scene, device: torch.device, spp: int,
             trace_dir: str = TRACE_DIR) -> dict:
    """The tables of one path (see the module docstring) on `scene`, built
    as SCENES[name] on `device` (a CUDA device)."""
    from pim_tpu_torch import native

    step = prof_frame.frame_step(name, scene, device, spp, prof_frame.BOUNCES)
    step(0)
    walls, wall_ms = prof_frame.untraced_walls(step)
    native.reset_launches()
    events, avgs, traced_s = traced_step(step, 1 + prof_frame.WALLS, device,
                                         os.path.join(trace_dir, f"{name}.trace.json"))
    launches = dict(native.launches)
    rows = attribute_device(events)
    dev = summarize(rows)
    _, profiler_ms, n_kernels = prof_frame.device_time(avgs)
    meta = scene[0]
    return {
        "path": name, "width": prof_frame.WIDTH, "height": prof_frame.HEIGHT, "spp": spp,
        "bounces": prof_frame.BOUNCES, "tris": meta.tri_count, "backend": meta.backend,
        "sort_rays": meta.sort_rays, "untraced_walls_s": walls, "wall_ms": wall_ms,
        "traced_wall_s": traced_s, "device_events": len(rows), "profiler_events": n_kernels,
        "device_ms": dev["ms"], "profiler_device_ms": profiler_ms,
        "sum_rel_diff": abs(dev["ms"] - profiler_ms) / max(profiler_ms, 1e-12),
        "busy_share": dev["ms"] / wall_ms, "launches": launches, "device": dev,
        "port_kernels": port_kernel_subsystems(rows), "host": summarize(attribute_host(events)),
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


def _table(title: str, summary: dict, unit: str) -> list:
    lines = [title, "", f"| subsystem | calls | {unit} ms | share |", "|---|---|---|---|"]
    lines += [f"| {k} | {c} | {ms:.4f} | {share:.4f} |"
              for k, (c, ms, share) in summary["subsystems"].items()]
    return lines + [""]


def markdown(results, card: str) -> str:
    out = [f"# Time by subsystem ({card})", "",
           "`python -m pim_tpu_torch.tools.perf_table`: one traced step of each path; "
           "device rows sum to the traced device time; host rows are the torch ops' self "
           "time with the profiler on.", ""]
    for r in results:
        dev = r["device"]
        out += [f"## {r['path']} {r['width']}x{r['height']}, {r['spp']} spp, {r['bounces']} "
                f"bounces ({r['tris']} tris, {r['backend']}, sort_rays {r['sort_rays']})", "",
                f"Median untraced wall {r['wall_ms']:.3f} ms; traced device time "
                f"{dev['ms']:.4f} ms in {r['device_events']} events (profiler's sum "
                f"{r['profiler_device_ms']:.4f} ms); busy share {r['busy_share']:.4f}; "
                f"'{OTHER}' {dev['other_share']:.4f} of the device time.", ""]
        out += _table("Device time by subsystem:", dev, "device")
        out += ["Top kernels by device time:", "",
                "| kernel | subsystem | calls | device ms | share |", "|---|---|---|---|---|"]
        out += [f"| `{name[:90]}` | {sub} | {c} | {ms:.4f} | {share:.4f} |"
                for name, sub, c, ms, share in dev["top"]]
        out += [""] + _table("Host self time of the torch ops by subsystem (profiler on):",
                             r["host"], "host")
    return "\n".join(out)


def print_result(r: dict, card: str) -> None:
    dev = r["device"]
    print(f"perf_table {r['path']} {r['width']}^2 {r['spp']} spp {r['bounces']} bounces: wall "
          f"{r['wall_ms']:.3f} ms, traced device {dev['ms']:.4f} ms (profiler "
          f"{r['profiler_device_ms']:.4f}, rel diff {r['sum_rel_diff']:.2e}), busy "
          f"{r['busy_share']:.4f}, other {dev['other_share']:.4f}, traced wall "
          f"{r['traced_wall_s']:.2f} s [{card}]")
    for k, (c, ms, share) in dev["subsystems"].items():
        print(f"  device {k}: calls={c} ms={ms:.4f} share={share:.4f}")
    for name, sub, c, ms, share in dev["top"]:
        print(f"  top {ms:.4f} ms {share:.4f} {sub} x{c} {name[:100]}")
    print(f"  port kernels by subsystem: {r['port_kernels']}")
    for k, (c, ms, share) in r["host"]["subsystems"].items():
        print(f"  host {k}: ops={c} self_ms={ms:.3f} share={share:.4f}")


def main(argv=None) -> int:
    from pim_tpu_torch.app import SCENES, card

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for perf_table.md and .json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("perf_table: no CUDA device is available")
    dev = torch.device("cuda", 0)
    smi = ", ".join(card(dev))
    print(smi)
    results = []
    for name, spp in PATHS:
        r = run_path(name, SCENES[name].build(dev), dev, spp)
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
