"""One traced window: the profiler's Chrome trace reduced to device
events attributed to the port's layers, the busy time, the idle gaps and
the breakdown of a result line.

The attribution is a frozen copy of the port's `tools/perf_table.py`
device attribution (`python_frames`, `stacks_at`, `attribute_device`): a
kernel is linked to its launch by the trace's correlation id, and the
launch's Python stack is the `python_function` events of its host thread
that contain it (a thread without Python frames takes the main thread's).
The stack names the layer: the first of LAYERS whose pattern names one of
its frames, else the benchmark's own code ("harness") or OTHER.  Device
time is summed per kernel; busy time is the union of the device events'
intervals inside the window.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

OTHER = "other"
HARNESS = "harness"
# (group, pattern of the files that name it), in priority order; isect,
# gather and fetch make PERF.md's layer "intersection and fetch", shading
# its "shading NEE sky exposure", loop its "frame step and bounce loop"
LAYERS = (
    ("isect", re.compile(r"pim_tpu_torch/render/(dense_kernels|cluster|intersect)\.py")),
    ("gather", re.compile(r"pim_tpu_torch/render/(table_gather|gather_kernel)\.py")),
    ("shading", re.compile(
        r"pim_tpu_torch/render/(bsdf|lights|sky|exposure|surface|camera|media)\.py"
        r"|pim_tpu_torch/math/|pim_tpu_torch/core/rng\.py")),
    ("fetch", re.compile(r"pim_tpu_torch/render/(scene|raysort|fetch)\.py")),
    ("loop", re.compile(
        r"pim_tpu_torch/render/(integrator|render_system|diff|lightmap)\.py"
        r"|pim_tpu_torch/app\.py")),
)
HARNESS_PATTERN = re.compile(r"pimbench/")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
FILE_RE = re.compile(r"((?:pim_tpu_torch|pimbench)/[\w/]+\.py)")


def classify(stack) -> str:
    """The group of a Python stack (frame names, any order)."""
    for label, pattern in LAYERS:
        if any(pattern.search(frame) for frame in stack):
            return label
    if any(HARNESS_PATTERN.search(frame) for frame in stack):
        return HARNESS
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


@dataclass
class DeviceEvent:
    name: str
    cat: str
    group: str
    ts: float   # us
    dur: float  # us


def attribute_device(events) -> List[DeviceEvent]:
    """Every kernel, memcpy and memset event of a trace with its group: a
    kernel by the stack of its launch, a copy by its own launch's stack
    too (OTHER where no launch is found)."""
    launches = {}
    for cat in LAUNCH_CATS:
        for e in _complete(events, cat):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ((e["pid"], e["tid"]), e["ts"])
    dev = [e for cat in DEVICE_CATS for e in _complete(events, cat)]
    found = [launches.get(e.get("args", {}).get("correlation")) for e in dev]
    stacks = iter(stacks_at(python_frames(events), [p for p in found if p is not None]))
    return [DeviceEvent(e["name"], e["cat"], classify(next(stacks)) if p is not None else OTHER,
                        float(e["ts"]), float(e["dur"]))
            for e, p in zip(dev, found)]


def union_us(intervals, lo: float, hi: float):
    """(total us covered, [(gap start, gap end)]) of the intervals
    [(start, end)] clipped to [lo, hi]."""
    busy = 0.0
    gaps = []
    cursor = lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= cursor:
            continue
        if s > cursor:
            gaps.append((cursor, s))
            cursor = s
        busy += e - cursor
        cursor = e
    if cursor < hi:
        gaps.append((cursor, hi))
    return busy, gaps


def host_site(stack) -> str:
    """The innermost file and function of the checkout on a host stack
    (what the host was doing), else OTHER."""
    for frame in reversed(stack):
        m = FILE_RE.search(frame)
        if m:
            return frame[m.start():][:120]
    return OTHER


@dataclass
class Traced:
    """What the per-layer readers read.  Times in seconds."""
    kind: str                          # the traffic's driver: render, train, bake
    steps: int                         # steps in the traced window
    window_s: float
    busy_s: float
    device: List[DeviceEvent]          # inside the window
    gaps: List[tuple]                  # (seconds, host site) of each idle gap
    calls: object = None               # hooks.Calls of the window
    extra: Dict[str, float] = field(default_factory=dict)  # the traffic code's numbers (scene_build_s)

    def program_events(self):
        return [e for e in self.device if e.group not in (HARNESS,)]

    def group_seconds(self, group: str) -> float:
        return sum(e.dur for e in self.device if e.group == group) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        by_name = defaultdict(float)
        for e in self.device:
            by_name[e.name] += e.dur / 1e6
        by_site = defaultdict(float)
        for secs, site in self.gaps:
            by_site[site] += secs
        return {"device_ops": [[n[:200], s] for n, s in
                               sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
                "idle_gaps": [[n, s] for n, s in
                              sorted(by_site.items(), key=lambda kv: -kv[1])[:top]]}


WINDOW_SPAN = "pimbench.window"


def reduce(path: str, kind: str, steps: int, calls=None, extra=None) -> Traced:
    """The Traced of a Chrome trace at `path` whose window is the host
    span named WINDOW_SPAN (it closes after the window's sync)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN
             and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise RuntimeError(f"{path}: {len(spans)} '{WINDOW_SPAN}' spans, expected 1")
    lo = float(spans[0]["ts"])
    hi = lo + float(spans[0]["dur"])
    main = (spans[0]["pid"], spans[0]["tid"])
    dev = [d for d in attribute_device(events) if d.ts < hi and d.ts + d.dur > lo]
    busy, gaps = union_us([(d.ts, d.ts + d.dur) for d in dev], lo, hi)
    frames = python_frames(events)
    sites = stacks_at({main: frames.get(main, [])} if main in frames else frames,
                      [(main, s) for s, _ in gaps])
    return Traced(kind, steps, (hi - lo) / 1e6, busy / 1e6, dev,
                  [((e - s) / 1e6, host_site(st)) for (s, e), st in zip(gaps, sites)],
                  calls, dict(extra or {}))


def remove(path: str) -> None:
    if os.path.exists(path):
        os.remove(path)
