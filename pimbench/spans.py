"""The stackless traced pass: the program's own spans and counters
(`pim_tpu_torch/core/profiler.py`), reduced by span.

With `--trace 1` the harness first runs its stack pass
(`run.traced_window`, read by the older per-layer metrics).  The first
reader of a metric of this module's (`of`) then runs a second pass, once
a run: the program's tracing switched on and its counters reset, the
traffic's `trace_steps` more steps (the step indices continuing) under
`torch.profiler` with CPU and CUDA activities and no stacks, and no hooks.
Its Chrome trace is reduced here and removed; tracing is switched off
again before the check.  A program without tracing (no
`profiler.set_tracing`) gets no pass, and these metrics read nothing.

The reduction (`reduce`):
- a device event belongs to the innermost `pt.*` user annotation open at
  its launch (matched by correlation id) on the launch's thread; a launch
  on a thread with no open `pt.*` span takes the main thread's innermost
  span at that time (autograd's device thread runs the backward); without
  either it is the harness's;
- self time = inclusive time minus what the child spans cover, host and
  device time alike;
- each gap in the union of the device events is put down to the main
  thread's innermost `pt.*` span open at the gap's start, else `harness`.
"""

from __future__ import annotations

import json
import os
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from pimbench.trace import DEVICE_CATS, LAUNCH_CATS, union_us

HARNESS = "harness"
PREFIX = "pt."
WINDOW_SPAN = "pimbench.spans"
TRACE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "build", "pimbench_trace")


@dataclass
class SpanStat:
    """One span name's totals over the pass (us; kernels counted)."""
    calls: int = 0
    host_us: float = 0.0
    host_self_us: float = 0.0
    device_us: float = 0.0
    device_self_us: float = 0.0
    kernels: int = 0
    kernels_self: int = 0


@dataclass
class Spans:
    """What the stackless pass measured.  Times in us over the pass."""
    steps: int
    window_us: float
    busy_us: float                      # the union of the device events
    device_us: float                    # the sum of the device events' durations
    top_host_us: float                  # main thread, inside top-level pt.* spans
    by_span: Dict[str, SpanStat]
    gaps: Dict[str, float]              # idle us by span (or HARNESS)
    harness_ops: Dict[str, List[float]]  # device events outside pt.* spans: name -> [us, n]
    counters: Dict[str, object] = field(default_factory=dict)

    def harness_device_us(self) -> float:
        return sum(us for us, _ in self.harness_ops.values())


def _complete(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def _innermost(spans_by_thread, points):
    """For each point (thread, ts): the index of the innermost span open at
    ts on that thread (spans_by_thread: thread -> [(start, end, index)]
    sorted by start, outer first), or None."""
    out = [None] * len(points)
    by_thread = defaultdict(list)
    for i, (th, ts) in enumerate(points):
        by_thread[th].append((ts, i))
    for th, pts in by_thread.items():
        sp = spans_by_thread.get(th, [])
        stack, j = [], 0
        for ts, i in sorted(pts):
            while j < len(sp) and sp[j][0] <= ts:
                while stack and stack[-1][1] <= sp[j][0]:
                    stack.pop()
                stack.append(sp[j])
                j += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[i] = stack[-1][2] if stack else None
    return out


def reduce(events, steps: int, counters=None) -> Spans:
    """The Spans of a Chrome trace's events whose window is the host span
    named WINDOW_SPAN (it closes after the window's sync)."""
    windows = [e for e in _complete(events, ("user_annotation",)) if e["name"] == WINDOW_SPAN]
    if len(windows) != 1:
        raise RuntimeError(f"{len(windows)} '{WINDOW_SPAN}' spans, expected 1")
    lo = float(windows[0]["ts"])
    hi = lo + float(windows[0]["dur"])
    main = (windows[0]["pid"], windows[0]["tid"])

    # span instances, sorted by start (outer first), each with its parent
    inst = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
                    (e["pid"], e["tid"]))
                   for e in _complete(events, ("user_annotation",))
                   if e["name"].startswith(PREFIX) and lo <= float(e["ts"]) <= hi),
                  key=lambda s: (s[3], s[0], -s[1]))
    parent: List[Optional[int]] = [None] * len(inst)
    by_thread = defaultdict(list)
    stack: List[int] = []
    for i, (s, e, _, th) in enumerate(inst):
        while stack and (inst[stack[-1]][3] != th or inst[stack[-1]][1] <= s):
            stack.pop()
        parent[i] = stack[-1] if stack else None
        stack.append(i)
        by_thread[th].append((s, e, i))

    # each device event of the window to the span open at its launch
    launches = {}
    for e in _complete(events, LAUNCH_CATS):
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            launches[corr] = ((e["pid"], e["tid"]), float(e["ts"]))
    dev = [e for e in _complete(events, DEVICE_CATS)
           if float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo]
    found = [launches.get(e.get("args", {}).get("correlation")) for e in dev]
    pts = [p for p in found if p is not None]
    own = iter(_innermost(by_thread, pts))
    on_main = iter(_innermost(by_thread, [(main, ts) for _, ts in pts]))
    owner = []
    for p in found:
        if p is None:
            owner.append(None)
            continue
        o, m = next(own), next(on_main)
        owner.append(o if o is not None or p[0] == main else m)

    self_dev = [0.0] * len(inst)
    self_k = [0] * len(inst)
    harness_ops: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e, o in zip(dev, owner):
        d = float(e["dur"])
        if o is None:
            harness_ops[e["name"]][0] += d
            harness_ops[e["name"]][1] += 1
        else:
            self_dev[o] += d
            self_k[o] += e.get("cat") == "kernel"
    incl_dev, incl_k = list(self_dev), list(self_k)
    child_host = [0.0] * len(inst)
    for i in range(len(inst) - 1, -1, -1):
        p = parent[i]
        if p is not None:
            incl_dev[p] += incl_dev[i]
            incl_k[p] += incl_k[i]
            child_host[p] += inst[i][1] - inst[i][0]

    by_span: Dict[str, SpanStat] = {}
    top_host = 0.0
    for i, (s, e, name, th) in enumerate(inst):
        st = by_span.setdefault(name, SpanStat())
        st.calls += 1
        st.host_us += e - s
        st.host_self_us += e - s - child_host[i]
        st.device_us += incl_dev[i]
        st.device_self_us += self_dev[i]
        st.kernels += incl_k[i]
        st.kernels_self += self_k[i]
        if parent[i] is None and th == main:
            top_host += e - s

    busy, gaps = union_us([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev],
                          lo, hi)
    gap_by: Dict[str, float] = defaultdict(float)
    for (s, e), o in zip(gaps, _innermost(by_thread, [(main, s) for s, _ in gaps])):
        gap_by[inst[o][2] if o is not None else HARNESS] += e - s
    return Spans(steps, hi - lo, busy, sum(float(e["dur"]) for e in dev), top_host, by_span,
                 dict(gap_by), dict(harness_ops), dict(counters or {}))


def report(s: Spans, out=None) -> None:
    """The pass's tables, a step each, on `out` (standard error by default;
    not part of the result line)."""
    out = out or sys.stderr
    n = max(s.steps, 1)
    print(f"# stackless pass: {s.steps} steps, window {s.window_us / 1e3:.3f} ms, device "
          f"busy {s.busy_us / 1e3:.3f} ms, device events {s.device_us / 1e3:.3f} ms", file=out)
    print(f"# {'span (a step)':<22}{'calls':>8}{'host self':>11}{'host incl':>11}"
          f"{'dev self':>10}{'dev incl':>10}{'k self':>9}{'k incl':>9}  (ms, kernels)", file=out)
    for name, st in sorted(s.by_span.items(), key=lambda kv: -kv[1].device_us):
        print(f"# {name:<22}{st.calls / n:>8.1f}{st.host_self_us / n / 1e3:>11.3f}"
              f"{st.host_us / n / 1e3:>11.3f}{st.device_self_us / n / 1e3:>10.3f}"
              f"{st.device_us / n / 1e3:>10.3f}{st.kernels_self / n:>9.1f}{st.kernels / n:>9.1f}",
              file=out)
    gaps = ", ".join(f"{k} {v / n / 1e3:.3f}" for k, v in
                     sorted(s.gaps.items(), key=lambda kv: -kv[1]))
    print(f"# idle gaps by span (ms a step): {gaps}", file=out)
    in_spans = s.device_us - s.harness_device_us()
    print(f"# device time in pt.* spans: {in_spans / 1e3:.3f} of {s.device_us / 1e3:.3f} ms "
          f"({100.0 * in_spans / max(s.device_us, 1e-9):.3f}%); outside, by name (ms, events): "
          + ", ".join(f"{k[:60]} {us / 1e3:.4f} {c}" for k, (us, c) in
                      sorted(s.harness_ops.items(), key=lambda kv: -kv[1][0])[:8]), file=out)
    print(f"# bounce.live: {s.counters.get('bounce.live')}", file=out)
    print(f"# counters: {json.dumps(s.counters, sort_keys=True)}", file=out)


def program_traces() -> bool:
    """Whether the program under test has the tracing switch and counters."""
    from pim_tpu_torch.core import profiler
    return all(hasattr(profiler, a) for a in ("set_tracing", "reset_counters", "counters"))


def run_pass(drv_run, dev) -> Spans:
    """The stackless pass over the next `trace_steps` steps of a cell's run."""
    import torch

    from pim_tpu_torch.core import profiler
    from pimbench.drivers.common import sync
    from pimbench.trace import remove

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    first = drv_run.trace_steps
    sync(dev)
    profiler.reset_counters()
    profiler.set_tracing(True)
    try:
        with torch.profiler.profile(activities=acts, with_stack=False) as prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                for i in range(first, first + drv_run.trace_steps):
                    drv_run.step(i)
                sync(dev)
        counts = profiler.counters()
    finally:
        profiler.set_tracing(False)
        profiler.reset_counters()
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, f"spans.{os.getpid()}.trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        remove(path)
    return reduce(events, drv_run.trace_steps, counts)


def _harness_run():
    """(the cell's run, device) of the harness's `main` whose per-layer readers
    are on the stack, or None: the harness hands a reader the stack pass's
    Traced alone."""
    f = sys._getframe(1)
    while f is not None:
        code = f.f_code
        if code.co_name == "main" and code.co_filename.endswith(os.path.join("pimbench",
                                                                            "run.py")):
            loc = f.f_locals
            if "run" in loc and "dev" in loc:
                return loc["run"], loc["dev"]
        f = f.f_back
    return None


def of(t) -> Optional[Spans]:
    """The stackless pass of the run that traced `t`, run at the first
    call and kept on `t`; None where the program has no tracing or no
    harness run is on the stack."""
    if not hasattr(t, "spans"):
        t.spans = None
        found = _harness_run()
        if found is not None and program_traces():
            t.spans = run_pass(*found)
            report(t.spans)
    return t.spans


def counter(s: Optional[Spans], name: str) -> int:
    v = 0 if s is None else s.counters.get(name, 0)
    return sum(v) if isinstance(v, list) else int(v)
