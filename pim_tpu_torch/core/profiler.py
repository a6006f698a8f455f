"""Intrusive frame profiler and the program's tracing: named marks and
spans, a call tree, mean/variance stats and device counters.

The port's copy of `pim_tpu.core.profiler` (host analog of the reference
profiler, src/common/profiler.c:24-128): static marks per site, begin/end
pairs forming a per-frame call tree, and EMA mean/variance statistics keyed
by (parent-chain, name).  A mark times the host: device work is
asynchronous, and no mark waits for it.

Tracing is one process-wide switch, off by default (`set_tracing`; the
shell's cvar `prof_trace`).  When it is on:
- every mark and every `span(name)` opens a
  `torch.profiler.record_function(name)` range, so that under a profiler
  it lands in the Kineto trace, on the clock of the device events and tied
  to the kernels launched inside it by their correlation ids; a span also
  enters the stats under its parent chain, so the shell's report gives
  its host time;
- `count(name, value)` adds a device tensor (or an int) into an in-memory
  counter without a host sync; `counters()` reads them all back with one.
When it is off, `span` returns one shared no-op context (no range, no
allocation) and `count` does nothing; call sites guard the reduction that
feeds a counter with `tracing()`, so the program launches the same kernels
as it does without the instrumentation.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

_tracing = False
_counters: Dict[str, object] = {}


def set_tracing(on: bool) -> None:
    global _tracing
    _tracing = bool(on)


def tracing() -> bool:
    return _tracing


@dataclass
class ProfStat:
    mean_ms: float = 0.0
    var_ms: float = 0.0
    calls: int = 0

    def update(self, ms: float, alpha: float = 0.1) -> None:
        if self.calls == 0:
            self.mean_ms = ms
        else:
            err = ms - self.mean_ms
            self.mean_ms += err * alpha
            self.var_ms = (1.0 - alpha) * (self.var_ms + alpha * err * err)
        self.calls += 1


class _Off:
    """The shared context of a span while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Mark:
    """One open mark or span: its stats entry and, while tracing, its
    record_function range."""
    __slots__ = ("prof", "name", "ann", "t0")

    def __init__(self, prof: "Profiler", name: str):
        self.prof = prof
        self.name = name

    def __enter__(self):
        self.ann = None
        if _tracing:
            self.ann = torch.profiler.record_function(self.name)
            self.ann.__enter__()
        self.t0 = self.prof.begin(self.name) if self.prof.enabled else None
        return None

    def __exit__(self, *exc):
        if self.t0 is not None:
            self.prof.end(self.name, self.t0)
        if self.ann is not None:
            self.ann.__exit__(None, None, None)
        return False


@dataclass
class Profiler:
    stats: Dict[str, ProfStat] = field(default_factory=dict)
    _stack: List[str] = field(default_factory=list)
    enabled: bool = True

    def begin(self, name: str) -> float:
        self._stack.append(name)
        return time.perf_counter()

    def end(self, name: str, t0: float) -> None:
        ms = (time.perf_counter() - t0) * 1e3
        if self._stack and self._stack[-1] == name:
            self._stack.pop()
        key = "/".join(self._stack + [name]) if self._stack else name
        self.stats.setdefault(key, ProfStat()).update(ms)

    def mark(self, name: str):
        """A frame-level mark: stats while `enabled`, a range while tracing."""
        if not (self.enabled or _tracing):
            return _OFF
        return _Mark(self, name)

    def report(self) -> str:
        lines = [f"{'mark':<40} {'mean ms':>10} {'stddev':>10} {'calls':>8}"]
        for key in sorted(self.stats):
            st = self.stats[key]
            lines.append(
                f"{key:<40} {st.mean_ms:>10.3f} {st.var_ms ** 0.5:>10.3f} {st.calls:>8}"
            )
        counts = counters()
        if counts:
            lines.append(f"{'counter':<40} value")
            lines += [f"{name:<40} {counts[name]}" for name in sorted(counts)]
        return "\n".join(lines)


_profiler = Profiler()


def get_profiler() -> Profiler:
    return _profiler


def profile(name: str):
    """Context manager: `with profile("Pt_Trace"): ...`"""
    return _profiler.mark(name)


def span(name: str):
    """Context manager: a `pt.*` span of the program, a no-op unless tracing."""
    if not _tracing:
        return _OFF
    return _Mark(_profiler, name)


def spanned(name: str):
    """Decorator: every call of the function runs inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _tracing:
                return fn(*args, **kwargs)
            with _Mark(_profiler, name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def _add(a, b):
    """a + b for counters; 1-D tensors of different lengths are padded with
    zeros to the longer one."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and a.shape != b.shape:
        n = max(a.numel(), b.numel())
        a, b = (torch.nn.functional.pad(x.reshape(-1), (0, n - x.numel())) for x in (a, b))
    return a + b


def count(name: str, value) -> None:
    """Add `value` (an int or a tensor, summed on its device) into counter
    `name`; nothing unless tracing."""
    if not _tracing:
        return
    if isinstance(value, torch.Tensor):
        value = value.detach()
    old = _counters.get(name)
    _counters[name] = value if old is None else _add(old, value)


def counters() -> Dict[str, object]:
    """Every counter's value: an int, or a list of ints for a 1-D tensor.
    One host sync a device that holds counters."""
    out = {k: int(v) for k, v in _counters.items() if not isinstance(v, torch.Tensor)}
    by_dev: Dict[torch.device, list] = {}
    for k, v in _counters.items():
        if isinstance(v, torch.Tensor):
            by_dev.setdefault(v.device, []).append((k, v))
    for items in by_dev.values():
        flat = torch.cat([v.reshape(-1).to(torch.int64) for _, v in items]).tolist()
        at = 0
        for k, v in items:
            vals = flat[at:at + v.numel()]
            at += v.numel()
            out[k] = vals[0] if v.dim() == 0 else vals
    return out


def reset_counters() -> None:
    _counters.clear()
