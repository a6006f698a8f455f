"""Intrusive frame profiler: named marks, call tree, mean/variance stats.

The port's copy of `pim_tpu.core.profiler` (host analog of the reference
profiler, src/common/profiler.c:24-128): static marks per site, begin/end
pairs forming a per-frame call tree, and EMA mean/variance statistics keyed
by (parent-chain, name).  Device work is asynchronous, so
`profile(name, block_on=device)` synchronises that CUDA device before
the mark ends, to get true wall time; marks can also open
`torch.profiler.record_function` ranges for a trace.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List

import torch


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


def _synchronize(block_on) -> None:
    """Wait for the work queued on the device `block_on` (a torch.device
    or a device string).  CPU work is synchronous already."""
    dev = torch.device(block_on)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclass
class Profiler:
    stats: Dict[str, ProfStat] = field(default_factory=dict)
    _stack: List[str] = field(default_factory=list)
    enabled: bool = True
    use_annotations: bool = False

    def begin(self, name: str) -> float:
        self._stack.append(name)
        return time.perf_counter()

    def end(self, name: str, t0: float) -> None:
        ms = (time.perf_counter() - t0) * 1e3
        if self._stack and self._stack[-1] == name:
            self._stack.pop()
        key = "/".join(self._stack + [name]) if self._stack else name
        self.stats.setdefault(key, ProfStat()).update(ms)

    @contextmanager
    def mark(self, name: str, block_on=None):
        if not self.enabled:
            yield
            return
        ann = None
        if self.use_annotations:
            ann = torch.profiler.record_function(name)
            ann.__enter__()
        t0 = self.begin(name)
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.end(name, t0)
            if ann is not None:
                ann.__exit__(None, None, None)

    def report(self) -> str:
        lines = [f"{'mark':<40} {'mean ms':>10} {'stddev':>10} {'calls':>8}"]
        for key in sorted(self.stats):
            st = self.stats[key]
            lines.append(
                f"{key:<40} {st.mean_ms:>10.3f} {st.var_ms ** 0.5:>10.3f} {st.calls:>8}"
            )
        return "\n".join(lines)


_profiler = Profiler()


def get_profiler() -> Profiler:
    return _profiler


def profile(name: str, block_on=None):
    """Context manager: `with profile("Pt_Trace", block_on=device): ...`"""
    return _profiler.mark(name, block_on=block_on)
