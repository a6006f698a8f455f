"""The measured window: steps queued with no host sync between them, a
CUDA event after each, and one sync at the close.

At most DEPTH steps are in flight: before step i is queued the host waits
for the event of step i - DEPTH.  Where the host sets the pace (every
render step here) that wait returns at once; where the device does, it
keeps the queue, and so the window, from running far past its length.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List

import torch

DEPTH = 2


@dataclass
class Window:
    steps: int
    wall_s: float               # host clock from the first queued step to the closing sync
    intervals_ms: List[float]   # device clock between consecutive step-completion events


class _HostEvent:
    """A CPU run's stand-in for a CUDA event (the CPU tests): the host clock."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def run(step: Callable[[int], None], seconds: float, device) -> Window:
    """Queue step(0), step(1), ... until `seconds` of host time have
    passed, then synchronise.  Every step is counted: the window is all
    the work queued and all the time until it completed."""
    cuda = device.type == "cuda"
    event = (lambda: torch.cuda.Event(enable_timing=True)) if cuda else _HostEvent
    if cuda:
        torch.cuda.synchronize(device)
    opened = event()
    events = []
    opened.record()
    t0 = time.perf_counter()
    i = 0
    while True:
        if i >= DEPTH:
            events[i - DEPTH].synchronize()
        step(i)
        ev = event()
        ev.record()
        events.append(ev)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    marks = [opened] + events
    return Window(i, wall, [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])])
