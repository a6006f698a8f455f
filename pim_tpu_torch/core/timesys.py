"""Frame timing: frame counter, delta time, EMA-smoothed delta.

Equivalent of the reference time system (src/common/time.c:34-43).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class TimeSys:
    app_start: float = field(default_factory=time.perf_counter)
    frame_start: float = 0.0
    prev_frame: float = 0.0
    frame_count: int = 0
    delta: float = 0.0
    smooth_delta: float = 0.0

    def update(self) -> None:
        now = time.perf_counter()
        self.prev_frame = self.frame_start or now
        self.frame_start = now
        self.frame_count += 1
        self.delta = self.frame_start - self.prev_frame
        # EMA smoothing like Time_Deltaf (src/common/time.c:34-43)
        alpha = 1.0 / 120.0
        self.smooth_delta += (self.delta - self.smooth_delta) * alpha

    def now(self) -> float:
        return time.perf_counter() - self.app_start


_timesys = TimeSys()


def get_timesys() -> TimeSys:
    return _timesys
