"""sort_ms_per_step.<kind>: device ms a step of the kernels launched
inside the program's `pt.sort` spans (the ray sort before a cluster trace
and the unsort after it), over the stackless pass (pimbench/spans.py).
A scene without the sort (the dense intersector) reads nothing."""

from pimbench import spans


def read(t, kind):
    s = spans.of(t)
    if s is None or "pt.sort" not in s.by_span:
        return None
    return s.by_span["pt.sort"].device_us / s.steps / 1e3
