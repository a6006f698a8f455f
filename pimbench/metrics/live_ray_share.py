"""live_ray_share.<kind>: the share (percent) of the lanes passed to the
intersector that are live (t_far > 0), closest hit and any hit together:
100 * (isect.live + shadow.live) / (isect.lanes + shadow.lanes), from the
program's counters over the stackless pass (pimbench/spans.py)."""

from pimbench import spans


def read(t, kind):
    s = spans.of(t)
    lanes = spans.counter(s, "isect.lanes") + spans.counter(s, "shadow.lanes")
    if lanes <= 0:
        return None
    return 100.0 * (spans.counter(s, "isect.live") + spans.counter(s, "shadow.live")) / lanes
