"""live_texel_share.<kind>: the share (percent) of the bake's traced lanes
that belong to a live texel (sample count > 0): 100 * bake.live /
bake.lanes, from the program's counters over the stackless pass
(pimbench/spans.py).  A bake that compacts its lanes raises it."""

from pimbench import spans


def read(t, kind):
    s = spans.of(t)
    lanes = spans.counter(s, "bake.lanes")
    if lanes <= 0:
        return None
    return 100.0 * spans.counter(s, "bake.live") / lanes
