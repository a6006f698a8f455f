"""media_scatter_share.<kind>: the share (percent) of the live lanes
marched through the medium that scattered in it: 100 * media.scattered /
media.lanes, from the program's counters over the stackless pass
(pimbench/spans.py; both counted in `integrator._finish_segment`, a lane
each live segment).  A program without the counters reads nothing."""

from pimbench import spans


def read(t, kind):
    s = spans.of(t)
    lanes = spans.counter(s, "media.lanes")
    if lanes <= 0:
        return None
    return 100.0 * spans.counter(s, "media.scattered") / lanes
