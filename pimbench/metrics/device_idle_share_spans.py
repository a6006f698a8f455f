"""device_idle_share_spans.<kind>: the share (percent) of the stackless
pass's window in which no kernel, copy or set ran on the card: 1 - the
union of the device events' intervals over the window
(pimbench/spans.py).  Without stacks the host runs nearer its untraced
pace than in the stack pass that `device_idle_share` reads."""

from pimbench import spans


def read(t, kind):
    s = spans.of(t)
    if s is None or s.window_us <= 0.0:
        return None
    return 100.0 * (1.0 - s.busy_us / s.window_us)
