"""device_idle_share.<kind>: the share of the traced window (percent) in
which no kernel, copy or set ran on the card: 1 - the union of the device
events' intervals over the window, both from one trace."""


def read(t, kind):
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
