"""isect_roofline.<kind>: the intersection launches' share (percent) of
their bound.

The bound counts only what every intersector must move, so that the dense,
cluster, brute and bvh backends are held to the same work: each live ray's
origin and direction (6 floats) and t range (2 floats) read once, and its
hit written once (t and triangle for a closest hit, one flag for an any
hit), at the card's HBM rate.  A ray is live where its t_far is above 0; a
dead ray needs nothing.  No operation count: that would differ by backend.
The time is the device time of the kernels launched from the intersection
wrappers (`trace.LAYERS`' "isect" group)."""

import torch

from pimbench.metrics.peaks import HBM_BYTES_PER_S

RAY_IN_BYTES = 8 * 4
HIT_BYTES = {"closest": 8, "any": 4}


def live_rays(n: int, t_far) -> int:
    """Rays of a call with t_far > 0 (t_far a tensor or one number)."""
    if not torch.is_tensor(t_far):
        return n if float(t_far) > 0.0 else 0
    return int((t_far.expand(n) > 0.0).sum())


def call_bytes(kind: str, n: int, t_far) -> int:
    return live_rays(n, t_far) * (RAY_IN_BYTES + HIT_BYTES[kind])


def read(t, kind):
    secs = t.group_seconds("isect")
    if secs <= 0 or t.calls is None or not t.calls.rays:
        return None
    total = sum(call_bytes(k, n, tf) for k, n, tf in t.calls.rays)
    return 100.0 * (total / HBM_BYTES_PER_S) / secs
