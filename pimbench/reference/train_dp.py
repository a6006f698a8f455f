"""The reference of the train-4chip traffic (`pimbench.drivers.train_dp`).

The deployment's plain semantics is one device on the whole batch: the
ranks' averaged gradient is the whole batch's mean gradient, and their
replicated Adam step is the one-card step.  So rank 0's state is held to
the train traffic's reference (`reference.train.check`: the frozen
one-card Adam step, its losses, first gradients, updates, the window's
last step and the light grid, at the train traffic's limits, unchanged).

Added (`rank_gap`): the largest |p_r - p_0| over the ranks r and the
parameter groups, over the group's largest |p_0|, after the window.  Its
limit is 0: every rank receives the one result of each all-reduce and
Adam is elementwise, so the ranks hold the same bits.
"""

from __future__ import annotations

import math

import torch


def rank_gap(first, others) -> float:
    """max over ranks and groups of max |p_r - p_0| / max |p_0| (`first`:
    rank 0's groups; `others`: each other rank's); inf where a value is not
    finite."""
    gap = 0.0
    for params in others:
        for a, b in zip(first, params):
            a = a.detach().to("cpu", torch.float64)
            b = b.detach().to("cpu", torch.float64)
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                return math.inf
            scale = max(float(a.abs().max()), 1e-30) if a.numel() else 1.0
            d = float((b - a).abs().max()) if a.numel() else 0.0
            gap = max(gap, d / scale)
    return gap
