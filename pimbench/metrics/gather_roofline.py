"""gather_roofline.<kind>: the gather launches' share (percent) of their
bound: K3, K6, K7 and the backward passes of K3 and K7.

Bytes (a frozen copy of the port's chip_smoke.py gather arithmetic): the
indices read, the distinct table columns their in-range indices reach
(`touched_bytes`), and the output written; K6 also reads its weights and
valid flags; a backward pass reads the incoming gradient and writes the
distinct columns it adds into.  Over the device time of the kernels
launched from the gather wrappers (`trace.LAYERS`' "gather" group), at the
card's HBM rate."""

import torch

from pimbench.metrics.peaks import HBM_BYTES_PER_S


def touched_bytes(cols, row_bytes: int) -> int:
    """Bytes of the distinct table columns (texels) that in-range indices
    `cols` read: a gather needs those, not the whole table."""
    return int(torch.unique(cols).numel()) * row_bytes


def _in_range(idx, t):
    return idx[(idx >= 0) & (idx < t)]


def call_bytes(kind: str, args) -> int:
    if kind == "K3":                      # (table_t [F, T], idx [N])
        table, idx = args[0], args[1]
        f, t = table.shape
        n = idx.shape[0]
        return n * idx.element_size() + touched_bytes(_in_range(idx, t), f * 4) + f * n * 4
    if kind == "K3-bwd":                  # (g [F, N], idx [N], t)
        g, idx, t = args[0], args[1], int(args[2])
        f, n = g.shape
        return f * n * 4 + n * idx.element_size() + touched_bytes(_in_range(idx, t), f * 4)
    if kind == "K7":                      # (planes [C, T], idx [K, N] clipped)
        planes, idx = args[0], args[1]
        c, t = planes.shape
        m = idx.numel()
        return m * 4 + touched_bytes(idx.clamp(0, t - 1), c * 4) + c * m * 4
    if kind == "K7-bwd":                  # (g [C, K, N], idx [K, N], t)
        g, idx, t = args[0], args[1], int(args[2])
        c = g.shape[0]
        m = idx.numel()
        return c * m * 4 + m * 4 + touched_bytes(idx.clamp(0, t - 1), c * 4)
    if kind == "K6":                      # (corners [4C, T], idx, tx, ty, valid[, c])
        corners, idx, valid = args[0], args[1], args[4]
        c = corners.shape[0] // 4
        t = corners.shape[1]
        m = idx.numel()
        reached = idx[valid].clamp(0, t - 1)
        return m * (4 + 4 + 4 + 1) + touched_bytes(reached, 4 * c * 4) + c * m * 4
    raise ValueError(f"unknown gather {kind!r}")


def read(t, kind):
    secs = t.group_seconds("gather")
    if secs <= 0 or t.calls is None or not t.calls.gathers:
        return None
    total = sum(call_bytes(k, a) for k, a in t.calls.gathers)
    return 100.0 * (total / HBM_BYTES_PER_S) / secs
