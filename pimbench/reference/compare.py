"""The comparisons that decide `correct`, on the reference's terms."""

from __future__ import annotations

import torch

# A value is off when it differs from the reference's by more than
# RTOL of the reference's magnitude plus ATOL_SCALE of the mean magnitude
# of the compared set (a floor for values near 0).
RTOL = 1e-3
ATOL_SCALE = 1e-4


def rows_off(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """[P] bool: the rows of prog [P, C] with a value off the reference's
    (a non-finite value is off)."""
    prog = prog.to(torch.float64)
    ref = ref.to(torch.float64)
    atol = ATOL_SCALE * float(ref.abs().mean()) if ref.numel() else 0.0
    off = ~((prog - ref).abs() <= RTOL * ref.abs() + atol)
    return off.any(dim=1)


def share_off(pairs) -> float:
    """The share of rows off over [(prog, ref)] pairs."""
    off = [rows_off(p, r) for p, r in pairs]
    n = sum(int(o.numel()) for o in off)
    return float(sum(int(o.sum()) for o in off)) / max(n, 1)


def max_rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |prog - ref| over the largest |ref| (1 where either is
    not finite)."""
    prog = prog.to(torch.float64)
    ref = ref.to(torch.float64)
    if not (torch.isfinite(prog).all() and torch.isfinite(ref).all()):
        return 1.0
    scale = max(float(ref.abs().max()), 1e-30)
    return float((prog - ref).abs().max()) / scale


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 and back (the control's lower precision)."""
    return x.to(torch.bfloat16).to(x.dtype) if x.is_floating_point() else x
