"""Batched 1-D piecewise-constant distributions (one row per grid cell).

Counterpart of `pim_tpu.math.dist1d.bake` (Dist1D_Bake semantics: zero-
integral rows get a uniform cdf and keep a zero pdf).  `update` is not on
the Cornell frame's path and is not ported yet.

    pdf  [G, N]   float32
    cdf  [G, N+1] float32
    sum  [G]      int64 (the reference's uint32 previous live sum)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pim_tpu_torch.math.vec3 import f32


class Dist1D(NamedTuple):
    pdf: torch.Tensor       # [G, N]
    cdf: torch.Tensor       # [G, N+1]
    integral: torch.Tensor  # [G]
    sum: torch.Tensor       # [G] int64


def cumsum_seq(x: torch.Tensor) -> torch.Tensor:
    """Prefix sum along the last axis, accumulated strictly left to right.

    The reference's float32 prefix sums and row sums over these short rows
    (E emissives, K <= 32 lights) run in this order; torch.cumsum and
    torch.sum associate differently and can differ in the last bit."""
    acc = x[..., 0]
    out = [acc]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
        out.append(acc)
    return torch.stack(out, dim=-1)


def bake(pdf: torch.Tensor, prev_sum=None) -> Dist1D:
    """Build the cdf from (unnormalized) pdf rows; normalizes the pdf."""
    g, n = pdf.shape
    rcp_len = f32(1.0 / n)
    csum = cumsum_seq(pdf * rcp_len)
    cdf = torch.cat([torch.zeros((g, 1), dtype=pdf.dtype, device=pdf.device), csum], dim=-1)
    integral = cdf[:, -1]
    zero = integral == 0.0
    uniform = torch.arange(n + 1, dtype=pdf.dtype, device=pdf.device)[None, :] * rcp_len
    safe_integral = torch.where(zero, 1.0, integral)
    cdf = torch.where(zero[:, None], uniform, cdf / safe_integral[:, None])
    pdf = torch.where(zero[:, None], pdf, pdf / safe_integral[:, None])
    if prev_sum is None:
        prev_sum = torch.zeros((g,), dtype=torch.int64, device=pdf.device)
    return Dist1D(pdf=pdf, cdf=cdf, integral=integral, sum=prev_sum)
