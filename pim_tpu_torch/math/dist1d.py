"""Batched 1-D piecewise-constant distributions (one row per grid cell).

Counterpart of `pim_tpu.math.dist1d`: `bake` (Dist1D_Bake semantics: zero-
integral rows get a uniform cdf and keep a zero pdf), `update` (the
per-frame fold of the light-learning histogram) and the per-(cell, u)
lookups `sample_discrete`, `pdf_discrete` and `sample_continuous`.

    pdf  [G, N]   float32
    cdf  [G, N+1] float32
    sum  [G]      int64 (the reference's uint32 previous live sum)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pim_tpu_torch.core.rng import MASK32
from pim_tpu_torch.math.vec3 import EPS, f32

_ALPHA = f32(0.9)


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


def sample_discrete(dist: Dist1D, cell: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The bucket index of each (cell, u) pair: the number of cdf entries
    <= u, less one, clamped to [0, N) (FindInterval).  int64 [...]."""
    n = dist.pdf.shape[1]
    idx = torch.sum(dist.cdf[cell] <= u[..., None], dim=-1) - 1
    return torch.clamp(idx, 0, n - 1)


def pdf_discrete(dist: Dist1D, cell: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The probability of bucket idx in cell: pdf[cell, idx] / N."""
    return dist.pdf[cell, idx] / float(dist.pdf.shape[1])


def sample_continuous(dist: Dist1D, cell: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A continuous inverse-cdf sample in [0, 1) of each (cell, u) pair."""
    n = dist.pdf.shape[1]
    idx = sample_discrete(dist, cell, u)
    u0 = dist.cdf[cell, idx]
    u1 = dist.cdf[cell, idx + 1]
    w = u1 - u0
    du = torch.where(w > 0.0, (u - u0) / torch.clamp_min(w, EPS), u - u0)
    return (idx.to(torch.float32) + du) / float(n)


def update(dist: Dist1D, live: torch.Tensor):
    """Fold the live hit histogram into the pdf by a ratio-derived EMA:
    rows with fewer than 30 hits stay as they are; alpha =
    sat(sum / prev_sum * 0.9)^2 (0.5 on the first fold); the live counters
    of the folded rows halve.  `live` holds 32-bit words in int64, and its
    row sums wrap to 32 bits as the reference's uint32 sums do.  Returns
    (new_dist, new_live)."""
    live = live & MASK32
    s = torch.sum(live, dim=-1) & MASK32  # [G]
    active = s >= 30

    s_f = s.to(torch.float32)
    prev_f = dist.sum.to(torch.float32)
    ratio = torch.where(prev_f > 0.0, s_f / torch.clamp_min(prev_f, 1.0), 0.0)
    alpha_ratio = torch.clamp(ratio, 0.0, 1.0) * _ALPHA
    alpha = torch.where(dist.sum > 0, alpha_ratio * alpha_ratio, 0.5)

    scale = 1.0 / torch.clamp_min(s_f, 1.0)
    target = live.to(torch.float32) * scale[:, None]
    new_pdf_active = dist.pdf + (target - dist.pdf) * alpha[:, None]
    new_pdf = torch.where(active[:, None], new_pdf_active, dist.pdf)

    rebaked = bake(new_pdf, prev_sum=torch.where(active, s, dist.sum))
    # inactive rows keep their previous cdf, pdf and integral
    cdf = torch.where(active[:, None], rebaked.cdf, dist.cdf)
    pdf = torch.where(active[:, None], rebaked.pdf, dist.pdf)
    integral = torch.where(active, rebaked.integral, dist.integral)
    new_live = torch.where(active[:, None], live >> 1, live)
    return Dist1D(pdf=pdf, cdf=cdf, integral=integral, sum=rebaked.sum), new_live
