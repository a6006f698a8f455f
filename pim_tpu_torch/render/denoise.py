"""AOV-aware denoiser: edge-avoiding a-trous wavelet filtering.

Counterpart of `pim_tpu.render.denoise`, the filter behind `pt_denoise 1`:
an edge-avoiding a-trous wavelet transform (Dammertz et al. 2010) steered by
the albedo and normal AOVs.  Each level takes 25 shifts of the [H, W, C]
planes, each an edge-padded copy sliced back to [H, W] (the reference's
edge handling: a shifted pixel past the border repeats the edge pixel),
with per-pixel edge-stopping weights.  It needs no weights of its own and
stays outside any gradient path.
"""

from __future__ import annotations

from enum import Enum

import torch
import torch.nn.functional as TF


class DenoiseType(Enum):
    Image = 0
    Lightmap = 1


# B3-spline 5-tap weights
_H5 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift [H, W, C] by (dy, dx) with edge-clamp padding."""
    h, w = img.shape[0], img.shape[1]
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    chw = img.permute(2, 0, 1)[None]
    # replicate-pad one axis at a time: each pad stays within what torch's
    # edge padding accepts for any image size
    padded = TF.pad(chw, (px0, px1, 0, 0), mode="replicate") if px0 or px1 else chw
    if py0 or py1:
        padded = TF.pad(padded, (0, 0, py0, py1), mode="replicate")
    return padded[0, :, py1:py1 + h, px1:px1 + w].permute(1, 2, 0)


def _atrous_level(color, albedo, normal, lum_sigma_rcp, step: int, sigma_albedo: float,
                  sigma_normal: float):
    """One a-trous level: the 5x5 dilated B3 kernel with edge-stopping
    weights (luminance, variance-normalised; albedo; normal)."""
    lum_c = torch.mean(color, dim=-1, keepdim=True)
    acc = torch.zeros_like(color)
    wacc = torch.zeros_like(lum_c)
    for iy, hy in enumerate(_H5):
        for ix, hx in enumerate(_H5):
            dy = (iy - 2) * step
            dx = (ix - 2) * step
            c_q = _shift2d(color, dy, dx)
            a_q = _shift2d(albedo, dy, dx)
            n_q = _shift2d(normal, dy, dx)
            dl = torch.abs(torch.mean(c_q, dim=-1, keepdim=True) - lum_c)
            w_l = torch.exp(-dl * lum_sigma_rcp)
            da = torch.sum((a_q - albedo) ** 2, dim=-1, keepdim=True)
            w_a = torch.exp(-da / sigma_albedo)
            ndn = torch.sum(n_q * normal, dim=-1, keepdim=True)
            w_n = torch.clamp_min(ndn, 0.0) ** sigma_normal
            w = (hy * hx) * w_l * w_a * w_n
            acc = acc + c_q * w
            wacc = wacc + w
    return acc / torch.clamp_min(wacc, 1e-8)


def _denoise_hwc(color, albedo, normal, iterations: int = 5, sigma_luminance: float = 4.0,
                 sigma_albedo: float = 0.01, sigma_normal: float = 32.0):
    nrm = normal / torch.sqrt(torch.clamp_min(torch.sum(normal ** 2, dim=-1, keepdim=True),
                                              1e-12))
    # a local (3x3) luminance stddev drives the color sigma, so the filter
    # widens where the Monte-Carlo noise is strong
    lum = torch.mean(color, dim=-1, keepdim=True)
    m1 = torch.zeros_like(lum)
    m2 = torch.zeros_like(lum)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            lq = _shift2d(lum, dy, dx)
            m1 = m1 + lq
            m2 = m2 + lq * lq
    m1 = m1 / 9.0
    m2 = m2 / 9.0
    sigma_c = torch.sqrt(torch.clamp_min(m2 - m1 * m1, 0.0))
    lum_sigma_rcp = 1.0 / (sigma_luminance * torch.clamp_min(sigma_c, 1e-4))
    out = color
    for i in range(iterations):
        out = _atrous_level(out, albedo, nrm, lum_sigma_rcp, 1 << i, sigma_albedo,
                            sigma_normal)
    return out


def denoise(dtype: DenoiseType, width: int, height: int, color: torch.Tensor, albedo=None,
            normal=None, iterations: int = 5) -> torch.Tensor:
    """Denoise a [H*W, 3] (or [H, W, 3]) HDR buffer steered by the albedo and
    normal AOVs; a missing AOV is a neutral plane.  Lightmaps take at
    most 3 levels, so chart borders do not bleed."""
    flat_in = color.ndim == 2
    c = color.reshape(height, width, 3)
    a = albedo.reshape(height, width, 3) if albedo is not None else torch.zeros_like(c)
    if normal is not None:
        n = normal.reshape(height, width, 3)
    else:
        n = torch.zeros_like(c)
        n[..., 2] = 1.0
    if dtype == DenoiseType.Lightmap:
        iterations = min(iterations, 3)
    with torch.no_grad():
        out = _denoise_hwc(c, a, n, iterations=iterations)
    return out.reshape(-1, 3) if flat_in else out
