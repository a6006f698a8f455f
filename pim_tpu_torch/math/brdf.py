"""Physically-based BRDF building blocks (GGX / Smith / Schlick / Burley).

Counterpart of `pim_tpu.math.brdf`: the eval functions, the split-sum BRDF
LUT bake and its bilinear fetch.  Colors are SoA V3; scalars flat [N].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pim_tpu_torch.math.vec3 import EPS, EPS_SQ, PI, V3, f32, lerp, saturate

K_MIN_DENOM = f32(1.0 / (1 << 10))
K_MIN_ALPHA = K_MIN_DENOM
_F90_SCALE = f32(50.0 * 0.33)


def brdf_alpha(roughness):
    """Perceptual roughness -> alpha."""
    return torch.clamp_min(roughness * roughness, K_MIN_ALPHA)


def f_0(albedo: V3, metallic) -> V3:
    """Reflectance at normal incidence."""
    return V3(
        lerp(0.04, albedo.x, metallic),
        lerp(0.04, albedo.y, metallic),
        lerp(0.04, albedo.z, metallic),
    )


def f_90(f0: V3):
    """Grazing reflectance."""
    return saturate(_F90_SCALE * (f0.x + f0.y + f0.z))


def f_schlick1(f0, f90, cos_theta):
    t = 1.0 - cos_theta
    t5 = t * t * t * t * t
    return lerp(f0, f90, t5)


def f_dielectric(cos_theta_i, eta_i: float, eta_t: float):
    """Exact dielectric fresnel with TIR (eta_i, eta_t: float32 constants).
    Negative cos theta = transmission side (etas swap)."""
    cos_theta_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    trans = cos_theta_i < 0.0
    cos_i = torch.abs(cos_theta_i)
    ei = torch.where(trans, eta_t, eta_i)
    et = torch.where(trans, eta_i, eta_t)
    sin_i = torch.sqrt(torch.clamp_min(1.0 - cos_i * cos_i, EPS_SQ))
    sin_t = (ei / et) * sin_i
    tir = sin_t >= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin_t * sin_t, EPS_SQ))
    r_parl = ((et * cos_i) - (ei * cos_t)) / torch.clamp_min((et * cos_i) + (ei * cos_t), EPS)
    r_perp = ((ei * cos_i) - (et * cos_t)) / torch.clamp_min((ei * cos_i) + (et * cos_t), EPS)
    f = saturate((r_parl * r_parl + r_perp * r_perp) * 0.5)
    return torch.where(tir, 1.0, f)


def d_gtr(noh, alpha):
    """GGX Trowbridge-Reitz NDF."""
    a2 = alpha * alpha
    f = lerp(1.0, a2, noh * noh)
    f = f * f * PI
    return a2 / torch.clamp_min(f, EPS)


def v_smith_correlated(nol, nov, alpha):
    """Height-correlated Smith visibility."""
    a2 = alpha * alpha
    v = nol * torch.sqrt(torch.clamp_min(a2 + (nov - nov * a2) * nov, EPS_SQ))
    l = nov * torch.sqrt(torch.clamp_min(a2 + (nol - nol * a2) * nol, EPS_SQ))
    return 0.5 / torch.clamp_min(v + l, EPS)


def fd_burley(nol, nov, hov, roughness):
    """Disney diffuse."""
    fd90 = 0.5 + 2.0 * hov * hov * roughness
    light_scatter = f_schlick1(1.0, fd90, nol)
    view_scatter = f_schlick1(1.0, fd90, nov)
    return (light_scatter * view_scatter) / PI


# ---------------------------------------------------------------------------
# Split-sum BRDF LUT (GGX energy compensation)
# ---------------------------------------------------------------------------


class BrdfLut(NamedTuple):
    # texels[..., 0] = integral of Fc*D*V*NoL (dielectric fresnel weighted)
    # texels[..., 1] = integral of D*V*NoL
    texels: torch.Tensor  # [size, size, 2] over (NoV, alpha)


def bake_brdf_lut(size: int = 16, num_samples: int = 4096, device="cpu") -> BrdfLut:
    """Bake the split-sum LUT: texel i sits at coordinate i/(size-1).

    All size*size texels integrate in one [size, size, S] batch (NoV on the
    first axis, alpha on the second); each texel sums its S Hammersley
    samples along the last axis."""
    from pim_tpu_torch.math.sampling import hammersley_2d, sample_ggx_microfacet

    coord = torch.arange(size, dtype=torch.float32, device=device) / f32(size - 1)
    nov = torch.clamp(coord, EPS, f32(1.0 - EPS))[:, None, None]     # [S, 1, 1]
    alpha = torch.clamp(coord, K_MIN_ALPHA, 1.0)[None, :, None]     # [1, S, 1]
    i = torch.arange(num_samples, dtype=torch.int64, device=device)
    hu, hv = hammersley_2d(i, num_samples)
    m = sample_ggx_microfacet(hu[None, None, :], hv[None, None, :], alpha)
    vx = torch.sqrt(torch.clamp_min(1.0 - nov * nov, 0.0))
    vm = vx * m.x + nov * m.z              # dot(V, m) with V = (vx, 0, nov)
    nol = 2.0 * vm * m.z - nov             # L = reflect(-V, m)
    noh = saturate(m.z)
    voh = vm
    valid = nol > EPS
    g = v_smith_correlated(torch.clamp_min(nol, 0.0), torch.clamp_min(nov, EPS), alpha)
    g_vis = torch.where(valid, (g * voh * nol * 4.0) / torch.clamp_min(noh, EPS), 0.0)
    fc = f_dielectric(voh, f32(1.000293), f32(1.52))
    n = f32(num_samples)
    texels = torch.stack([torch.sum(fc * g_vis, dim=-1) / n,
                          torch.sum(g_vis, dim=-1) / n], dim=-1)
    return BrdfLut(texels=texels)  # [nov, alpha, 2]


def brdf_lut_sample(lut: BrdfLut, nov, alpha):
    """Bilinear clamped fetch at (NoV, alpha); returns (dvf, dv) [N].

    A direct 4-tap bilinear.  The tap weights are the reference's tents
    max(0, 1 - |i - x|) at the two neighbouring texels, and the taps are
    summed in the reference's order (along NoV first, then alpha), so the
    result equals its tent contraction."""
    size = lut.texels.shape[0]
    x = torch.clamp(nov, 0.0, 1.0) * f32(size - 1)
    y = torch.clamp(alpha, 0.0, 1.0) * f32(size - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = torch.clamp_max(x0 + 1.0, float(size - 1))
    y1 = torch.clamp_max(y0 + 1.0, float(size - 1))

    def tent(i, c):
        return torch.clamp_min(1.0 - torch.abs(i - c), 0.0)

    wx0, wx1 = tent(x0, x), tent(x0 + 1.0, x)
    wy0, wy1 = tent(y0, y), tent(y0 + 1.0, y)
    ix0, ix1 = x0.to(torch.int64), x1.to(torch.int64)
    iy0, iy1 = y0.to(torch.int64), y1.to(torch.int64)
    flat = lut.texels.reshape(size * size, 2)

    def row(iy):  # [N, 2]: taps along NoV at alpha row iy
        return flat[ix0 * size + iy] * wx0[:, None] + flat[ix1 * size + iy] * wx1[:, None]

    out = row(iy0) * wy0[:, None] + row(iy1) * wy1[:, None]
    return out[:, 0], out[:, 1]


def ggx_energy_compensation(lut: BrdfLut, f0: V3, nov, alpha) -> V3:
    """Multi-scatter energy compensation."""
    _, dv = brdf_lut_sample(lut, nov, alpha)
    t = (1.0 / torch.clamp_min(dv, EPS)) - 1.0
    return V3(f0.x * t + 1.0, f0.y * t + 1.0, f0.z * t + 1.0)


def env_brdf(lut: BrdfLut, f0: V3, nov, alpha) -> V3:
    """Pre-integrated environment BRDF."""
    dvf, dv = brdf_lut_sample(lut, nov, alpha)
    return V3(
        (1.0 - f0.x) * dvf + f0.x * dv,
        (1.0 - f0.y) * dvf + f0.y * dv,
        (1.0 - f0.z) * dvf + f0.z * dv,
    )



_SIGMA_C = tuple(f32(c) for c in (5.969, 0.215, 2.532, 10.73, 5.574, 0.245))


def sigma_a_from_reflectance(albedo: V3, beta_n) -> V3:
    """Chiang et al. absorption from a reflectance color."""
    c0, c1, c2, c3, c4, c5 = _SIGMA_C
    r2 = beta_n * beta_n
    r3 = r2 * beta_n
    r4 = r3 * beta_n
    r5 = r4 * beta_n
    t = torch.clamp_min(c0 - c1 * beta_n + c2 * r2 - c3 * r3 + c4 * r4 + c5 * r5, EPS)

    def chan(a):
        s = torch.log(torch.clamp_min(a, EPS)) / t
        return s * s

    return V3(chan(albedo.x), chan(albedo.y), chan(albedo.z))


def albedo_to_transmittance(albedo: V3, roughness, thickness) -> V3:
    """Beer-Lambert interior transmittance."""
    sig = sigma_a_from_reflectance(albedo, roughness)
    return V3(torch.exp(-sig.x * thickness), torch.exp(-sig.y * thickness),
              torch.exp(-sig.z * thickness))
