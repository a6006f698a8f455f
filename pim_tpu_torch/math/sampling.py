"""Monte-Carlo sampling library over flat [N] float32 tensors.

Counterpart of `pim_tpu.math.sampling`: every public function of it (the
importance samplers and `hg_phase` have no caller on the port's paths).  2D random variables are (u, v) tuples of [N] tensors; directions
are V3.  Constant expressions are formed in float32 (`f32`) so they round
as the reference's float32 constants do.
"""

from __future__ import annotations

import numpy as np
import torch

from pim_tpu_torch.core.rng import MASK32
from pim_tpu_torch.math.vec3 import (
    EPS,
    EPS_SQ,
    PI,
    SQRT5_CONJ,
    TAU,
    V3,
    f32,
    reflect,
    sqrt0,
)

_PI_4 = f32(np.float32(PI) / np.float32(4.0))
_PI_2 = f32(np.float32(PI) / np.float32(2.0))
_RCP_PI = f32(np.float32(1.0) / np.float32(PI))
_RCP_2_32 = f32(2.3283064365386963e-10)
_DISK_SPAN = f32((np.float32(1.0) - np.float32(EPS)) - np.float32(EPS))


def normal_to_tbn(n: V3):
    """Orthonormal basis from unit normal (Duff et al.). Returns (t, b)."""
    s = torch.where(n.z < 0.0, -1.0, 1.0)
    a = -1.0 / (s + n.z)
    b = n.x * n.y * a
    t_vec = V3(1.0 + s * n.x * n.x * a, s * b, -s * n.x)
    b_vec = V3(b, s + n.y * n.y * a, -n.y)
    return t_vec, b_vec


def tbn_to_world(n: V3, v_ts: V3) -> V3:
    t, b = normal_to_tbn(n)
    return t * v_ts.x + b * v_ts.y + n * v_ts.z


def tan_to_world(normal_ws: V3, normal_ts: V3) -> V3:
    return tbn_to_world(normal_ws, normal_ts)


def radical_inverse_base2(bits: torch.Tensor) -> torch.Tensor:
    """Bit-reversed 32-bit word scaled to [0, 1); words carried in int64."""
    bits = bits.to(torch.int64) & MASK32
    bits = ((bits << 16) | (bits >> 16)) & MASK32
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    return bits.to(torch.float32) * _RCP_2_32


def hammersley_2d(i: torch.Tensor, n: int):
    """Stratified 2D sequence. Returns (u, v)."""
    return (
        (i.to(torch.float32) + 0.5) / f32(n),
        radical_inverse_base2(i),
    )


def power_heuristic(f, g):
    """MIS power heuristic."""
    return (f * f) / torch.clamp_min(f * f + g * g, EPS)


def map_square_to_disk(u, v):
    """Concentric square->disk. Returns (x, y)."""
    u = EPS + _DISK_SPAN * u  # lerp(EPS, 1 - EPS, u) with float32 constants
    v = EPS + _DISK_SPAN * v
    a = 2.0 * u - 1.0
    b = 2.0 * v - 1.0
    use_a = (a * a) > (b * b)
    r = torch.where(use_a, a, b)
    safe_a = torch.where(torch.abs(a) > 0, a, 1.0)
    safe_b = torch.where(torch.abs(b) > 0, b, 1.0)
    phi = torch.where(
        use_a,
        _PI_4 * (b / safe_a),
        _PI_2 - _PI_4 * (a / safe_b),
    )
    return r * torch.cos(phi), r * torch.sin(phi)


def sample_bary_coord(u, v):
    """Uniform barycentric sample. Returns (w, u, v) weights for (A, B, C)."""
    r1 = torch.sqrt(torch.clamp_min(u, EPS_SQ))
    bu = r1 * (1.0 - v)
    bv = v * r1
    return 1.0 - (bu + bv), bu, bv


def sample_ngon(u, v, side, n: int, rot: float):
    """Uniform point in a regular N-gon fan triangle. Returns (x, y)."""
    side = (side.to(torch.int64) & MASK32) % n
    r = f32(np.float32(TAU) / np.float32(n))
    fs = side.to(torch.float32)
    a = rot + (1.0 + fs) * r
    b = rot + (2.0 + fs) * r
    _, wu, wv = sample_bary_coord(u, v)
    return (
        torch.cos(a) * wu + torch.cos(b) * wv,
        torch.sin(a) * wu + torch.sin(b) * wv,
    )


_PENTA_R = f32(np.float32(TAU) / np.float32(5.0))
_PENTA_S = f32(np.float32(PI) * np.float32(0.1))
_PENTA_Q = f32((np.float32(1.0) - np.float32(SQRT5_CONJ)) * np.float32(0.5))


def sample_pentagram(u, v, side):
    """Uniform point in a pentagram star. Returns (x, y)."""
    side = (side.to(torch.int64) & MASK32) % 5
    fs = side.to(torch.float32)
    a = _PENTA_S + (1.0 + fs) * _PENTA_R
    b = _PENTA_S + (1.5 + fs) * _PENTA_R
    c = _PENTA_S + (2.0 + fs) * _PENTA_R
    ax, ay = _PENTA_Q * torch.cos(a), _PENTA_Q * torch.sin(a)
    bx, by = torch.cos(b), torch.sin(b)
    cx, cy = _PENTA_Q * torch.cos(c), _PENTA_Q * torch.sin(c)
    return (
        ax * (1 - u) * (1 - v) + bx * u * (1 - v) + cx * u * v,
        ay * (1 - u) * (1 - v) + by * u * (1 - v) + cy * u * v,
    )


def spherical_to_cartesian(cos_theta, phi) -> V3:
    """(cos theta, phi) -> unit vector with N = +Z."""
    sin_theta = sqrt0(1.0 - cos_theta * cos_theta)
    return V3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta)


def sample_unit_sphere(u, v) -> V3:
    """Uniform sphere."""
    return spherical_to_cartesian(v * 2.0 - 1.0, TAU * u)


def sample_unit_hemisphere(u, v) -> V3:
    """Uniform hemisphere, N = +Z."""
    return spherical_to_cartesian(v, TAU * u)


def sample_cosine_hemisphere(u, v) -> V3:
    """Cosine-weighted hemisphere, N = +Z."""
    dx, dy = map_square_to_disk(u, v)
    z = torch.sqrt(torch.clamp_min(1.0 - (dx * dx + dy * dy), EPS_SQ))
    return V3(dx, dy, z)


def sample_ggx_microfacet(u, v, alpha) -> V3:
    """GGX NDF half-vector in tangent space."""
    a2 = alpha * alpha
    phi = TAU * u
    b = torch.clamp_min(1.0 + (a2 - 1.0) * v, EPS)
    cos_theta = torch.sqrt(torch.clamp_min((1.0 - v) / b, EPS_SQ))
    return spherical_to_cartesian(cos_theta, phi)


def importance_sample_ggx(i: V3, n: V3, u, v, alpha) -> V3:
    """A GGX-sampled reflection of `i` about normal `n`."""
    m = tan_to_world(n, sample_ggx_microfacet(u, v, alpha))
    return reflect(i, m)


def importance_sample_lambert(n: V3, u, v) -> V3:
    """A cosine-weighted direction about normal `n`."""
    return tan_to_world(n, sample_cosine_hemisphere(u, v))


def lambert_pdf(nol):
    return nol * _RCP_PI


def ggx_pdf(noh, hov, alpha):
    """pdf of a GGX-sampled reflection direction."""
    from pim_tpu_torch.math.brdf import d_gtr

    d = d_gtr(noh, alpha)
    return (d * noh) / torch.clamp_min(4.0 * hov, EPS)


def light_pdf(area, cos_theta, dist_sq):
    """Solid-angle pdf of an area light sample."""
    return dist_sq / torch.clamp_min(cos_theta * area, EPS)


def sample_gauss_pixel_filter(u, v, stddev: float = 1.0):
    """AA jitter (Rayleigh-style gauss inverse cdf). Returns (x, y)."""
    angle = u * TAU
    radius = stddev * torch.sqrt(-torch.log(torch.clamp_min(1.0 - v, EPS)))
    return torch.cos(angle) * radius, torch.sin(angle) * radius


def sample_free_path(xi, mfp):
    """Exponential free-path sample; mfp a float32 constant or tensor."""
    return -torch.log(torch.clamp_min(1.0 - xi, EPS)) * mfp


_MIE_K = f32(np.float32(3.0) / (np.float32(8.0) * np.float32(PI)))
_RAYLEIGH_K = f32(np.float32(3.0) / (np.float32(16.0) * np.float32(PI)))


def mie_constants(g: float):
    """`mie_phase`'s float32 constants (k, 1 + g^2, 2 g) for a float32 g."""
    g = np.float32(g)
    k = f32(np.float32(_MIE_K) * (np.float32(1.0) - g * g) / (np.float32(2.0) + g * g))
    return k, f32(1.0 + g * g), f32(2.0 * g)


def mie_phase(cos_theta, g: float):
    """Mie phase function (Cornette-Shanks); g a float32 constant."""
    k, a, b = mie_constants(g)
    l = a - b * cos_theta
    l = l * torch.sqrt(torch.clamp_min(l, EPS_SQ))
    return k * (1.0 + cos_theta * cos_theta) / torch.clamp_min(l, EPS)


def rayleigh_phase(cos_theta):
    """Rayleigh phase function."""
    return _RAYLEIGH_K * (1.0 + cos_theta * cos_theta)


_4PI = f32(np.float32(4.0) * np.float32(PI))


def hg_phase(cos_theta, g):
    """Henyey-Greenstein phase function; g a tensor or a float32 constant."""
    g2 = g * g
    denom = 1.0 + g2 + 2.0 * g * cos_theta
    denom = denom * torch.sqrt(torch.clamp_min(denom, EPS_SQ))
    return (1.0 - g2) / torch.clamp_min(_4PI * denom, EPS)


def importance_sample_hg_phase(u, v, g) -> V3:
    """A Henyey-Greenstein scattering direction about +Z; g a tensor or a
    float32 constant (|g| <= 1e-3 samples the sphere uniformly)."""
    g = torch.as_tensor(g, dtype=torch.float32, device=u.device)
    aniso = torch.abs(g) > 1e-3
    g_safe = torch.where(aniso, g, f32(1e-3))
    a = -1.0 / (2.0 * g_safe)
    b = 1.0 + g_safe * g_safe
    c = (1.0 - g_safe * g_safe) / torch.clamp_min(1.0 + g_safe - 2.0 * g_safe * u, EPS)
    cos_aniso = torch.clamp(a * (b - c * c), -1.0, 1.0)
    cos_iso = u * 2.0 - 1.0
    return spherical_to_cartesian(torch.where(aniso, cos_aniso, cos_iso), TAU * v)
