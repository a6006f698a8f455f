"""Color science: luminance, sRGB, tonemapping, emission packing, spaces.

Counterpart of `pim_tpu.math.color`.  The scene colorspace is Rec.709
linear, so the SDR <-> scene conversions are the identity; the Rec.2020 and
ACES matrices are there for the other working spaces.  Every function takes
float32 tensors of any shape ([..., 3] where a color is meant); constants
are Python floats, which torch rounds to float32 as the reference's weakly
typed constants are.
"""

from __future__ import annotations

import numpy as np
import torch

from pim_tpu_torch.math.vec3 import EPS, f32, saturate

K_EMISSION_SCALE = 100.0
_THIRD = f32(1.0 / 3.0)


def avg_lum(c: torch.Tensor) -> torch.Tensor:
    """Mean of rgb of [..., 3] colors (the reference's 'average luminance')."""
    return (c[..., 0] + c[..., 1] + c[..., 2]) * _THIRD


def luminance_709(c):
    """Rec.709 relative luminance."""
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def pack_emission(emission):
    """HDR emission -> unorm byte scale."""
    e = saturate(torch.amax(emission[..., :3], dim=-1) * f32(1.0 / K_EMISSION_SCALE))
    return torch.sqrt(e)


def unpack_emission(albedo, e):
    """(albedo, rome.w) -> HDR emission."""
    return albedo * ((e * e) * K_EMISSION_SCALE)[..., None]


# --- transfer functions ----------------------------------------------------


def srgb_oetf(linear):
    """Linear -> sRGB encode."""
    linear = torch.clamp_min(linear, 0.0)
    lo = linear * 12.92
    hi = 1.055 * torch.pow(torch.clamp_min(linear, 1e-7), 1.0 / 2.4) - 0.055
    return torch.where(linear <= 0.0031308, lo, hi)


def srgb_eotf(encoded):
    """sRGB -> linear decode."""
    encoded = torch.clamp_min(encoded, 0.0)
    lo = encoded / 12.92
    hi = torch.pow((encoded + 0.055) / 1.055, 2.4)
    return torch.where(encoded <= 0.04045, lo, hi)


# --- GT tonemap (Gran Turismo) ----------------------------------------------

GT_DEFAULTS = dict(P=1.0, a=1.0, m=0.22, l=0.4, c=1.33, b=0.0)


def gt_tonemap(x, P=1.0, a=1.0, m=0.22, l=0.4, c=1.33, b=0.0):
    """GT tonemap operator, elementwise over any shape."""
    x = torch.clamp_min(x, 1e-7)
    l0 = ((P - m) * l) / a
    s0 = m + l0
    s1 = m + a * l0
    c2 = (a * P) / (P - s1)
    lin = m + a * (x - m)
    toe = m * torch.pow(x / m, c) + b
    shoulder = P - (P - s1) * torch.exp(-(c2 * (x - s0)) / P)
    t = torch.clamp(x / f32(m), 0.0, 1.0)
    w0 = 1.0 - (t * t * (3.0 - 2.0 * t))  # smoothstep(0, m, x)
    w2 = torch.where(x < s0, 0.0, 1.0)
    w1 = 1.0 - w0 - w2
    return toe * w0 + lin * w1 + shoulder * w2


def reinhard(x, wp=4.0):
    """Extended Reinhard with a whitepoint."""
    n = x * (1.0 + x / (wp * wp))
    return n / (1.0 + x)


def aces_fitted(x):
    """Narkowicz ACES fit."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return saturate((x * (a * x + b)) / (x * (c * x + d) + e))


# --- colorspace matrices (rows map rgb to rgb) --------------------------------

_MATRICES = {
    "rec709_to_rec2020": [[0.62740374, 0.32928297, 0.04331309],
                          [0.06909731, 0.91954046, 0.01136230],
                          [0.01639142, 0.08801328, 0.89559555]],
    "rec2020_to_rec709": [[1.66049135, -0.58764112, -0.07284993],
                          [-0.12455052, 1.13289988, -0.00834937],
                          [-0.01815073, -0.10057884, 1.11872911]],
    "rec709_to_ap0": [[0.44510370, 0.38536844, 0.18198957],
                      [0.09173784, 0.83761758, 0.09955067],
                      [0.01810628, 0.11489374, 0.89585471]],
    "ap0_to_rec709": [[2.48728561, -1.09167457, -0.38397157],
                      [-0.27056241, 1.33109200, -0.09295224],
                      [-0.01557129, -0.14864914, 1.13593400]],
    "rec709_to_ap1": [[0.62045252, 0.33653942, 0.04805727],
                      [0.07202560, 0.94427723, 0.01386732],
                      [0.02121311, 0.11278329, 0.89472198]],
    "ap1_to_rec709": [[1.68300891, -0.59011865, -0.08125103],
                      [-0.12802380, 1.10586488, -0.01026359],
                      [-0.02376486, -0.12540756, 1.12088573]],
    "rec2020_to_ap0": [[0.68778974, 0.15671833, 0.16795367],
                       [0.04619727, 0.88501531, 0.09769358],
                       [-0.00050517, 0.02941909, 0.99994063]],
    "ap0_to_rec2020": [[1.47076619, -0.25305325, -0.22231197],
                       [-0.07710528, 1.14687216, -0.09909794],
                       [0.00301148, -0.03386985, 1.00286269]],
    "rec2020_to_ap1": [[0.98746759, 0.01182853, 0.00575322],
                       [0.00173593, 1.02605176, 0.00238259],
                       [0.00493710, 0.02531640, 0.99846458]],
    "ap1_to_rec2020": [[1.01274061, -0.01153201, -0.00580782],
                       [-0.00170165, 0.97468698, -0.00231617],
                       [-0.00496459, -0.02465655, 1.00162518]],
}


def color_matrix(name: str, device=None) -> torch.Tensor:
    """The [3, 3] float32 matrix `name` (e.g. 'rec709_to_rec2020')."""
    return torch.tensor(_MATRICES[name], dtype=torch.float32, device=device)


def apply_matrix(name: str, c: torch.Tensor) -> torch.Tensor:
    """[..., 3] colors through the matrix `name` (rows applied per color)."""
    m = color_matrix(name, c.device)
    return (c[..., None, :] * m).sum(dim=-1)


def rec709_to_rec2020(c):
    return apply_matrix("rec709_to_rec2020", c)


def rec2020_to_rec709(c):
    return apply_matrix("rec2020_to_rec709", c)


def rec709_to_ap0(c):
    return apply_matrix("rec709_to_ap0", c)


def ap0_to_rec709(c):
    return apply_matrix("ap0_to_rec709", c)


def rec709_to_ap1(c):
    return apply_matrix("rec709_to_ap1", c)


def ap1_to_rec709(c):
    return apply_matrix("ap1_to_rec709", c)


def rec2020_to_ap0(c):
    return apply_matrix("rec2020_to_ap0", c)


def ap0_to_rec2020(c):
    return apply_matrix("ap0_to_rec2020", c)


def rec2020_to_ap1(c):
    return apply_matrix("rec2020_to_ap1", c)


def ap1_to_rec2020(c):
    return apply_matrix("ap1_to_rec2020", c)


# the scene working colorspace (the reference's compile-time default)
SCENE_SPACE = "rec709"

_SDR_TO_SCENE = {
    "rec709": lambda c: c,
    "rec2020": rec709_to_rec2020,
    "ap0": rec709_to_ap0,
    "ap1": rec709_to_ap1,
}
_SCENE_TO_SDR = {
    "rec709": lambda c: c,
    "rec2020": rec2020_to_rec709,
    "ap0": ap0_to_rec709,
    "ap1": ap1_to_rec709,
}
_SCENE_TO_HDR = {
    "rec709": rec709_to_rec2020,
    "rec2020": lambda c: c,
    "ap0": ap0_to_rec2020,
    "ap1": ap1_to_rec2020,
}


def color_sdr_to_scene(c, space: str = None):
    """sRGB-primaries linear -> the scene working space."""
    return _SDR_TO_SCENE[space or SCENE_SPACE](c)


def color_scene_to_sdr(c, space: str = None):
    """The scene working space -> Rec709-primaries linear."""
    return _SCENE_TO_SDR[space or SCENE_SPACE](c)


def color_scene_to_hdr(c, space: str = None):
    """The scene working space -> Rec2020-primaries linear (HDR10's space)."""
    return _SCENE_TO_HDR[space or SCENE_SPACE](c)


# --- Rec.2100 HDR transfer functions ----------------------------------------


def g_rec709(e):
    """Rec709 camera OETF scaled for the PQ OOTF: scene linear -> signal."""
    e = torch.clamp_min(e, 0.0)
    a = e * 267.84
    b = torch.pow(torch.clamp_min(e * 59.5208, 1e-12), 0.45) * 1.099 - 0.099
    return torch.where(e <= 0.0003024, a, b)


def g_rec1886(ep):
    """Rec1886 reference display EOTF: signal -> display linear light."""
    return torch.pow(torch.clamp_min(ep, 0.0), 2.4) * 100.0


def pq_ootf(e):
    """Scene linear -> display luminance in [0, 10000] cd/m^2."""
    return g_rec1886(g_rec709(e))


# SMPTE ST.2084 constants
_PQ_C1 = 0.8359375
_PQ_C2 = 18.8515625
_PQ_C3 = 18.6875
_PQ_M1 = 0.15930175781
_PQ_M2 = 78.84375


def pq_eotf(ep):
    """Signal [0, 1] -> display luminance [0, 10000] cd/m^2."""
    t = torch.pow(torch.clamp_min(ep, 0.0), 1.0 / _PQ_M2)
    y = torch.clamp_min(t - _PQ_C1, 0.0) / (_PQ_C2 - t * _PQ_C3)
    return torch.pow(y, 1.0 / _PQ_M1) * 10000.0


def pq_inverse_eotf(fd):
    """Display luminance [0, 10000] -> signal [0, 1]."""
    y = torch.pow(torch.clamp_min(fd, 0.0) * (1.0 / 10000.0), _PQ_M1)
    return torch.pow((y * _PQ_C2 + _PQ_C1) / (y * _PQ_C3 + 1.0), _PQ_M2)


def pq_oetf(e):
    """Scene linear -> PQ signal."""
    return pq_inverse_eotf(pq_ootf(e))


def pq_oetf_fit(e):
    """Rational fit of the PQ OETF."""
    b, c, d = 1.187727332, 3.204350948, 0.026951289
    ee, f, g, h = 0.006190614, 1.839250684, 2.521239042, 0.015978092
    e2 = e * e
    e3 = e2 * e
    return (b * e + c * e2 + d * e3) / (ee + f * e + g * e2 + h * e3)


def hlg_oetf(l):
    """Hybrid log-gamma: display luminance [0, 1] -> signal [0, 1]."""
    a = 0.17883277
    b = 1.0 - 4.0 * a
    # float32, as the reference forms it
    c = f32(np.float32(0.5) - np.float32(a) * np.log(np.float32(4.0 * a)))
    l = torch.clamp_min(l, 0.0)
    lo = torch.sqrt(3.0 * l)
    hi = a * torch.log(torch.clamp_min(12.0 * l - b, 1e-12)) + c
    return torch.where(l <= 1.0 / 12.0, lo, hi)


def hlg_ootf(s, peak_nits=1000.0):
    """HLG system gamma: scene luminance -> display luminance at a peak."""
    ys = s[..., 0] * 0.2627 + s[..., 1] * 0.6780 + s[..., 2] * 0.0593
    g = np.float32(1.2) + np.float32(0.42) * np.log10(np.float32(peak_nits / 1000.0))
    return peak_nits * torch.pow(torch.clamp_min(ys, EPS), f32(g - np.float32(1.0)))[..., None] * s


# --- dithering (the screenshot path) -----------------------------------------


def dither_u8(x, noise):
    """x in [0, 1], noise in [0, 1): dither, then quantize to uint8."""
    q = x * 255.0 + (noise - 0.5)
    return torch.clamp(torch.round(q), 0.0, 255.0).to(torch.uint8)
