"""Screenshot pipeline: exposure -> GT tonemap -> sRGB -> dither -> PNG.

Counterpart of `pim_tpu.render.screenshot`: the GT tonemap with m = 0.5,
the exact sRGB encode, a 1/255 dither toward a uniform random image whose
words are the reference's (`core/rng.py`), and a vertical flip on write.
The PNG writer and reader are stdlib (zlib, struct).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from pim_tpu_torch.core import rng
from pim_tpu_torch.geom.gltf import decode_png
from pim_tpu_torch.math.color import gt_tonemap, srgb_oetf
from pim_tpu_torch.math.cubic_fit import curve_fit, tmap_eval

_TMAP_FIT_CACHE = {}


def fitted_gt_coeffs(whitepoint: float = 1.0) -> torch.Tensor:
    """A rational-curve (cubic_fit 'tmap') fit of the GT tonemap over
    [0, 4 * whitepoint], fitted once per whitepoint on the CPU and cached."""
    key = round(float(whitepoint), 6)
    if key not in _TMAP_FIT_CACHE:
        xs = torch.linspace(0.0, 4.0 * whitepoint, 256)
        ys = gt_tonemap(xs, P=whitepoint, a=1.0, m=0.5, l=0.4, c=1.33, b=0.0)
        coeffs, err = curve_fit(xs, ys, kind="tmap", iterations=600, population=128, seed=7)
        _TMAP_FIT_CACHE[key] = (coeffs, float(err))
    return _TMAP_FIT_CACHE[key][0]


def tonemap_for_display(light: torch.Tensor, exposure, whitepoint: float = 1.0,
                        use_fit: bool = None) -> torch.Tensor:
    """HDR [N, 3] (or [H, W, 3]) -> display-referred [0, 1] rgb: the GT
    tonemap (P = whitepoint, a = 1, m = 0.5, l = 0.4, c = 1.33, b = 0) and
    the sRGB encode.  use_fit (default: the r_tonemap_fit cvar) swaps in the
    cached rational fit of the tonemap."""
    if use_fit is None:
        from pim_tpu_torch.core.cvars import cv_r_tonemap_fit

        use_fit = bool(cv_r_tonemap_fit.get())
    v = torch.clamp_min(light * exposure, 0.0)
    if use_fit:
        coeffs = fitted_gt_coeffs(whitepoint).to(v.device)
        v = torch.clamp(tmap_eval(v, coeffs), 0.0, whitepoint)
    else:
        v = gt_tonemap(v, P=whitepoint, a=1.0, m=0.5, l=0.4, c=1.33, b=0.0)
    return srgb_oetf(v)


def quantize_dithered(srgb: torch.Tensor, seed: int = 0x5C4EE) -> np.ndarray:
    """[H, W, 3] in [0, 1] -> uint8 [H, W, 3] (numpy) with the 1/255 lerp
    dither toward one random image per (pixel, channel)."""
    h, w = srgb.shape[:2]
    state = rng.make_state(torch.arange(h * w, device=srgb.device), 0, seed=seed)
    _, (nr, ng, nb) = rng.next_f32x3(state)
    noise = torch.stack([nr, ng, nb], dim=-1).reshape(h, w, 3)
    v = srgb + (noise - srgb) * (1.0 / 255.0)
    return torch.clamp(v * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8).cpu().numpy()


def write_png(path: str, rgb8: np.ndarray, flip_vertical: bool = True) -> None:
    """8-bit grey, RGB or RGBA PNG writer (stdlib only)."""
    arr = np.asarray(rgb8, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, axis=-1)
    if flip_vertical:
        arr = arr[::-1]
    h, w = arr.shape[:2]
    color_type = {1: 0, 3: 2, 4: 6}[arr.shape[2]]

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced PNG -> [h, w, channels] uint8."""
    with open(path, "rb") as f:
        return decode_png(f.read())
