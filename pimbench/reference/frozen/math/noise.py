"""Gradient noise and fBm for the heterogeneous media density (SoA).

Counterpart of `pim_tpu.math.noise`: hash-gradient lattice noise with
smoothstep interpolation, summed over octaves.  The cell hash is the first
word of pcg4d, computed on 32-bit words carried in int64 with the products
split as `core/rng.py::mul32` does, so it matches the reference bit for bit.
"""

from __future__ import annotations

import torch

from pimbench.reference.frozen.core.rng import MASK32, add32, mul32
from pimbench.reference.frozen.math.vec3 import V3, f32, lerp

_MUL = 1664525
_ADD = 1013904223


def _pcg4_x(x, y, z, w):
    """The first word of pcg4d of four 32-bit words."""
    x = add32(mul32(x, _MUL), _ADD)
    y = add32(mul32(y, _MUL), _ADD)
    z = add32(mul32(z, _MUL), _ADD)
    w = add32(mul32(w, _MUL), _ADD)
    x = add32(x, mul32(y, w))
    y = add32(y, mul32(z, x))
    z = add32(z, mul32(x, y))
    w = add32(w, mul32(y, z))
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    return add32(x, mul32(y, w))


def _gradient_cell(ix, iy, iz, seed: int):
    """Signed unit-corner gradient (gx, gy, gz) from the cell hash."""
    w = torch.full_like(ix, int(seed) & MASK32)
    i = _pcg4_x(ix & MASK32, iy & MASK32, iz & MASK32, w)
    one = torch.ones((), dtype=torch.float32, device=ix.device)
    gx = torch.where((i & (1 << 31)) != 0, one, -one)
    gy = torch.where((i & (1 << 30)) != 0, one, -one)
    gz = torch.where((i & (1 << 29)) != 0, one, -one)
    return gx, gy, gz


def _smoothstep(t):
    return t * t * (3.0 - 2.0 * t)


def gradient_noise3(p: V3, seed: int) -> torch.Tensor:
    """Lattice gradient noise of [N] points."""
    fx = torch.floor(p.x)
    fy = torch.floor(p.y)
    fz = torch.floor(p.z)
    ix = fx.to(torch.int32).to(torch.int64)
    iy = fy.to(torch.int32).to(torch.int64)
    iz = fz.to(torch.int32).to(torch.int64)
    rx = p.x - fx
    ry = p.y - fy
    rz = p.z - fz

    def corner(ox, oy, oz):
        gx, gy, gz = _gradient_cell(ix + ox, iy + oy, iz + oz, seed)
        return gx * (rx - ox) + gy * (ry - oy) + gz * (rz - oz)

    c000 = corner(0, 0, 0)
    c001 = corner(0, 0, 1)
    c010 = corner(0, 1, 0)
    c011 = corner(0, 1, 1)
    c100 = corner(1, 0, 0)
    c101 = corner(1, 0, 1)
    c110 = corner(1, 1, 0)
    c111 = corner(1, 1, 1)

    ux, uy, uz = _smoothstep(rx), _smoothstep(ry), _smoothstep(rz)
    c00 = lerp(c000, c001, uz)
    c01 = lerp(c010, c011, uz)
    c10 = lerp(c100, c101, uz)
    c11 = lerp(c110, c111, uz)
    c0 = lerp(c00, c01, uy)
    c1 = lerp(c10, c11, uy)
    return lerp(c0, c1, ux)


def fbm_gradient_noise3(p: V3, lacunarity: float, gain: float, octaves: int,
                        seed: int = 1) -> torch.Tensor:
    """Octave-summed gradient noise; lacunarity and gain are float32
    constants, and each octave's frequency and amplitude are rounded to
    float32 as the reference's are."""
    total = torch.zeros_like(p.x)
    freq = 1.0
    ampl = 1.0
    for i in range(octaves):
        total = total + gradient_noise3(p * freq, seed + i + 1) * ampl
        freq = f32(freq * lacunarity)
        ampl = f32(ampl * gain)
    return total


