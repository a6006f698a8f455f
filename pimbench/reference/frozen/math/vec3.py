"""SoA vector types: V2/V3 as tuples of flat [N] component tensors.

Counterpart of `pim_tpu.math.vec3` (and the constants of `math/vec.py`).
Operators are overloaded for readability: `V3 + V3`, `V3 * scalar`,
`V3 * V3` (componentwise).  Keep the V3 on the left of a binary operator.

Constants are Python floats holding float32 values, so every torch op that
mixes them with float32 tensors computes with the same float32 constant as
the reference.  A product of two constants is formed in float32 with `f32`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def f32(x) -> float:
    """A Python float holding the float32 rounding of x."""
    return float(np.float32(x))


EPS = f32(1e-6)
EPS_SQ = f32(1e-12)
RCP_EPS = f32(1e6)
MILLI = f32(1e-3)
PI = f32(3.14159265358979323846)
TAU = f32(6.28318530717958647692)
LOG2_EPS = f32(-19.931568569324174)
SQRT5_CONJ = f32(0.61803398875)


class V2(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    @staticmethod
    def from_aos(arr: torch.Tensor) -> "V3":
        return V3(arr[..., 0], arr[..., 1], arr[..., 2])

    @staticmethod
    def zeros(n: int, device) -> "V3":
        z = torch.zeros(n, dtype=torch.float32, device=device)
        return V3(z, z, z)

    @staticmethod
    def ones(n: int, device) -> "V3":
        o = torch.ones(n, dtype=torch.float32, device=device)
        return V3(o, o, o)

    def aos(self) -> torch.Tensor:
        return torch.stack([self.x, self.y, self.z], dim=-1)


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def dotsat(a: V3, b: V3):
    return torch.clamp(dot(a, b), 0.0, 1.0)


def length(v: V3):
    return torch.sqrt(torch.clamp_min(dot(v, v), EPS_SQ))


def normalize(v: V3) -> V3:
    return v * torch.rsqrt(torch.clamp_min(dot(v, v), EPS_SQ))


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def reflect(i: V3, n: V3) -> V3:
    return i - n * (2.0 * dot(i, n))


def lerp(a, b, t):
    return a + (b - a) * t


def lerp3(a: V3, b: V3, t) -> V3:
    return a + (b - a) * t


def where3(mask, a: V3, b: V3) -> V3:
    return V3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def avg_lum3(c: V3):
    return (c.x + c.y + c.z) * f32(1.0 / 3.0)


def sqrt0(x):
    """sqrt(max(x, 0)), the same values, with a zero derivative where
    x <= 0: there autograd's 0 * inf through the clamp would give NaN (at
    total internal reflection, for one)."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)),
                       torch.sqrt(torch.clamp_min(x, 0.0)).detach())


def refract(i: V3, n: V3, eta) -> V3:
    """GLSL refract; zeros on total internal reflection."""
    cosi = -dot(i, n)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    out = i * eta + n * (eta * cosi - sqrt0(k))
    zero = torch.zeros_like(cosi)
    return where3(tir, V3(zero, zero, zero), out)
