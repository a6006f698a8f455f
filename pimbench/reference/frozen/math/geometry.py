"""Geometry math: signed-distance fields, ray intersections, AABBs, frusta
and areas.

Counterpart of `pim_tpu.math.geometry`: torch ops, broadcastable over
leading batch dims (points are V3 of [...] tensors).  The light-grid bake
uses `sd_triangle`; the rest completes the module.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pimbench.reference.frozen.math.vec3 import V3, cross, dot

PI = 3.14159265358979


# ---------------------------------------------------------------------------
# Signed distance fields
# ---------------------------------------------------------------------------


class Plane3D(NamedTuple):
    """n.x*x + n.y*y + n.z*z + d = 0."""

    n: V3
    d: torch.Tensor


def sd_triangle(a: V3, b: V3, c: V3, pt: V3):
    """Unsigned distance to a 3D triangle."""
    ba = b - a
    cb = c - b
    ac = a - c
    nor = cross(ba, ac)

    pa = pt - a
    pb = pt - b
    pc = pt - c

    s = (torch.sign(dot(cross(ba, nor), pa))
         + torch.sign(dot(cross(cb, nor), pb))
         + torch.sign(dot(cross(ac, nor), pc)))

    def edge_d(e: V3, p: V3):
        h = torch.clamp(dot(e, p) / torch.clamp_min(dot(e, e), 1e-20), 0.0, 1.0)
        q = p - e * h
        return dot(q, q)

    d_edge = torch.minimum(edge_d(ba, pa), torch.minimum(edge_d(cb, pb), edge_d(ac, pc)))
    nor_pa = dot(nor, pa)
    d_face = (nor_pa * nor_pa) / torch.clamp_min(dot(nor, nor), 1e-20)
    return torch.sqrt(torch.where(s < 2.0, d_edge, d_face))


# ---------------------------------------------------------------------------
# Ray intersections
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# AABB ops
# ---------------------------------------------------------------------------


class Box3D(NamedTuple):
    lo: V3
    hi: V3

    @property
    def center(self) -> V3:
        return (self.lo + self.hi) * 0.5

    @property
    def extents(self) -> V3:
        return (self.hi - self.lo) * 0.5


# ---------------------------------------------------------------------------
# Frustum: 6-plane SDF culling
# ---------------------------------------------------------------------------


class Frustum(NamedTuple):
    """Six outward planes, x0/x1/y0/y1/z0/z1."""

    n: V3             # [6] stacked plane normals (component tensors of [6])
    d: torch.Tensor   # [6]


# ---------------------------------------------------------------------------
# Areas
# ---------------------------------------------------------------------------


