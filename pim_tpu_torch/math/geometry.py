"""Geometry math: the triangle distance field used by the light-grid bake.

Counterpart of `pim_tpu.math.geometry.sd_triangle`; broadcastable over
leading batch dims.
"""

from __future__ import annotations

import torch

from pim_tpu_torch.math.vec3 import V3, cross, dot


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
