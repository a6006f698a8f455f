"""Surface interaction: fused attribute fetch + hit-point shading state.

Counterpart of `pim_tpu.render.surface`, flat-material path.  Every
per-hit attribute comes from ONE K3 fetch of the fused [48, T] triangle
table.  Atlas textures, normal maps and the sky belong to ROADMAP slice 2:
`attribs_from_rows` raises for a scene that has them, so no surface here is
a sky surface.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pim_tpu_torch.math.vec3 import MILLI, V2, V3, dot, f32, normalize, reflect, where3
from pim_tpu_torch.render import fetch as F

K_EMISSION_SCALE = 100.0
_SURFACE_BIAS = f32(f32(0.01) * MILLI)


def _slice2(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP slice 2)")


class Surface(NamedTuple):
    """Per-lane surface description."""

    p: V3
    m: V3          # macro (geometric-interp) normal
    n: V3          # micro (shading) normal
    albedo: V3
    emission: V3
    roughness: torch.Tensor
    occlusion: torch.Tensor
    metallic: torch.Tensor
    ior: torch.Tensor
    backface: torch.Tensor


def fix_shading_normal(m: V3, n: V3) -> V3:
    """Reflect shading normals that dip below the geometric hemisphere."""
    below = dot(m, n) <= 0.0
    return where3(below, reflect(n, m), n)


class HitAttribs(NamedTuple):
    """Everything the shading path needs about a hit, from one fused fetch."""

    rows: torch.Tensor   # [48, N] raw table block
    p: V3                # interpolated position
    m: V3                # interpolated macro normal (side-fixed)
    uv: V2
    albedo: V3
    rome: tuple          # 4 channel tensors [N]
    emission: V3


def fetch_hit_attribs(meta, arrays, hit) -> HitAttribs:
    """Fused fetch + interpolation for a Hit batch."""
    rows = F.fetch_cols(arrays.tri_table, torch.clamp_min(hit.tri, 0))  # [48, N]
    return attribs_from_rows(meta, arrays, rows, hit)


def attribs_from_rows(meta, arrays, rows, hit) -> HitAttribs:
    """Interpolation/shading-state build from an already-fetched [48, N]
    attribute block.  Macro normal = barycentric vertex-normal blend,
    flipped to the side of the geometric normal."""
    if meta.textured:
        raise _slice2("atlas texture sampling")
    if meta.has_normal_maps:
        raise _slice2("normal mapping")
    if meta.has_sky:
        raise _slice2("the sky")
    w = 1.0 - hit.u - hit.v
    u = hit.u
    v = hit.v
    pa = F.v3_rows(rows, F.PA)
    pb = F.v3_rows(rows, F.PB)
    pc = F.v3_rows(rows, F.PC)
    p = pa * w + pb * u + pc * v
    na = F.v3_rows(rows, F.NA)
    nb = F.v3_rows(rows, F.NB)
    nc = F.v3_rows(rows, F.NC)
    n = na * w + nb * u + nc * v
    flip = dot(hit.ng, n) <= 0.0
    m = normalize(where3(flip, -n, n))
    uv = V2(
        rows[F.UVA.start] * w + rows[F.UVB.start] * u + rows[F.UVC.start] * v,
        rows[F.UVA.start + 1] * w + rows[F.UVB.start + 1] * u + rows[F.UVC.start + 1] * v,
    )
    albedo = V3(rows[F.ALBEDO.start], rows[F.ALBEDO.start + 1], rows[F.ALBEDO.start + 2])
    rome = tuple(rows[F.ROME.start + c] for c in range(4))
    e = rome[3]
    emission = albedo * (e * e * K_EMISSION_SCALE)
    return HitAttribs(rows=rows, p=p, m=m, uv=uv, albedo=albedo, rome=rome,
                      emission=emission)


def get_surface(meta, ro: V3, rd: V3, hit, at: HitAttribs) -> Surface:
    """The shading state of an already-fetched hit (flat materials)."""
    return Surface(
        p=at.p + at.m * _SURFACE_BIAS,
        m=at.m,
        n=at.m,
        albedo=at.albedo,
        emission=at.emission,
        roughness=at.rome[0],
        occlusion=at.rome[1],
        metallic=at.rome[2],
        ior=at.rows[F.IOR],
        backface=hit.backface,
    )


def get_emission_from_attribs(meta, arrays, rd: V3, at: HitAttribs) -> V3:
    """Emission-only view of a fetched hit."""
    return at.emission
