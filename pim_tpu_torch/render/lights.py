"""Next-event estimation over the adaptive light grid.

Counterpart of `pim_tpu.render.lights`: full MIS with a shared
continuation ray, so NEE costs one any-hit shadow ray (K2 or K5) per bounce.  The
light-grid state is fetched as ONE fused [3K+2, G] table gather (K3) and
the sampled light's vertices come from the compact [24, E] emissive table
(K3).  Textured lights are sampled at the light point through K6 (K7 on
the differentiable path), sky lights take the sky radiance toward the light
point (K6 with C = 3, or K7).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pim_tpu_torch.core.profiler import spanned
from pim_tpu_torch.math.dist1d import cumsum_seq
from pim_tpu_torch.math.grid import grid_index_soa
from pim_tpu_torch.math.sampling import light_pdf, power_heuristic, sample_bary_coord
from pim_tpu_torch.geom.material import MatFlag
from pim_tpu_torch.math.color import K_EMISSION_SCALE
from pim_tpu_torch.math.vec3 import (
    EPS, LOG2_EPS, V2, V3, avg_lum3, cross, dot, f32, normalize, where3,
)
from pim_tpu_torch.render import fetch as F
from pim_tpu_torch.render.bsdf import eval_principled
from pim_tpu_torch.render.scene import SceneArrays, SceneMeta, scene_occluded
from pim_tpu_torch.render.sky import sky_radiance
from pim_tpu_torch.render.surface import Surface, is_sky, sample_atlas_bilinear_multi

# Per-cell compacted light list size (the K highest-pdf lights of a cell,
# renormalized; a light outside the top K has select pdf 0, and the BSDF
# strategy then carries its full contribution).
LIGHT_TOP_K = 32
_SHADOW_SCALE = f32(1.0 - 1e-3)
_LIVE_SCALE = 255.0 / 46.0
_REFRACTIVE = int(MatFlag.REFRACTIVE)


def light_k(e: int) -> int:
    return min(e, LIGHT_TOP_K)


def make_light_table(lights, cell_active_f) -> torch.Tensor:
    """Fuse the per-cell light-selection state into one [3K+2, G] table:
    rows [0 : K+1] cdf, [K+1 : 2K+1] discrete pdf, [2K+1 : 3K+1] emissive
    ids (f32-exact ints), [3K+1] active flag.

    The top K per cell come from a STABLE descending sort, so equal pdfs
    keep the lower index first, as `jax.lax.top_k` orders them (the Cornell
    rows are full of ties; another order picks another light for the same
    u)."""
    e = lights.pdf.shape[1]
    k = light_k(e)
    vals, ids = torch.sort(lights.pdf, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :k], ids[:, :k]
    total = cumsum_seq(vals)[:, -1:]
    q = vals / torch.clamp_min(total, EPS)             # zero rows stay zero
    g = q.shape[0]
    cdf = torch.cat(
        [torch.zeros((g, 1), dtype=q.dtype, device=q.device), cumsum_seq(q)], dim=-1
    )
    return torch.cat(
        [cdf.T, q.T, ids.to(torch.float32).T, cell_active_f], dim=0
    ).contiguous()


class LightSelection(NamedTuple):
    emit: torch.Tensor        # [N] i64 selected emissive index
    select_pdf: torch.Tensor  # [N] discrete selection pdf
    ok: torch.Tensor          # [N] bool
    pdf_rows: torch.Tensor    # [K, N] the cell's compacted discrete pdfs
    id_rows: torch.Tensor     # [K, N] i64 the cell's compacted emissive ids
    active: torch.Tensor      # [N] bool cell-active flags


def light_select(meta: SceneMeta, light_table: torch.Tensor, position: V3, u) -> LightSelection:
    """Pick an emissive triangle from the position's cell distribution."""
    k = light_k(meta.emissive_count)
    cell = grid_index_soa(meta.grid_spec(), position)
    rows = F.fetch_cols(light_table, cell)               # [3K+2, N]
    cdf_rows = rows[0 : k + 1]
    pdf_rows = rows[k + 1 : 2 * k + 1]
    id_rows = rows[2 * k + 1 : 3 * k + 1].to(torch.int64)
    active = rows[3 * k + 1] > 0.5
    slot = torch.sum((cdf_rows <= u[None, :]).to(torch.int64), dim=0) - 1
    slot = torch.clamp(slot, 0, k - 1)
    pdf = torch.gather(pdf_rows, 0, slot[None, :])[0]
    emit = torch.gather(id_rows, 0, slot[None, :])[0]
    ok = active & (pdf > EPS)
    return LightSelection(emit=emit, select_pdf=pdf, ok=ok,
                          pdf_rows=pdf_rows, id_rows=id_rows, active=active)


def light_select_pdf_from_rows(pdf_rows, id_rows, emit_of_hit):
    """Probability that light_select would pick the hit's emissive from the
    same cell: 1 when the hit is not emissive, else the cell's compacted
    pdf, WHICH MAY BE ZERO (then the BSDF strategy carries full weight)."""
    valid = emit_of_hit >= 0
    match = id_rows == torch.clamp_min(emit_of_hit, 0)[None, :]
    pdf = torch.sum(torch.where(match, pdf_rows, 0.0), dim=0)
    return torch.where(valid, pdf, 1.0)


def light_on_hit(meta: SceneMeta, live: torch.Tensor, cell, emit, emission: V3, active):
    """Accumulate the light-learning histogram, in place into `live`
    ([G, E] int64, contiguous, owned by the caller's trace).

    Lanes that add nothing add 0 to their own (cell, clamped emit) bin.
    Sent to one bin, as the reference does, their ~N adds all contend for
    one address: through `index_put_` that took ~23 ms a call at 512^2 on
    an H100, most of the frame's device time."""
    lum = avg_lum3(emission)
    loglum = torch.log2(torch.clamp_min(lum, EPS)) - LOG2_EPS
    loglum = torch.clamp(loglum, 0.0, 46.0)
    amt = (loglum * _LIVE_SCALE + 0.5).to(torch.int64)
    ok = active & (emit >= 0) & (lum > EPS)
    flat = cell * live.shape[1] + torch.clamp_min(emit, 0)
    live.view(-1).scatter_add_(0, flat, torch.where(ok, amt, 0))
    return live


# Compact emissive-table layout (SceneArrays.emissive_table, [24, E]),
# built on the host in scene.build_emissive_table:
E_PA = slice(0, 3)
E_PB = slice(3, 6)
E_PC = slice(6, 9)
E_AREA = 9
E_TRI = 10
E_ALBEDO = slice(11, 14)  # flat albedo rgb (valid when E_ALBEDO_TEX < 0)
E_UVA = slice(14, 16)
E_UVB = slice(16, 18)
E_UVC = slice(18, 20)
E_ALBEDO_TEX = 20
E_ROME_TEX = 21
E_FLAGS = 22
E_EMIT_A = 23             # flat emission alpha (valid when E_ROME_TEX < 0)
E_ROWS = 24


class LightSample(NamedTuple):
    """A sampled point on a selected emissive triangle."""

    dir: V3                  # unit direction from the shading point
    dist: torch.Tensor       # [N]
    emission: V3             # radiance toward the shading point
    lp: torch.Tensor         # [N] full light-strategy pdf (area x select)
    tri: torch.Tensor        # [N] i32 source triangle id of the light
    ok: torch.Tensor         # [N] bool
    pdf_rows: torch.Tensor   # [K, N] compacted discrete pdfs
    id_rows: torch.Tensor    # [K, N] i64 compacted emissive ids
    active: torch.Tensor     # [N] bool


def sample_light(meta: SceneMeta, arrays: SceneArrays, light_table, p: V3,
                 u_sel, bu, bv, active=None) -> LightSample:
    """Light selection + barycentric point sample + emission evaluation.

    active: optional [N] bool, the lanes whose NEE result is consumed; the
    textured-light and sky-light fetches give 0 on the others (the caller's
    `ok` gates drop them)."""
    sel = light_select(meta, light_table, p, u_sel)
    rows = F.fetch_cols(arrays.emissive_table, sel.emit)  # [24, N]
    a = F.v3_rows(rows, E_PA)
    b = F.v3_rows(rows, E_PB)
    c = F.v3_rows(rows, E_PC)
    area = rows[E_AREA]
    tri = rows[E_TRI].to(torch.int32)
    w_, wu, wv = sample_bary_coord(bu, bv)
    target = a * w_ + b * wu + c * wv
    delta = target - p
    dist_sq = torch.clamp_min(dot(delta, delta), 1e-12)
    dist = torch.sqrt(dist_sq)
    rd = delta * (1.0 / dist)

    # the emission at the sampled point, textured as the BSDF strategy sees it
    albedo = V3(rows[E_ALBEDO.start], rows[E_ALBEDO.start + 1], rows[E_ALBEDO.start + 2])
    emit_a = rows[E_EMIT_A]
    if meta.textured:
        a_tex = rows[E_ALBEDO_TEX].to(torch.int32)
        r_tex = rows[E_ROME_TEX].to(torch.int32)
        uv = V2(
            rows[E_UVA.start] * w_ + rows[E_UVB.start] * wu + rows[E_UVC.start] * wv,
            rows[E_UVA.start + 1] * w_ + rows[E_UVB.start + 1] * wu + rows[E_UVC.start + 1] * wv,
        )
        alb, rom = sample_atlas_bilinear_multi(
            arrays.atlas_planes, arrays.tex_rec_t,
            [(a_tex, uv, (0, 0, 0, 0)), (r_tex, uv, (0, 0, 0, 0))],
            atlas_corners=None if meta.differentiable else arrays.atlas_corners, active=active)
        albedo = where3(a_tex >= 0, V3(alb[0], alb[1], alb[2]), albedo)
        emit_a = torch.where(r_tex >= 0, rom[3], emit_a)
    emission = albedo * (emit_a * emit_a * K_EMISSION_SCALE)
    if meta.has_sky:
        sky = is_sky(rows[E_FLAGS].to(torch.int32))
        emission = where3(sky, sky_radiance(meta, arrays, rd,
                                            sky if active is None else sky & active), emission)

    ng = normalize(cross(b - a, c - a))
    cos_theta = torch.abs(dot(rd, ng))
    lp = light_pdf(area, cos_theta, dist_sq) * sel.select_pdf
    return LightSample(
        dir=rd, dist=dist, emission=emission, lp=lp, tri=tri,
        ok=sel.ok, pdf_rows=sel.pdf_rows, id_rows=sel.id_rows,
        active=sel.active,
    )


@spanned("pt.nee")
def nee_light_strategy(meta: SceneMeta, arrays: SceneArrays, light_table, lut,
                       surf: Surface, src_tri, i_dir: V3, u_sel, bu, bv, active=None,
                       transmittance_fn=None):
    """Light-strategy half of the MIS estimator: sample a light point,
    trace ONE any-hit shadow ray (K2 or K5), weight by the power heuristic
    against the BSDF pdf.  Inactive lanes get t_far = 0 (dead for the
    kernel).  Refractive surfaces take no NEE.  transmittance_fn(p, dir,
    dist) -> V3, given when media are on, scales the radiance by the
    medium's transmittance along the shadow ray.

    Returns (radiance V3, LightSample); radiance is zero where invalid."""
    ls = sample_light(meta, arrays, light_table, surf.p, u_sel, bu, bv, active=active)

    # shadow ray: the target sits ON the light tri at t == dist, so clip
    # t_far a relative epsilon short of it
    t_far = ls.dist * _SHADOW_SCALE
    if active is not None:
        t_far = torch.where(active, t_far, 0.0)
    blocked = scene_occluded(meta, arrays, surf.p, ls.dir, 0.0, t_far)

    brdf_a, bp = eval_principled(lut, surf, i_dir, ls.dir)
    w = power_heuristic(ls.lp, bp) / torch.clamp_min(ls.lp, EPS)
    refractive = (surf.flags & _REFRACTIVE) != 0
    ok = (ls.ok & ~blocked & (src_tri != ls.tri) & (ls.lp > EPS) & (bp > EPS)
          & ~refractive)
    radiance = ls.emission * brdf_a * (w * ok.to(torch.float32))
    if transmittance_fn is not None:
        radiance = radiance * transmittance_fn(surf.p, ls.dir, ls.dist)
    return radiance, ls
