"""The wavefront path-tracing integrator (SoA lanes, hit-carried).

Counterpart of `pim_tpu.render.integrator.trace_rays` with media off and
no lane compaction.  The reference's `lax.scan` over bounces is a Python
loop here.  Each bounce starts from an already-traced hit and its fetched
[48, N] attribute block, does NEE with ONE any-hit shadow ray (K2), samples
the BSDF once (the continuation ray, whose emission at the next hit is
MIS-weighted), applies Russian roulette and traces the continuation with
ONE closest-hit call (K1) plus one attribute fetch (K3).

The [48, N] attribute block and the interpolated attributes of the hit a
bounce starts from are the ones fetched at the end of the previous bounce
(the reference re-derives the same values from its scan carry).

Everything stays on the device: the ray count and the image are tensors,
and nothing in the bounce loop synchronises with the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pim_tpu_torch.core import rng
from pim_tpu_torch.math.brdf import BrdfLut
from pim_tpu_torch.math.grid import grid_index_soa
from pim_tpu_torch.math.sampling import light_pdf, power_heuristic
from pim_tpu_torch.math.vec3 import EPS, PI, RCP_EPS, V3, avg_lum3, dot, f32, saturate, where3
from pim_tpu_torch.render import fetch as F
from pim_tpu_torch.render.bsdf import scatter_principled
from pim_tpu_torch.render.lights import (
    light_on_hit,
    light_select_pdf_from_rows,
    make_light_table,
    nee_light_strategy,
)
from pim_tpu_torch.render.scene import LightState, SceneArrays, SceneMeta, scene_intersect
from pim_tpu_torch.render.surface import (
    fetch_hit_attribs,
    get_emission_from_attribs,
    get_surface,
)

_RCP_PI = f32(np.float32(1.0) / np.float32(PI))


class TraceResult(NamedTuple):
    color: torch.Tensor        # [N, 3] radiance
    albedo: torch.Tensor       # [N, 3] AOV
    normal: torch.Tensor       # [N, 3] AOV
    live: torch.Tensor         # [G, E] i64 light-learning histogram delta
    rays_traced: torch.Tensor  # scalar f32 on the device: rays actually cast


def _finish_segment(meta, arrays, ro, rd, hit, at, atten, lum, alive, live, emis_w,
                    is_primary: bool):
    """Shared tail of every traced segment: backface kill, light learning,
    weighted emission.  (Refraction, media and the sky are later slices;
    trace_rays and the surface code raise for a scene that has them.)"""
    alive = alive & (hit.tri >= 0) & ~hit.backface

    emission = get_emission_from_attribs(meta, arrays, rd, at)

    if meta.emissive_count > 0 and not is_primary:
        cell = grid_index_soa(meta.grid_spec(), ro)
        emit = at.rows[F.EMIT_IDX].to(torch.int64)
        live = light_on_hit(meta, live, cell, emit, emission, alive)

    lum = lum + emission * atten * (emis_w * alive.to(torch.float32))
    return atten, lum, alive, live


def trace_rays(meta: SceneMeta, arrays: SceneArrays, lights: LightState, ro: V3, rd: V3,
               state: rng.RngState, max_bounces: int) -> TraceResult:
    """Trace a batch of [N] rays to completion, with Russian roulette."""
    if meta.has_refractive:
        raise NotImplementedError("refraction is not ported yet (ROADMAP slice 2)")
    if meta.media_enabled:
        raise NotImplementedError("participating media are not ported yet (ROADMAP slice 3)")
    n = ro.x.shape[0]
    dev = ro.x.device
    lut = BrdfLut(texels=arrays.brdf_lut)
    g, e_live = lights.live.shape
    e = meta.emissive_count
    light_table = make_light_table(lights, arrays.cell_active_f) if e > 0 else None

    # --- primary segment
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    live = torch.zeros((g, e_live), dtype=torch.int64, device=dev)
    rays = torch.full((), float(n), dtype=torch.float32, device=dev)
    hit = scene_intersect(meta, arrays, ro, rd, 0.0, RCP_EPS)
    at = fetch_hit_attribs(meta, arrays, hit)
    atten, lum, alive, live = _finish_segment(
        meta, arrays, ro, rd, hit, at, V3.ones(n, dev), V3.zeros(n, dev), alive, live,
        1.0, is_primary=True)

    aov_albedo = V3.zeros(n, dev)
    aov_normal = V3.zeros(n, dev)
    aov_weight = torch.zeros((n,), dtype=torch.float32, device=dev)

    for _ in range(max_bounces):
        surf = get_surface(meta, ro, rd, hit, at)
        surf_alive = alive

        # --- NEE: light strategy, one any-hit shadow ray
        state, u_sel = rng.next_f32(state)
        state, (bu, bv) = rng.next_f32x2(state)
        if e > 0:
            li, ls = nee_light_strategy(meta, arrays, light_table, lut, surf, hit.tri, rd,
                                        u_sel, bu, bv, active=surf_alive)
            lum = lum + li * atten * surf_alive.to(torch.float32)
            rays = rays + torch.sum(surf_alive.to(torch.float32))

        # --- continuation = BSDF strategy (its MIS weight is applied to the
        # NEXT hit's emission)
        state, scat = scatter_principled(lut, surf, rd, state)
        cont = surf_alive & (scat.pdf > EPS)
        inv_pdf = 1.0 / torch.clamp_min(scat.pdf, EPS)
        atten = where3(cont, atten * scat.attenuation * inv_pdf, atten)
        ro2 = where3(cont, scat.pos, ro)
        rd2 = where3(cont, scat.dir, rd)
        alive2 = cont

        # --- AOV accumulation
        w = saturate(1.0 - avg_lum3(atten) * _RCP_PI) * cont.to(torch.float32)
        aov_albedo = aov_albedo + surf.albedo * w
        aov_normal = aov_normal + surf.n * w
        aov_weight = aov_weight + w

        # --- Russian roulette before the trace
        state, u_rr = rng.next_f32(state)
        p = saturate(avg_lum3(atten))
        survive = u_rr < p
        scale = torch.where(alive2 & survive, 1.0 / torch.clamp_min(p, EPS), 1.0)
        atten = atten * scale
        alive2 = alive2 & survive

        # --- trace the continuation segment; dead lanes carry t_far = 0
        rays = rays + torch.sum(alive2.to(torch.float32))
        t_far2 = torch.where(alive2, RCP_EPS, 0.0)
        hit2 = scene_intersect(meta, arrays, ro2, rd2, 0.0, t_far2)
        at2 = fetch_hit_attribs(meta, arrays, hit2)

        # MIS weight for emission at the new hit
        if e > 0:
            h_dist_sq = torch.clamp_min(hit2.t * hit2.t, EPS)
            lp_area = light_pdf(at2.rows[F.AREA], torch.abs(dot(rd2, hit2.ng)), h_dist_sq)
            lp2 = lp_area * light_select_pdf_from_rows(
                ls.pdf_rows, ls.id_rows, at2.rows[F.EMIT_IDX].to(torch.int64))
            bp2 = scat.pdf
            ok_b = (bp2 > EPS) & (lp_area > EPS)
            w_mis = power_heuristic(bp2, lp2) * ok_b.to(torch.float32)
        else:
            w_mis = 1.0

        atten, lum, alive, live = _finish_segment(
            meta, arrays, ro2, rd2, hit2, at2, atten, lum, alive2, live, w_mis,
            is_primary=False)
        ro, rd, hit, at = ro2, rd2, hit2, at2

    s = 1.0 / torch.clamp_min(aov_weight, EPS)
    return TraceResult(
        color=lum.aos(),
        albedo=(aov_albedo * s).aos(),
        normal=(aov_normal * s).aos(),
        live=live,
        rays_traced=rays,
    )


# ---------------------------------------------------------------------------
# Progressive accumulation
# ---------------------------------------------------------------------------


class TraceBuffers(NamedTuple):
    """Progressive accumulation state."""

    color: torch.Tensor   # [H*W, 3]
    albedo: torch.Tensor  # [H*W, 3]
    normal: torch.Tensor  # [H*W, 3]


def make_trace_buffers(width: int, height: int, device) -> TraceBuffers:
    z = torch.zeros((width * height, 3), dtype=torch.float32, device=device)
    return TraceBuffers(color=z, albedo=z, normal=z)


def accumulate(buffers: TraceBuffers, result: TraceResult, sample_weight: float) -> TraceBuffers:
    """Progressive EMA: lerp(prev, new, 1/sampleCount)."""
    sw = float(sample_weight)
    return TraceBuffers(
        color=buffers.color + (result.color - buffers.color) * sw,
        albedo=buffers.albedo + (result.albedo - buffers.albedo) * sw,
        normal=buffers.normal + (result.normal - buffers.normal) * sw,
    )


def luminance_stddev(color: torch.Tensor) -> torch.Tensor:
    """pt_stddev convergence metric (sample standard deviation of the
    per-pixel channel mean)."""
    lum = torch.mean(color, dim=-1)
    n = lum.shape[0]
    mean = torch.mean(lum)
    var = torch.sum((lum - mean) ** 2) / (n - 1)
    return torch.sqrt(var)
