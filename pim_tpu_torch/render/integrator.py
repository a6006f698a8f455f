"""The wavefront path-tracing integrator (SoA lanes, hit-carried).

Counterpart of `pim_tpu.render.integrator.trace_rays` without lane
compaction.  The reference's `lax.scan` over bounces is a Python loop
here.  Each bounce starts from an already-traced hit and its fetched
[48, N] attribute block, does NEE with ONE any-hit shadow ray (K2 or K5),
samples the BSDF once (the continuation ray, whose emission at the next hit
is MIS-weighted), applies Russian roulette and traces the continuation with
ONE closest-hit call (K1 or K4) plus one attribute fetch (K3) and, in a
textured scene, one atlas fetch (K6).  Refractive surfaces add a masked
closest-hit probe for their interior thickness; misses and sky surfaces
take the sky radiance (K6).

With media on (`SceneMeta.media_enabled`), every traced segment is marched
for a null-scattering event through the scene's medium (`SceneMeta.media`;
render/media.py, on the card the kernels of csrc/media.cu).  A lane that
scatters takes an in-media NEE sample (one more any-hit call a segment, K2
or K5, on the scattered lanes only) and continues from the scatter point in
a phase-sampled direction; it skips the next bounce's surface work
(`media_skip`).  Surface NEE then carries the medium's ratio-tracked
transmittance along its shadow ray.

The attributes of the hit a bounce starts from (its [48, N] block, the
atlas samples) and the sky radiance along its ray are the ones fetched at
the end of the previous bounce; the reference carries the same values in
its scan carry.

Everything stays on the device: the ray count and the image are tensors,
and nothing in the bounce loop synchronises with the host.  Nothing in it
writes in place into a tensor that needs a gradient, so the differentiable
path (`SceneMeta.differentiable`, render/diff.py) runs through it under
autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pim_tpu_torch.core import profiler as prof
from pim_tpu_torch.core import rng
from pim_tpu_torch.geom.material import MatFlag
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
    sample_light,
)
from pim_tpu_torch.render.media import calc_transmittance, make_media_desc, scatter_ray
from pim_tpu_torch.render.scene import (
    LightState,
    SceneArrays,
    SceneMeta,
    intersect_raw,
    scene_intersect,
    scene_occluded,
)
from pim_tpu_torch.render.sky import sky_radiance
from pim_tpu_torch.render.surface import (
    fetch_hit_attribs,
    get_emission_from_attribs,
    get_surface,
    is_sky,
)

_RCP_PI = f32(np.float32(1.0) / np.float32(PI))
_REFRACTIVE = int(MatFlag.REFRACTIVE)
_SHADOW_SCALE = f32(1.0 - 1e-3)


class TraceResult(NamedTuple):
    color: torch.Tensor        # [N, 3] radiance
    albedo: torch.Tensor       # [N, 3] AOV
    normal: torch.Tensor       # [N, 3] AOV
    live: torch.Tensor         # [G, E] i64 light-learning histogram delta
    rays_traced: torch.Tensor  # scalar f32 on the device: rays actually cast


def _evaluate_light(meta, arrays, light_table, media_desc, state, p: V3, active):
    """In-media NEE: select a light from the grid, sample a point on it and
    test its visibility with one any-hit ray (K2 or K5); the sampled
    luminance carries the medium's transmittance along the shadow ray.
    Every lane draws its RNG words; only the `active` lanes (those that
    scattered) trace, the others get t_far = 0 and their result is dropped
    by the caller's weight.  Returns (state, lum V3, dir V3, ok)."""
    state, u_sel = rng.next_f32(state)
    state, (bu, bv) = rng.next_f32x2(state)
    ls = sample_light(meta, arrays, light_table, p, u_sel, bu, bv, active=active)
    t_far = torch.where(active, ls.dist * _SHADOW_SCALE, 0.0)
    blocked = scene_occluded(meta, arrays, p, ls.dir, 0.0, t_far)
    ok = ls.ok & ~blocked & (ls.lp > EPS)
    lum = ls.emission * (1.0 / torch.clamp_min(ls.lp, EPS))
    # the lanes whose transmittance counts, for the counters alone
    used = ok & active if prof.tracing() else None
    state, tr = calc_transmittance(media_desc, state, p, ls.dir, ls.dist, active=used)
    return state, lum * tr, ls.dir, ok


@prof.spanned("pt.segment")
def _finish_segment(meta, arrays, light_table, media_desc, state, ro, rd, hit, at, atten,
                    lum, alive, live, emis_w, is_primary: bool):
    """Shared tail of every traced segment: sky on a miss, the media scatter
    along the segment, backface kill (refractive surfaces are entered from
    behind), light learning, weighted emission, sky-surface termination.

    Returns (state, ro, rd, atten, lum, alive, media_scattered, live, sky):
    a lane that scattered in the medium continues from the scatter point
    (`ro`, `rd`), and `sky` is the sky radiance along the segment's `rd`,
    which the next bounce's surface reuses (scattered lanes take no surface
    work there)."""
    n = ro.x.shape[0]
    missed = hit.tri < 0
    sky_surf = is_sky(at.flags)
    sky = sky_radiance(meta, arrays, rd, active=alive & (missed | sky_surf))
    if meta.has_sky:
        lum = lum + atten * sky * (alive & missed).to(torch.float32)

    media_scattered = torch.zeros((n,), dtype=torch.bool, device=ro.x.device)
    if meta.media_enabled:
        ray_len = torch.where(missed, RCP_EPS, hit.t)

        def eval_light_in_media(st, p, scattered):
            return _evaluate_light(meta, arrays, light_table, media_desc, st, p,
                                   scattered & alive)

        state, ms = scatter_ray(media_desc, state, ro, rd, ray_len,
                                evaluate_light=eval_light_in_media
                                if meta.emissive_count > 0 else None, active=alive)
        media_scattered = alive & ms.scattered
        lum = lum + atten * ms.luminance * media_scattered.to(torch.float32)
        inv_mpdf = 1.0 / torch.clamp_min(ms.pdf, EPS)
        atten = where3(media_scattered, atten * ms.attenuation * inv_mpdf,
                       where3(alive, atten * ms.attenuation, atten))
        ro = where3(media_scattered, ms.pos, ro)
        rd = where3(media_scattered, ms.dir, rd)

    refr_hit = (at.flags & _REFRACTIVE) != 0
    alive = alive & (media_scattered | (~missed & ~(hit.backface & ~refr_hit)))
    surf_alive = alive & ~media_scattered

    emission = get_emission_from_attribs(meta, at, sky_col=sky)

    if meta.emissive_count > 0 and not is_primary:
        cell = grid_index_soa(meta.grid_spec(), ro)
        emit = at.rows[F.EMIT_IDX].to(torch.int64)
        live = light_on_hit(meta, live, cell, emit, emission, surf_alive)

    lum = lum + emission * atten * (emis_w * surf_alive.to(torch.float32))
    if meta.has_sky:
        alive = alive & (media_scattered | ~sky_surf)
    return state, ro, rd, atten, lum, alive, media_scattered, live, sky


def trace_rays(meta: SceneMeta, arrays: SceneArrays, lights: LightState, ro: V3, rd: V3,
               state: rng.RngState, max_bounces: int, media_desc=None, mis_both: bool = False,
               use_rr: bool = True) -> TraceResult:
    """Trace a batch of [N] rays to completion.

    media_desc: the MediaDesc when `meta.media_enabled` (None: the
    scene's own, `meta.media`, else the defaults of `make_media_desc`).
    mis_both: accepted and ignored, as the reference does: the integrator
    is always full MIS.  use_rr:
    Russian roulette; the differentiable path
    turns it off, since its survive/die compare flips discretely with the
    parameters.  The roulette uniform is drawn either way, so the RNG
    streams of the two modes stay aligned."""
    del mis_both
    if meta.media_enabled and media_desc is None:
        media_desc = meta.media if meta.media is not None else make_media_desc()
    n = ro.x.shape[0]
    dev = ro.x.device
    lut = BrdfLut(texels=arrays.brdf_lut)
    g, e_live = lights.live.shape
    e = meta.emissive_count
    light_table = make_light_table(lights, arrays.cell_active_f) if e > 0 else None

    thickness_fn = None
    if meta.has_refractive:
        def thickness_fn(p, l, mask):
            # masked lanes carry t_far = 0: the kernel skips them
            t_far = torch.where(mask, RCP_EPS, 0.0)
            if meta.differentiable:  # t with its Moller-Trumbore gradient
                return scene_intersect(meta, arrays, p, l, 0.0, t_far).t
            return intersect_raw(meta, arrays, p, l, 0.0, t_far)[0]

    # --- primary segment
    tracing = prof.tracing()
    with prof.span("pt.primary"):
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
        # the live lanes entering each segment (tracing only)
        seg_live = [alive.sum()] if tracing else None
        live = torch.zeros((g, e_live), dtype=torch.int64, device=dev)
        rays = torch.full((), float(n), dtype=torch.float32, device=dev)
        hit = scene_intersect(meta, arrays, ro, rd, 0.0, RCP_EPS)
        at = fetch_hit_attribs(meta, arrays, hit)
        state, ro, rd, atten, lum, alive, media_skip, live, sky = _finish_segment(
            meta, arrays, light_table, media_desc, state, ro, rd, hit, at, V3.ones(n, dev),
            V3.zeros(n, dev), alive, live, 1.0, is_primary=True)

    aov_albedo = V3.zeros(n, dev)
    aov_normal = V3.zeros(n, dev)
    aov_weight = torch.zeros((n,), dtype=torch.float32, device=dev)

    for _ in range(max_bounces):
        with prof.span("pt.bounce"):
            surf = get_surface(meta, rd, hit, at, sky_col=sky)
            surf_alive = alive & ~media_skip

            # --- NEE: light strategy, one any-hit shadow ray
            state, u_sel = rng.next_f32(state)
            state, (bu, bv) = rng.next_f32x2(state)
            if e > 0:
                tr_fn = None
                if meta.media_enabled:
                    # the shadow ray's transmittance; the RNG state threads
                    # through the closure's cell
                    st_box = [state]

                    def tr_fn(p, ldir, ldist, used):
                        st_box[0], tr = calc_transmittance(media_desc, st_box[0], p, ldir, ldist,
                                                           active=used)
                        return tr
                li, ls = nee_light_strategy(meta, arrays, light_table, lut, surf, hit.tri, rd,
                                            u_sel, bu, bv, active=surf_alive,
                                            transmittance_fn=tr_fn)
                if meta.media_enabled:
                    state = st_box[0]
                lum = lum + li * atten * surf_alive.to(torch.float32)
                rays = rays + torch.sum(surf_alive.to(torch.float32))

            # --- continuation = BSDF strategy (its MIS weight is applied to the
            # NEXT hit's emission)
            state, scat = scatter_principled(lut, surf, rd, state, occluded_fn=thickness_fn)
            cont = surf_alive & (scat.pdf > EPS)
            inv_pdf = 1.0 / torch.clamp_min(scat.pdf, EPS)
            atten = where3(cont, atten * scat.attenuation * inv_pdf, atten)
            ro2 = where3(cont, scat.pos, ro)
            rd2 = where3(cont, scat.dir, rd)
            alive2 = cont | (alive & media_skip)

            # --- AOV accumulation
            w = saturate(1.0 - avg_lum3(atten) * _RCP_PI) * cont.to(torch.float32)
            aov_albedo = aov_albedo + surf.albedo * w
            aov_normal = aov_normal + surf.n * w
            aov_weight = aov_weight + w

            # --- Russian roulette before the trace
            state, u_rr = rng.next_f32(state)
            if use_rr:
                p = saturate(avg_lum3(atten))
                survive = u_rr < p
                scale = torch.where(alive2 & survive, 1.0 / torch.clamp_min(p, EPS), 1.0)
                atten = atten * scale
                alive2 = alive2 & survive

            # --- trace the continuation segment; dead lanes carry t_far = 0
            rays = rays + torch.sum(alive2.to(torch.float32))
            if tracing:
                seg_live.append(alive2.sum())
            t_far2 = torch.where(alive2, RCP_EPS, 0.0)
            hit2 = scene_intersect(meta, arrays, ro2, rd2, 0.0, t_far2)
            at2 = fetch_hit_attribs(meta, arrays, hit2)

            # MIS weight for emission at the new hit; refractive chains carry
            # the full emission
            if e > 0:
                h_dist_sq = torch.clamp_min(hit2.t * hit2.t, EPS)
                lp_area = light_pdf(at2.rows[F.AREA], torch.abs(dot(rd2, hit2.ng)), h_dist_sq)
                lp2 = lp_area * light_select_pdf_from_rows(
                    ls.pdf_rows, ls.id_rows, at2.rows[F.EMIT_IDX].to(torch.int64))
                bp2 = scat.pdf
                ok_b = (bp2 > EPS) & (lp_area > EPS)
                w_mis = power_heuristic(bp2, lp2) * ok_b.to(torch.float32)
            else:
                w_mis = torch.ones((n,), dtype=torch.float32, device=dev)
            if meta.has_refractive:
                w_mis = torch.where(cont & ((surf.flags & _REFRACTIVE) != 0), 1.0, w_mis)
            if meta.media_enabled:
                # a media-scattered lane's in-media NEE covers the direct light
                w_mis = torch.where(media_skip, 0.0, w_mis)

            state, ro, rd, atten, lum, alive, media_skip, live, sky = _finish_segment(
                meta, arrays, light_table, media_desc, state, ro2, rd2, hit2, at2, atten, lum,
                alive2, live, w_mis, is_primary=False)
            hit, at = hit2, at2

    if tracing:
        prof.count("bounce.live", torch.stack(seg_live))
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


@prof.spanned("pt.accumulate")
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
