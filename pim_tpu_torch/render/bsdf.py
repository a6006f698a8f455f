"""Principled BSDF: evaluation and sampling over flat [N] lanes.

Counterpart of `pim_tpu.render.bsdf`.  The principled surface is a
stochastic lobe mix: specular weight lerp(0.5, 1.0, metallic), the rest
diffuse; refractive materials switch to a GGX-microfacet dielectric with
Beer-Lambert interior transmittance, whose thickness comes from a
closest-hit probe along the refracted ray.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pim_tpu_torch.core import rng
from pim_tpu_torch.geom.material import MatFlag
from pim_tpu_torch.math.brdf import (
    BrdfLut,
    albedo_to_transmittance,
    brdf_alpha,
    d_gtr,
    f_0,
    f_90,
    f_dielectric,
    fd_burley,
    ggx_energy_compensation,
    v_smith_correlated,
)
from pim_tpu_torch.math.sampling import (
    ggx_pdf,
    lambert_pdf,
    sample_cosine_hemisphere,
    sample_ggx_microfacet,
    tan_to_world,
)
from pim_tpu_torch.math.vec3 import (
    EPS,
    MILLI,
    V3,
    dot,
    dotsat,
    lerp,
    lerp3,
    normalize,
    reflect,
    refract,
    where3,
    f32,
)
from pim_tpu_torch.render.surface import Surface, fix_shading_normal

_REFRACTIVE = int(MatFlag.REFRACTIVE)
_ETA_AIR = f32(1.000277)
_INSIDE_BIAS = f32(MILLI * f32(0.1))


class Scatter(NamedTuple):
    """One BSDF sample."""

    pos: V3
    dir: V3
    attenuation: V3  # brdf * NoL
    pdf: torch.Tensor


def eval_diffuse(surf: Surface, i: V3, l: V3):
    """Burley diffuse eval. Returns (attenuation V3, pdf [N])."""
    n = surf.n
    nol = dot(n, l)
    pdf = lambert_pdf(nol)
    valid = pdf > EPS
    v = -i
    h = normalize(v + l)
    hov = dotsat(h, v)
    nov = dotsat(n, v)
    s = fd_burley(nol, nov, hov, surf.roughness) * nol
    s = torch.where(valid, s, 0.0)
    return surf.albedo * s, torch.where(valid, pdf, 0.0)


def eval_specular(lut: BrdfLut, surf: Surface, i: V3, l: V3):
    """GGX specular eval with energy compensation."""
    n = surf.n
    nol = dot(n, l)
    alpha = brdf_alpha(surf.roughness)
    v = -i
    h = normalize(v + l)
    noh = dot(n, h)
    hov = dot(h, v)
    pdf = ggx_pdf(noh, hov, alpha)
    valid = (nol > EPS) & (pdf > EPS)
    nov = dotsat(n, v)
    f_d = torch.clamp(f_dielectric(hov, 1.0, 1.5), 0.0, 1.0)
    f0 = f_0(surf.albedo, surf.metallic)
    f90 = f_90(f0)
    f = V3(lerp(f0.x, f90, f_d), lerp(f0.y, f90, f_d), lerp(f0.z, f90, f_d))
    d = d_gtr(noh, alpha)
    g = v_smith_correlated(nol, nov, alpha)
    comp = ggx_energy_compensation(lut, f0, nov, alpha)
    s = torch.where(valid, d * g * nol, 0.0)
    atten = f * comp * s
    return atten, torch.where(valid, pdf, 0.0)


def eval_principled(lut: BrdfLut, surf: Surface, i: V3, l: V3):
    """Mixed-lobe eval for NEE.  Refractive lanes evaluate to zero."""
    nol = dot(surf.n, l)
    amt_spec = lerp(0.5, 1.0, surf.metallic)
    amt_diff = 1.0 - amt_spec
    spec_a, spec_p = eval_specular(lut, surf, i, l)
    diff_a, diff_p = eval_diffuse(surf, i, l)
    atten = lerp3(spec_a, diff_a, amt_diff)
    pdf = lerp(spec_p, diff_p, amt_diff)
    dead = ((surf.flags & _REFRACTIVE) != 0) | (nol <= EPS)
    zero = torch.zeros_like(nol)
    return (
        where3(dead, V3(zero, zero, zero), atten),
        torch.where(dead, 0.0, pdf),
    )


def scatter_principled(lut: BrdfLut, surf: Surface, i: V3, state, occluded_fn=None):
    """One-sample lobe-mixed BSDF sample.  Returns (state, Scatter).

    occluded_fn(ro V3, rd V3, mask) -> t_hit [N] is the interior-thickness
    probe of refractive transmission; None leaves the refractive path out
    (a scene without refractive materials)."""
    state, u_lobe = rng.next_f32(state)
    state, (xu, xv) = rng.next_f32x2(state)
    amt_spec = lerp(0.5, 1.0, surf.metallic)
    amt_diff = 1.0 - amt_spec
    use_spec = u_lobe < amt_spec

    # specular sample
    alpha = brdf_alpha(surf.roughness)
    m = tan_to_world(surf.n, sample_ggx_microfacet(xu, xv, alpha))
    m = fix_shading_normal(surf.m, m)
    l_spec = reflect(i, m)
    # diffuse sample, same 2D draw
    l_diff = tan_to_world(surf.n, sample_cosine_hemisphere(xu, xv))

    l = where3(use_spec, l_spec, l_diff)
    # evaluate both lobes at the chosen direction (one-sample MIS mix)
    e_spec_a, e_spec_p = eval_specular(lut, surf, i, l)
    e_diff_a, e_diff_p = eval_diffuse(surf, i, l)

    atten_spec_branch = lerp3(e_spec_a, e_diff_a, amt_diff)
    pdf_spec_branch = lerp(e_spec_p, e_diff_p, amt_diff)
    atten_diff_branch = lerp3(e_diff_a, e_spec_a, amt_spec)
    pdf_diff_branch = lerp(e_diff_p, e_spec_p, amt_spec)

    atten = where3(use_spec, atten_spec_branch, atten_diff_branch)
    pdf = torch.where(use_spec, pdf_spec_branch, pdf_diff_branch)
    pos = surf.p

    if occluded_fn is not None:
        refractive = (surf.flags & _REFRACTIVE) != 0
        state, refr = _scatter_refractive(surf, i, state, occluded_fn, refractive)
        pos = where3(refractive, refr.pos, pos)
        l = where3(refractive, refr.dir, l)
        atten = where3(refractive, refr.attenuation, atten)
        pdf = torch.where(refractive, refr.pdf, pdf)
    return state, Scatter(pos=pos, dir=l, attenuation=atten, pdf=pdf)


def _scatter_refractive(surf: Surface, i: V3, state, thickness_fn, mask):
    """GGX microfacet dielectric with Beer-Lambert interior transmittance.

    mask: the lanes whose result is used (refractive materials); the
    thickness probe carries it, so the other lanes trace with t_far = 0."""
    eta_t = torch.clamp_min(surf.ior, 1.0)
    alpha = brdf_alpha(surf.roughness)

    state, (xu, xv) = rng.next_f32x2(state)
    state, u_fresnel = rng.next_f32(state)

    v = -i
    m = tan_to_world(surf.n, sample_ggx_microfacet(xu, xv, alpha))
    m = fix_shading_normal(surf.m, m)
    entering = ~surf.backface

    cos_i = torch.clamp(torch.abs(dot(v, m)), 0.0, 1.0)
    fres = f_dielectric(torch.where(entering, cos_i, -cos_i), _ETA_AIR, eta_t)

    do_reflect = u_fresnel < fres
    l_reflect = reflect(i, m)
    k = torch.where(entering, _ETA_AIR / eta_t, eta_t / _ETA_AIR)
    l_refract = refract(i, m, k)
    tir = dot(l_refract, l_refract) < 1e-8
    l_refract = where3(tir, l_reflect, l_refract)
    l = where3(do_reflect, l_reflect, l_refract)
    pdf = torch.where(do_reflect, fres, 1.0 - fres)

    below = dot(l, surf.m) < 0.0
    pos = where3(below, surf.p - surf.m * _INSIDE_BIAS, surf.p)

    refracting_in = (~do_reflect) & entering & ~tir
    t_hit = thickness_fn(pos, l, mask & refracting_in)
    thickness = torch.where(t_hit >= 0.0, torch.clamp_min(t_hit, EPS), 1e6)
    tr = albedo_to_transmittance(surf.albedo, surf.roughness, thickness)
    atten = where3(refracting_in, tr * pdf, V3(pdf, pdf, pdf))
    return state, Scatter(pos=pos, dir=l, attenuation=atten, pdf=pdf)
