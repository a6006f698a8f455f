"""Principled BSDF: evaluation and sampling over flat [N] lanes.

Counterpart of `pim_tpu.render.bsdf`.  The principled surface is a
stochastic lobe mix: specular weight lerp(0.5, 1.0, metallic), the rest
diffuse; refractive materials switch to a GGX-microfacet dielectric with
Beer-Lambert interior transmittance, whose thickness comes from a
closest-hit probe along the refracted ray.

Two forms compute it.  The composed one (`scatter_principled_plain`,
`eval_principled_plain`) is PyTorch ops; it runs on the CPU, and on the
card wherever an input requires grad (autograd differentiates it).  On
CUDA tensors that carry no gradient, `scatter_principled` and
`eval_principled` launch the hand-written kernels of `csrc/bsdf.cu`
(`bsdf_scatter`, `bsdf_refract_finish`, `bsdf_eval`), one thread a lane,
bit for bit the composed version on the card.  The refractive thickness
probe stays an eager closest-hit call between the two glass kernels.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pim_tpu_torch import native
from pim_tpu_torch.core import profiler as prof
from pim_tpu_torch.core import rng
from pim_tpu_torch.core.profiler import spanned
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


def eval_principled_plain(lut: BrdfLut, surf: Surface, i: V3, l: V3):
    """Mixed-lobe eval for NEE, composed of PyTorch ops.  Refractive lanes
    evaluate to zero."""
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


def scatter_principled_plain(lut: BrdfLut, surf: Surface, i: V3, state, occluded_fn=None):
    """`scatter_principled` composed of PyTorch ops."""
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


# ---------------------------------------------------------------------------
# The kernels (csrc/bsdf.cu) and the dispatch between them and the plain form
# ---------------------------------------------------------------------------

_F32, _I32, _I64, _BOOL = torch.float32, torch.int32, torch.int64, torch.bool
# (name, dtype) of each [N] input, in the order of csrc/bsdf.cu's pointer
# tables ScatterArgs and EvalArgs
SCATTER_FIELDS = (
    *((f"{v}.{c}", _F32) for v in ("p", "m", "n", "albedo") for c in "xyz"),
    ("roughness", _F32), ("metallic", _F32), ("ior", _F32), ("flags", _I32),
    ("backface", _BOOL), *((f"i.{c}", _F32) for c in "xyz"),
    *((f"state.{c}", _I64) for c in "xyzw"),
)
EVAL_FIELDS = (
    *((f"{v}.{c}", _F32) for v in ("n", "albedo") for c in "xyz"),
    ("roughness", _F32), ("metallic", _F32), ("flags", _I32),
    *((f"{v}.{c}", _F32) for v in ("i", "l") for c in "xyz"),
)


def scatter_fields(surf: Surface, i: V3, state) -> list:
    """The scatter kernel's inputs in SCATTER_FIELDS' order."""
    return [*surf.p, *surf.m, *surf.n, *surf.albedo, surf.roughness, surf.metallic, surf.ior,
            surf.flags, surf.backface, *i, *state]


def eval_fields(surf: Surface, i: V3, l: V3) -> list:
    """The eval kernel's inputs in EVAL_FIELDS' order."""
    return [*surf.n, *surf.albedo, surf.roughness, surf.metallic, surf.flags, *i, *l]


def _lut_size(name: str, lut: torch.Tensor) -> int:
    if lut.dim() != 3:
        raise ValueError(f"{name}.lut: expected [S, S, 2], got {tuple(lut.shape)}")
    size = lut.shape[0]
    native.require_cuda(f"{name}.lut", lut, _F32, (size, size, 2), lut.device)
    return size


def _lane_table(name: str, specs, fields, dev):
    """(N, the ctypes pointer table) of `fields`, each a contiguous [N]
    tensor of its spec's dtype on `dev`; raises on anything else, and on a
    device that is not CUDA."""
    if len(fields) != len(specs):
        raise ValueError(f"{name}: {len(fields)} inputs, expected {len(specs)}")
    if fields[0].dim() != 1:
        raise ValueError(f"{name}.{specs[0][0]}: expected [N], got {tuple(fields[0].shape)}")
    n = fields[0].shape[0]
    for (field, dtype), t in zip(specs, fields):
        native.require_cuda(f"{name}.{field}", t, dtype, (n,), dev)
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
    return n, (ctypes.c_void_p * len(fields))(*(t.data_ptr() for t in fields))


def bsdf_scatter(lut: torch.Tensor, fields, refract: bool):
    """The scatter kernel over SCATTER_FIELDS' [N] CUDA tensors: (out, words,
    probe).  out [10, N] f32 holds position, direction, attenuation and pdf;
    with `refract` out is [16, N], rows 10-15 the thickness probe's origin
    and direction on every lane, and probe [N] bool marks the lanes whose
    thickness it traces (None without `refract`); words [4, N] int64 are the
    new RNG state.  The probed lanes' attenuation waits for
    `bsdf_refract_finish`."""
    dev = lut.device
    size = _lut_size("bsdf_scatter", lut)
    n, table = _lane_table("bsdf_scatter", SCATTER_FIELDS, fields, dev)
    out = torch.empty((16 if refract else 10, n), dtype=_F32, device=dev)
    words = torch.empty((4, n), dtype=_I64, device=dev)
    probe = torch.empty((n,), dtype=_BOOL, device=dev) if refract else None
    if n == 0:
        return out, words, probe
    lib = native.load()
    rc = lib.pim_bsdf_scatter(table, lut.data_ptr(), size, n, int(refract), out.data_ptr(),
                              words.data_ptr(), None if probe is None else probe.data_ptr(),
                              native.stream_ptr(dev))
    native.check(lib, rc, "bsdf_scatter")
    native.launches["bsdf_scatter"] += 1
    return out, words, probe


def bsdf_refract_finish(out: torch.Tensor, probe: torch.Tensor, t_hit: torch.Tensor,
                        albedo: V3, roughness: torch.Tensor) -> None:
    """In place on `bsdf_scatter`'s out [16, N]: the Beer-Lambert attenuation
    (rows 6-8) of the lanes `probe` marks, from the probe's hit distance
    t_hit [N] and the pdf (row 9)."""
    dev = out.device
    n, table = _lane_table(
        "bsdf_refract_finish",
        (("probe", _BOOL), ("t_hit", _F32), ("albedo.x", _F32), ("albedo.y", _F32),
         ("albedo.z", _F32), ("roughness", _F32)),
        [probe, t_hit, *albedo, roughness], dev)
    native.require_cuda("bsdf_refract_finish.out", out, _F32, (16, n), dev)
    if n == 0:
        return
    lib = native.load()
    rc = lib.pim_bsdf_refract_finish(*table, n, out.data_ptr(), native.stream_ptr(dev))
    native.check(lib, rc, "bsdf_refract_finish")
    native.launches["bsdf_refract_finish"] += 1


def bsdf_eval(lut: torch.Tensor, fields) -> torch.Tensor:
    """The eval kernel over EVAL_FIELDS' [N] CUDA tensors: [4, N] f32, the
    attenuation and the pdf."""
    dev = lut.device
    size = _lut_size("bsdf_eval", lut)
    n, table = _lane_table("bsdf_eval", EVAL_FIELDS, fields, dev)
    out = torch.empty((4, n), dtype=_F32, device=dev)
    if n == 0:
        return out
    lib = native.load()
    rc = lib.pim_bsdf_eval(table, lut.data_ptr(), size, n, out.data_ptr(),
                           native.stream_ptr(dev))
    native.check(lib, rc, "bsdf_eval")
    native.launches["bsdf_eval"] += 1
    return out


def takes_kernels(lut: BrdfLut, fields) -> bool:
    """Whether a BSDF call takes the kernels: its tensors lie on the card and
    none requires grad (autograd differentiates the plain form)."""
    return (lut.texels.device.type == "cuda" and not lut.texels.requires_grad
            and not any(t.requires_grad for t in fields))


def _count(kernel: bool) -> None:
    if prof.tracing():
        prof.count("bsdf.calls", 1)
        prof.count("bsdf.kernel", int(kernel))


def eval_principled(lut: BrdfLut, surf: Surface, i: V3, l: V3):
    """Mixed-lobe eval for NEE: (attenuation V3, pdf [N]).  Refractive lanes
    evaluate to zero.  One `bsdf_eval` launch where `takes_kernels`, else the
    plain form."""
    fields = eval_fields(surf, i, l)
    kernel = takes_kernels(lut, fields)
    _count(kernel)
    if not kernel:
        return eval_principled_plain(lut, surf, i, l)
    out = bsdf_eval(lut.texels, [t.contiguous() for t in fields])
    return V3(out[0], out[1], out[2]), out[3]


@spanned("pt.bsdf")
def scatter_principled(lut: BrdfLut, surf: Surface, i: V3, state, occluded_fn=None):
    """One-sample lobe-mixed BSDF sample.  Returns (state, Scatter).

    occluded_fn(ro V3, rd V3, mask) -> t_hit [N] is the interior-thickness
    probe of refractive transmission; None leaves the refractive path out
    (a scene without refractive materials).  Where `takes_kernels`: one
    `bsdf_scatter` launch, and with `occluded_fn` the probe and one
    `bsdf_refract_finish`; else the plain form."""
    fields = scatter_fields(surf, i, state)
    kernel = takes_kernels(lut, fields)
    _count(kernel)
    if not kernel:
        return scatter_principled_plain(lut, surf, i, state, occluded_fn)
    refract = occluded_fn is not None
    fields = [t.contiguous() for t in fields]
    out, words, probe = bsdf_scatter(lut.texels, fields, refract)
    if refract:
        t_hit = occluded_fn(V3(out[10], out[11], out[12]), V3(out[13], out[14], out[15]), probe)
        bsdf_refract_finish(out, probe, t_hit.contiguous(), V3(*fields[9:12]), fields[12])
    return rng.RngState(*words), Scatter(pos=V3(out[0], out[1], out[2]),
                                         dir=V3(out[3], out[4], out[5]),
                                         attenuation=V3(out[6], out[7], out[8]), pdf=out[9])
