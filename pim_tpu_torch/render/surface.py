"""Surface interaction: fused attribute fetch + hit-point shading state.

Counterpart of `pim_tpu.render.surface`.  Every per-hit attribute comes
from ONE K3 fetch of the fused [48, T] triangle table.  Atlas textures
(albedo, rome and normal maps) are sampled for all of a hit's texture sets
in ONE fetch; sky surfaces take the sky radiance as emission.

The atlas has two fetches, as in the JAX package:
  - the serving path: ONE K6 call on the atlas corner planes, in the
    kernel's weighted form w00 t00 + w10 t10 + w01 t01 + w11 t11;
  - the differentiable path (`SceneMeta.differentiable`): the four corners
    of every set through ONE K7 call on the learnable [4, H*W] atlas planes,
    then the JAX package's lerp form t00 + (t10 - t00) * tx, so gradients
    reach the texels and, through tx and ty, the uvs.
The two forms differ by a few ulp per texel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pim_tpu_torch.core.profiler import spanned
from pim_tpu_torch.geom.material import MatFlag
from pim_tpu_torch.math.color import K_EMISSION_SCALE
from pim_tpu_torch.math.sampling import tan_to_world
from pim_tpu_torch.math.vec3 import MILLI, V2, V3, dot, f32, normalize, reflect, where3
from pim_tpu_torch.render import fetch as F
from pim_tpu_torch.render.sky import sky_radiance
from pim_tpu_torch.render.table_gather import gather_bilinear, gather_texels

_SURFACE_BIAS = f32(f32(0.01) * MILLI)
_SKY = int(MatFlag.SKY)


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
    flags: torch.Tensor  # i32
    backface: torch.Tensor


def fix_shading_normal(m: V3, n: V3) -> V3:
    """Reflect shading normals that dip below the geometric hemisphere."""
    below = dot(m, n) <= 0.0
    return where3(below, reflect(n, m), n)


def is_sky(flags: torch.Tensor) -> torch.Tensor:
    return (flags & _SKY) != 0


def _bilinear_setup(rec_t, tex_id, uv: V2):
    """The four corner indices and the lerp weights of one texture-id set:
    (idx4 [4, N] i32 in the order 00, 10, 01, 11, tx, ty).  Negative uvs are
    mirrored before the frac, as the reference's LinearWrap does
    (u = u >= 0 ? u : 1 - u)."""
    rec = F.fetch_cols(rec_t, torch.clamp_min(tex_id, 0)).to(torch.int32)  # [5, N]
    x0, y0, w, h, stride = rec[0], rec[1], rec[2], rec[3], rec[4]

    def wrap(u):
        u = torch.where(u >= 0.0, u, 1.0 - u)
        return u - torch.floor(u)

    fx = wrap(uv.x) * torch.clamp_min(w - 1, 0).to(torch.float32)
    fy = wrap(uv.y) * torch.clamp_min(h - 1, 0).to(torch.float32)
    ax = torch.floor(fx)
    ay = torch.floor(fy)
    tx = fx - ax
    ty = fy - ay
    ax = ax.to(torch.int32)
    ay = ay.to(torch.int32)
    bx = torch.minimum(ax + 1, w - 1)
    by = torch.minimum(ay + 1, h - 1)
    row0 = (y0 + ay) * stride + x0
    row1 = (y0 + by) * stride + x0
    return torch.stack([row0 + ax, row0 + bx, row1 + ax, row1 + bx], dim=0), tx, ty


def _bilinear_out(corners, tx, ty, missing, default):
    """corners: per channel the 4 corner tensors [N] -> the lerped channels,
    `default` where `missing` (the JAX package's lerp form)."""
    out = []
    for c in range(4):
        t00, t10, t01, t11 = corners[c]
        top = t00 + (t10 - t00) * tx
        bot = t01 + (t11 - t01) * tx
        out.append(torch.where(missing, float(default[c]), top + (bot - top) * ty))
    return out


def sample_atlas_bilinear_multi(atlas_planes, rec_t, fetches, atlas_corners=None, active=None):
    """Bilinear-wrap fetch of several texture-id sets in ONE table fetch.

    fetches: list of (tex_id [N] i32, uv V2, default 4-tuple); returns a
    list of 4-channel lists, one per fetch.  tex_id < 0 gives the default.
    With `atlas_corners`, ONE K6 call filters the corner planes; lanes
    outside `active` (when given) get 0 there, as on the reference's kernel
    path (their values are never consumed).  Without, ONE K7 call gathers
    the four corners of every set from `atlas_planes` [4, H*W] and the lerp
    runs in torch, differentiable in the planes and the uvs; `active` is
    not used."""
    setups = [_bilinear_setup(rec_t, tex_id, uv) for tex_id, uv, _ in fetches]
    if atlas_corners is None:
        tex = gather_texels(atlas_planes, torch.cat([s[0] for s in setups], dim=0),
                            parts=1)  # [4, 4F, N]
        return [_bilinear_out([tuple(tex[c, 4 * fi + k] for k in range(4)) for c in range(4)],
                              tx, ty, tex_id < 0, default)
                for fi, ((tex_id, _, default), (_, tx, ty)) in enumerate(zip(fetches, setups))]
    idx = torch.stack([s[0][0] for s in setups], dim=0)
    txs = torch.stack([s[1] for s in setups], dim=0)
    tys = torch.stack([s[2] for s in setups], dim=0)
    valid = torch.stack([(tex_id >= 0) if active is None else ((tex_id >= 0) & active)
                         for tex_id, _, _ in fetches], dim=0)
    filt = gather_bilinear(atlas_corners, idx, txs, tys, valid, c=4)  # [4, F, N]
    return [[torch.where(tex_id < 0, float(default[c]), filt[c, fi]) for c in range(4)]
            for fi, (tex_id, _, default) in enumerate(fetches)]


class HitAttribs(NamedTuple):
    """Everything the shading path needs about a hit, from one fused fetch
    (and one atlas fetch for a textured scene)."""

    rows: torch.Tensor   # [48, N] raw table block
    p: V3                # interpolated position
    m: V3                # interpolated macro normal (side-fixed)
    uv: V2
    flags: torch.Tensor  # i32
    albedo: V3
    rome: tuple          # 4 channel tensors [N]
    emission: V3
    nm: tuple = None     # (x, y) sampled normal-map channels, or None


@spanned("pt.fetch")
def fetch_hit_attribs(meta, arrays, hit) -> HitAttribs:
    """Fused fetch + interpolation for a Hit batch."""
    rows = F.fetch_cols(arrays.tri_table, torch.clamp_min(hit.tri, 0))  # [48, N]
    return attribs_from_rows(meta, arrays, rows, hit)


def hit_uv(rows, w, u, v) -> V2:
    """The texture coordinates interpolated from a [48, N] block at the
    barycentric weights (w, u, v) = (1 - u - v, u, v)."""
    return V2(
        rows[F.UVA.start] * w + rows[F.UVB.start] * u + rows[F.UVC.start] * v,
        rows[F.UVA.start + 1] * w + rows[F.UVB.start + 1] * u + rows[F.UVC.start + 1] * v,
    )


def attribs_from_rows(meta, arrays, rows, hit) -> HitAttribs:
    """Interpolation/shading-state build from an already-fetched [48, N]
    attribute block.  Macro normal = barycentric vertex-normal blend,
    flipped to the side of the geometric normal.  All atlas sampling of the
    hit (albedo, rome, normal map) rides one K6 call; miss lanes (dead lanes
    included) are masked out of it."""
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
    uv = hit_uv(rows, w, u, v)
    flags = rows[F.FLAGS].to(torch.int32)
    albedo = [rows[F.ALBEDO.start + c] for c in range(3)]
    rome = [rows[F.ROME.start + c] for c in range(4)]
    nm = None
    fetches = []
    if meta.textured:
        a_tex = rows[F.ALBEDO_TEX].to(torch.int32)
        r_tex = rows[F.ROME_TEX].to(torch.int32)
        fetches += [(a_tex, uv, (0, 0, 0, 0)), (r_tex, uv, (0, 0, 0, 0))]
    if meta.has_normal_maps:
        fetches.append((rows[F.NORMAL_TEX].to(torch.int32), uv, (0.0, 0.0, 1.0, 0.0)))
    if fetches:
        smps = sample_atlas_bilinear_multi(
            arrays.atlas_planes, arrays.tex_rec_t, fetches,
            atlas_corners=None if meta.differentiable else arrays.atlas_corners,
            active=hit.tri >= 0)
        if meta.textured:
            albedo = [torch.where(a_tex >= 0, smps[0][c], albedo[c]) for c in range(3)]
            rome = [torch.where(r_tex >= 0, smps[1][c], rome[c]) for c in range(4)]
        if meta.has_normal_maps:
            nm = (smps[-1][0], smps[-1][1])
    albedo = V3(*albedo)
    e = rome[3]
    emission = albedo * (e * e * K_EMISSION_SCALE)
    return HitAttribs(rows=rows, p=p, m=m, uv=uv, flags=flags, albedo=albedo,
                      rome=tuple(rome), emission=emission, nm=nm)


@spanned("pt.surface")
def get_surface(meta, rd: V3, hit, at: HitAttribs, sky_col: V3 = None) -> Surface:
    """The shading state of an already-fetched hit.  sky_col: the sky
    radiance along `rd` (required for a scene with a sky: sky surfaces emit
    it)."""
    p = at.p + at.m * _SURFACE_BIAS
    n = at.m
    if meta.has_normal_maps:
        nm_tex = at.rows[F.NORMAL_TEX].to(torch.int32)
        nz = torch.sqrt(torch.clamp_min(1.0 - (at.nm[0] * at.nm[0] + at.nm[1] * at.nm[1]),
                                        1e-6))
        n_mapped = fix_shading_normal(at.m, tan_to_world(at.m, V3(at.nm[0], at.nm[1], nz)))
        n = where3(nm_tex >= 0, n_mapped, n)
    albedo, emission, m = at.albedo, at.emission, at.m
    roughness, occlusion, metallic = at.rome[0], at.rome[1], at.rome[2]
    ior = at.rows[F.IOR]
    if meta.has_sky:
        sky = is_sky(at.flags)
        zero = torch.zeros_like(sky, dtype=torch.float32)
        albedo = where3(sky, V3(zero, zero, zero), albedo)
        emission = where3(sky, sky_col, emission)
        m = where3(sky, -rd, m)
        n = where3(sky, -rd, n)
        roughness = torch.where(sky, 1.0, roughness)
        occlusion = torch.where(sky, 0.0, occlusion)
        metallic = torch.where(sky, 0.0, metallic)
        ior = torch.where(sky, 1.0, ior)
    return Surface(p=p, m=m, n=n, albedo=albedo, emission=emission, roughness=roughness,
                   occlusion=occlusion, metallic=metallic, ior=ior, flags=at.flags,
                   backface=hit.backface)


def get_emission_from_attribs(meta, at: HitAttribs, sky_col: V3 = None) -> V3:
    """Emission-only view of a fetched hit; in a scene with a sky, sky
    surfaces emit `sky_col` (the sky radiance along the ray).  A scene
    without one has no sky surfaces."""
    if not meta.has_sky:
        return at.emission
    return where3(is_sky(at.flags), sky_col, at.emission)


def get_emission(meta, arrays, ro: V3, rd: V3, hit) -> V3:
    """Emission-only view of a hit (fetched here): the integrator fetches
    once and calls `get_emission_from_attribs` itself."""
    at = fetch_hit_attribs(meta, arrays, hit)
    return get_emission_from_attribs(meta, at, sky_radiance(meta, arrays, rd))
