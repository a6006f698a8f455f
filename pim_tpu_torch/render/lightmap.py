"""Progressive spherical-gaussian GI lightmaps: charting, packing, baking.

Counterpart of `pim_tpu.render.lightmap`:
- triangles cluster into planar charts (`_build_charts`: normal and plane
  offset thresholds, a 32-chart look-back, oversized charts split);
- chart bounding boxes shelf-pack into a square power-of-two atlas (auto
  grown up to the 1024 page, clamped on a terminal overflow);
- each covered texel embeds a world position and normal (a barycentric
  raster test in texel space with a 0.75-texel tolerance);
- the progressive bake (`bake_step`) traces one jittered uniform-hemisphere
  ray a texel through `integrator.trace_rays` and folds its radiance into
  5 spherical gaussians a texel (Roughton's running fit, weight
  1/sampleCount), with per-texel sample counts so a bake resumes.

Charting, packing and embedding are host numpy, copied from the reference
line for line so the atlas comes out bit for bit.  The bake runs on the
pack's device: every texel of a contiguous shard traces together (dead
texels too, with a +Z normal; they fold nothing), and the shard's RNG
streams are keyed by (texel index in the pack, frame).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from pim_tpu_torch.core import profiler as prof
from pim_tpu_torch.core import rng
from pim_tpu_torch.core.console import LogSev, con_logf
from pim_tpu_torch.math.sampling import normal_to_tbn, sample_unit_hemisphere
from pim_tpu_torch.math.sphgauss import GI_AXII, sg_irradiance
from pim_tpu_torch.math.vec3 import V3
from pim_tpu_torch.render.integrator import trace_rays

BAKE_SEED = 0x1A57
LMPACK_VERSION = 2


# ---------------------------------------------------------------------------
# Charting + packing (host)
# ---------------------------------------------------------------------------


@dataclass
class Chart:
    tri_ids: np.ndarray     # triangle indices in the flat scene
    normal: np.ndarray      # dominant plane normal
    origin: np.ndarray      # plane origin
    tangent: np.ndarray
    bitangent: np.ndarray
    uv_min: np.ndarray = None
    uv_max: np.ndarray = None
    # atlas placement
    atlas_x: int = 0
    atlas_y: int = 0
    w: int = 0
    h: int = 0


def _build_charts(positions: np.ndarray, normal_thresh: float = 0.707,
                  dist_thresh: float = 1.0, max_tris: int = 4096) -> List[Chart]:
    """Greedy planar clustering: a triangle joins one of the last 32 charts
    when its normal and plane offset are close."""
    tri_count = positions.shape[0] // 3
    tris = positions.reshape(tri_count, 3, 3)
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    n = np.cross(e1, e2)
    lens = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(lens, 1e-12)
    centers = tris.mean(axis=1)

    charts: List[Chart] = []
    for ti in range(tri_count):
        placed = False
        for ci in range(len(charts) - 1, max(len(charts) - 32, -1), -1):
            ch = charts[ci]
            if len(ch.tri_ids) >= max_tris:
                continue
            if (
                np.dot(ch.normal, n[ti]) >= normal_thresh
                and abs(np.dot(ch.normal, centers[ti]) - np.dot(ch.normal, ch.origin))
                <= dist_thresh
            ):
                ch.tri_ids = np.append(ch.tri_ids, ti)
                placed = True
                break
        if not placed:
            nn = n[ti]
            t = np.cross(nn, [0.0, 1.0, 0.0])
            if np.linalg.norm(t) < 1e-3:
                t = np.cross(nn, [1.0, 0.0, 0.0])
            t = t / np.linalg.norm(t)
            b = np.cross(nn, t)
            charts.append(
                Chart(
                    tri_ids=np.asarray([ti], np.int64), normal=nn,
                    origin=centers[ti].copy(), tangent=t, bitangent=b,
                )
            )
    return charts


class LmPack(NamedTuple):
    """Packed lightmap atlas and its bake state, on one device.

    Per-texel tensors (flat over all atlas texels T = size * size):
      position [3, T], normal [3, T]  the embedded world attributes
      probes   [T, K, 4]              SG amplitudes (rgb + running weight)
      sample_counts [T]               0 = dead texel; 1 + passes baked
    """

    size: int                   # atlas dimension (square)
    texels_per_meter: float
    position: torch.Tensor      # [3, T]
    normal: torch.Tensor        # [3, T]
    probes: torch.Tensor        # [T, K, 4]
    sample_counts: torch.Tensor  # [T]
    axii: torch.Tensor          # [K, 4] world-fixed SG axes


def _shelf_pack(charts: List[Chart], size: int) -> bool:
    order = sorted(range(len(charts)), key=lambda i: -charts[i].h)
    shelf_x = shelf_y = shelf_h = 0
    for ci in order:
        ch = charts[ci]
        if ch.w > size or ch.h > size:
            return False
        if shelf_x + ch.w > size:
            shelf_y += shelf_h
            shelf_x = 0
            shelf_h = 0
        if shelf_y + ch.h > size:
            return False
        ch.atlas_x = shelf_x
        ch.atlas_y = shelf_y
        shelf_x += ch.w
        shelf_h = max(shelf_h, ch.h)
    return True


def _clamp_pack(charts: List[Chart], size: int) -> None:
    """The terminal overflow: clamp oversize charts and pack what fits (a
    chart that does not fit gets w = h = 0)."""
    con_logf(LogSev.Warning, "lm", "atlas overflow at %d; clamping charts", size)
    for ch in charts:
        ch.w = min(ch.w, size)
        ch.h = min(ch.h, size)
    order = sorted(range(len(charts)), key=lambda i: -charts[i].h)
    shelf_x = shelf_y = shelf_h = 0
    for ci in order:
        ch = charts[ci]
        if shelf_x + ch.w > size:
            shelf_y += shelf_h
            shelf_x = 0
            shelf_h = 0
        if shelf_y + ch.h > size:
            ch.w = ch.h = 0
            continue
        ch.atlas_x = shelf_x
        ch.atlas_y = shelf_y
        shelf_x += ch.w
        shelf_h = max(shelf_h, ch.h)


def _embed(tris: np.ndarray, charts: List[Chart], atlas_size: int, texels_per_meter: float):
    """World position, normal and coverage of every atlas texel (the charts'
    triangles rasterized in texel space)."""
    t = atlas_size * atlas_size
    pos = np.zeros((t, 3), np.float32)
    nrm = np.zeros((t, 3), np.float32)
    counts = np.zeros(t, np.float32)
    for ch in charts:
        if ch.w == 0:
            continue
        for ti in ch.tri_ids:
            tri = tris[ti]
            tn = np.cross(tri[1] - tri[0], tri[2] - tri[0])
            tl = np.linalg.norm(tn)
            if tl < 1e-12:
                continue
            tn = tn / tl
            # uv coords of the triangle in chart space
            uvs = np.stack(
                [
                    (tri - ch.origin) @ ch.tangent,
                    (tri - ch.origin) @ ch.bitangent,
                ],
                axis=-1,
            )  # [3, 2]
            tex = (uvs - ch.uv_min) * texels_per_meter  # texel coords
            lo = np.maximum(np.floor(tex.min(axis=0)).astype(int), 0)
            hi = np.minimum(
                np.ceil(tex.max(axis=0)).astype(int) + 1,
                np.asarray([ch.w, ch.h]),
            )
            if (hi <= lo).any():
                continue
            xs = np.arange(lo[0], hi[0])
            ys = np.arange(lo[1], hi[1])
            gx, gy = np.meshgrid(xs, ys, indexing="xy")
            px = gx.ravel() + 0.5
            py = gy.ravel() + 0.5
            # barycentric test in texel space
            a2 = tex[1] - tex[0]
            b2 = tex[2] - tex[0]
            den = a2[0] * b2[1] - a2[1] * b2[0]
            if abs(den) < 1e-12:
                continue
            qx = px - tex[0, 0]
            qy = py - tex[0, 1]
            wu = (qx * b2[1] - qy * b2[0]) / den
            wv = (qy * a2[0] - qx * a2[1]) / den
            # the 0.75-texel tolerance keeps seams lit
            tol = 0.75
            inside = (wu >= -tol) & (wv >= -tol) & (wu + wv <= 1.0 + tol)
            if not inside.any():
                continue
            wuc = np.clip(wu[inside], 0.0, 1.0)
            wvc = np.clip(wv[inside], 0.0, 1.0)
            ws = np.clip(1.0 - wuc - wvc, 0.0, 1.0)
            norm = np.maximum(ws + wuc + wvc, 1e-6)
            world = (
                ws[:, None] * tri[0]
                + wuc[:, None] * tri[1]
                + wvc[:, None] * tri[2]
            ) / norm[:, None]
            ax = gx.ravel()[inside] + ch.atlas_x
            ay = gy.ravel()[inside] + ch.atlas_y
            idx = ay * atlas_size + ax
            pos[idx] = world
            nrm[idx] = tn
            counts[idx] = np.maximum(counts[idx], 1.0)
    return pos, nrm, counts


def pack_lightmaps(positions: np.ndarray, normals: np.ndarray, texels_per_meter: float = 4.0,
                   atlas_size: Optional[int] = None, device="cuda") -> Optional[LmPack]:
    """Chart, pack and embed a triangle soup ([3 * tris, 3] float32 world
    positions; `normals` is unused: texels take their triangle's geometric
    normal).  Returns None for an empty scene.  `atlas_size=None` picks the
    smallest power of two (up to 1024) whose area covers twice the summed
    chart rects, growing it while the shelf pack overflows.  The pack's
    tensors live on `device`."""
    del normals
    tri_count = positions.shape[0] // 3
    if tri_count == 0:
        return None
    tris = positions.reshape(tri_count, 3, 3)
    charts = _build_charts(positions)

    # project each chart to its plane, compute texel rects
    for ch in charts:
        pts = tris[ch.tri_ids].reshape(-1, 3) - ch.origin
        u = pts @ ch.tangent
        v = pts @ ch.bitangent
        ch.uv_min = np.asarray([u.min(), v.min()])
        ch.uv_max = np.asarray([u.max(), v.max()])
        ext = ch.uv_max - ch.uv_min
        ch.w = max(int(np.ceil(ext[0] * texels_per_meter)) + 1, 1)
        ch.h = max(int(np.ceil(ext[1] * texels_per_meter)) + 1, 1)

    auto_grow = atlas_size is None
    if auto_grow:
        area = sum(ch.w * ch.h for ch in charts)
        wmax = max(max(ch.w for ch in charts), max(ch.h for ch in charts))
        atlas_size = 32
        while atlas_size < 1024 and (
            atlas_size * atlas_size < 2 * area or atlas_size < wmax
        ):
            atlas_size *= 2

    # shelf pack; on an overflow retry with a doubled atlas (up to 1024)
    while not _shelf_pack(charts, atlas_size):
        if auto_grow and atlas_size < 1024:
            atlas_size *= 2
            continue
        _clamp_pack(charts, atlas_size)
        break

    pos, nrm, counts = _embed(tris, charts, atlas_size, texels_per_meter)
    t = atlas_size * atlas_size
    k = GI_AXII.shape[0]
    live = int((counts > 0).sum())
    con_logf(LogSev.Info, "lm", "packed %d charts, %d/%d live texels (%.1f%%)",
             len(charts), live, t, 100.0 * live / t)

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return LmPack(
        size=atlas_size,
        texels_per_meter=texels_per_meter,
        position=dev_t(pos.T),
        normal=dev_t(nrm.T),
        probes=torch.zeros((t, k, 4), dtype=torch.float32, device=device),
        sample_counts=dev_t(counts),
        axii=dev_t(GI_AXII),
    )


# ---------------------------------------------------------------------------
# Progressive bake (device)
# ---------------------------------------------------------------------------


def _set_rows(full: torch.Tensor, sl: slice, rows: torch.Tensor) -> torch.Tensor:
    """`full` with rows `sl` replaced, as a new tensor."""
    if sl.start == 0 and sl.stop == full.shape[0]:
        return rows
    out = full.clone()
    out[sl] = rows
    return out


class BakeRays(NamedTuple):
    """A shard's bake rays and the frame each texel folds them in."""

    state: rng.RngState  # the streams after the two draws, handed to the trace
    ro: V3
    rd: V3
    tan: V3              # the TBN about the embedded normal (+Z on dead texels)
    bit: V3
    normal: V3
    alive: torch.Tensor  # [n] bool, live texels


def bake_rays(pack: LmPack, frame: int, texel_offset: int, texel_count: int) -> BakeRays:
    """The rays of one bake pass over the texels [texel_offset,
    texel_offset + texel_count): per texel a uniform hemisphere direction
    about the embedded normal and an origin jittered inside the texel's
    footprint, from the streams keyed by (texel index, frame)."""
    sl = slice(texel_offset, texel_offset + texel_count)
    dev = pack.position.device
    pos = V3(pack.position[0, sl], pack.position[1, sl], pack.position[2, sl])
    nrm = V3(pack.normal[0, sl], pack.normal[1, sl], pack.normal[2, sl])
    alive = pack.sample_counts[sl] > 0.0

    texel_ids = torch.arange(texel_count, dtype=torch.int64, device=dev) + texel_offset
    state = rng.make_state(texel_ids, int(frame) & rng.MASK32, seed=BAKE_SEED)

    # TBN about the embedded normal; dead texels take +Z
    safe_n = V3(
        torch.where(alive, nrm.x, 0.0),
        torch.where(alive, nrm.y, 0.0),
        torch.where(alive, nrm.z, 1.0),
    )
    tan, bit = normal_to_tbn(safe_n)

    state, (hu, hv) = rng.next_f32x2(state)
    l_ts = sample_unit_hemisphere(hu, hv)
    rd = tan * l_ts.x + bit * l_ts.y + safe_n * l_ts.z

    mpt = 1.0 / pack.texels_per_meter
    state, (ju, jv) = rng.next_f32x2(state)
    ro = (
        pos + safe_n * 1e-3
        + tan * ((ju - 0.5) * mpt)
        + bit * ((jv - 0.5) * mpt)
    )
    return BakeRays(state, ro, rd, tan, bit, safe_n, alive)


@prof.spanned("pt.bake")
def bake_step(meta, arrays, lights, pack: LmPack, frame: int, max_bounces: int = 4,
              texel_offset: int = 0, texel_count: Optional[int] = None) -> LmPack:
    """One progressive bake pass over the texel shard [texel_offset,
    texel_offset + texel_count) (all texels by default): trace each
    texel's `bake_rays` ray and fold its radiance into the texel's SG
    probes with weight 1/sampleCount.  Returns an updated LmPack; the input
    pack is not modified.  Dead texels trace but accumulate nothing."""
    if texel_count is None:
        texel_count = pack.position.shape[1]
    sl = slice(texel_offset, texel_offset + texel_count)
    counts = pack.sample_counts[sl]
    probes = pack.probes[sl]
    state, ro, rd, tan, bit, safe_n, alive = bake_rays(pack, frame, texel_offset, texel_count)
    if prof.tracing():
        prof.count("bake.lanes", texel_count)
        prof.count("bake.live", alive.sum())

    radiance = trace_rays(meta, arrays, lights, ro, rd, state, max_bounces).color  # [T, 3]

    # world-space SG axes per texel: the canonical axes rotated by the TBN
    axes = pack.axii  # [K, 4]
    ax_ts = axes[:, :3]
    axw_x = (tan.x[:, None] * ax_ts[None, :, 0] + bit.x[:, None] * ax_ts[None, :, 1]
             + safe_n.x[:, None] * ax_ts[None, :, 2])
    axw_y = (tan.y[:, None] * ax_ts[None, :, 0] + bit.y[:, None] * ax_ts[None, :, 1]
             + safe_n.y[:, None] * ax_ts[None, :, 2])
    axw_z = (tan.z[:, None] * ax_ts[None, :, 0] + bit.z[:, None] * ax_ts[None, :, 1]
             + safe_n.z[:, None] * ax_ts[None, :, 2])

    # the inline running fit (no first-sample reset, unlike sg_accumulate)
    sharp = axes[:, 3]  # [K]
    cos_t = axw_x * rd.x[:, None] + axw_y * rd.y[:, None] + axw_z * rd.z[:, None]  # [T, K]
    basis = torch.exp(sharp[None, :] * (cos_t - 1.0))
    sw = torch.where(alive, 1.0 / torch.clamp_min(counts, 1.0), 0.0)

    amp_rgb = probes[..., :3]
    weight = probes[..., 3]
    estimate = torch.sum(amp_rgb * basis[..., None], dim=-2)  # [T, 3]
    new_weight = weight + (basis - weight) * sw[:, None]
    other = estimate[:, None, :] - amp_rgb * basis[..., None]
    this_lobe = (radiance[:, None, :] - other) * (
        basis / torch.clamp_min(new_weight, 1e-6))[..., None]
    new_rgb = amp_rgb + (this_lobe - amp_rgb) * sw[:, None, None]
    new_rgb = torch.clamp_min(new_rgb, 0.0)
    active = (basis > 0.0) & alive[:, None]
    out_rgb = torch.where(active[..., None], new_rgb, amp_rgb)
    out_w = torch.where(active, new_weight, weight)
    new_probes = torch.cat([out_rgb, out_w[..., None]], dim=-1)

    new_counts = counts + alive.to(torch.float32)
    return pack._replace(probes=_set_rows(pack.probes, sl, new_probes),
                         sample_counts=_set_rows(pack.sample_counts, sl, new_counts))


def lightmap_irradiance(pack: LmPack, normal: torch.Tensor) -> torch.Tensor:
    """The baked SG probes' irradiance for display: normal [T, 3] (usually
    the embedded normals) -> [T, 3]."""
    return sg_irradiance(pack.axii, pack.probes, normal)


# ---------------------------------------------------------------------------
# Crate persistence (a resumable bake)
# ---------------------------------------------------------------------------


def lmpack_to_crate_entry(pack: LmPack) -> dict:
    def host(t):
        return t.detach().cpu().numpy()

    return {
        "version": LMPACK_VERSION,
        "size": pack.size,
        "texels_per_meter": pack.texels_per_meter,
        "position": host(pack.position),
        "normal": host(pack.normal),
        "probes": host(pack.probes),
        "sample_counts": host(pack.sample_counts),
        "axii": host(pack.axii),
    }


def lmpack_from_crate_entry(entry: dict, device="cuda") -> LmPack:
    """An LmPack from a crate entry, on `device`.  An entry without `axii`
    (the JAX package's checkpoint writes none) takes GI_AXII, the axes
    every pack is made with."""
    def dev_t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    return LmPack(
        size=int(entry["size"]),
        texels_per_meter=float(entry["texels_per_meter"]),
        position=dev_t(entry["position"]),
        normal=dev_t(entry["normal"]),
        probes=dev_t(entry["probes"]),
        sample_counts=dev_t(entry["sample_counts"]),
        axii=dev_t(entry["axii"] if "axii" in entry else GI_AXII),
    )
