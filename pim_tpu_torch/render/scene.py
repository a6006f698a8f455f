"""The device-resident flat scene and its build.

Counterpart of `pim_tpu.render.scene`.  The scene is split into:

  SceneMeta   — static configuration (counts, grid dims, backend, feature
                flags);
  SceneArrays — the tensors the frame reads: the triangle soup (the MT
                backends), BW rows for K1/K2, the cluster hierarchy for
                K4/K5, the BVH (`bvh`), the fused [48, T] attribute table, the
                emissive table, the atlas corner planes and texture records
                (K6), the atlas parameter planes (K7, the differentiable
                path), the sky cube and its corner planes (K6), the
                light-grid activity and the BRDF LUT;
  LightState  — the per-cell light distributions (pdf, cdf, live histogram).

Four intersectors.  `auto` chooses `dense` (K1/K2,
render/dense_kernels.py) up to DENSE_CROSSOVER_TRIS triangles and `cluster`
(K4/K5, render/cluster.py) past it, as the reference chooses on its TPU.
`brute` and `bvh` (render/intersect.py, csrc/mt_isect.cu) are the JAX
package's Moller-Trumbore backends, its CPU choice: every triangle in
index order, and the lockstep walk of a SAH BVH.  They are taken only when
asked for (`build_scene(backend=...)`, the `pt_backend` cvar,
`from_jax_scene`).  Cluster traces sort their rays first where
`SceneMeta.sort_rays` says so (on the card).

No intersection kernel has a backward: ray origins, directions and t_far
are detached before any intersector (or its plain version) sees them.  The
hit distance t of a closest hit takes its gradient from the
Moller-Trumbore t computed on the hit triangle (`_finalize_hit_fused`;
the MT backends' `_carry_mt_grad`, which carries u and v as well), as the
JAX package's brute-force backend differentiates it; the values stay the
kernel's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from pim_tpu_torch.geom.bvh import BvhArrays, build_bvh, bvh_depth
from pim_tpu_torch.geom.bvh import STACK_DEPTH as BVH_STACK_DEPTH
from pim_tpu_torch.geom.entities import Entities, FlatScene, flatten
from pim_tpu_torch.geom.material import MatFlag, TexturePool
from pim_tpu_torch.render import cluster as CL
from pim_tpu_torch.core import profiler as prof
from pim_tpu_torch.core import rng
from pim_tpu_torch.math import dist1d
from pim_tpu_torch.math.brdf import bake_brdf_lut
from pim_tpu_torch.math.geometry import sd_triangle
from pim_tpu_torch.math.grid import GridSpec, grid_len, grid_position, make_grid
from pim_tpu_torch.math.sampling import hammersley_2d, sample_bary_coord, sample_unit_sphere
from pim_tpu_torch.math.vec3 import MILLI, RCP_EPS, V3, cross, dot, f32, where3
from pim_tpu_torch.render import fetch as F
from pim_tpu_torch.render import intersect as MT
from pim_tpu_torch.render.dense_kernels import intersect_dense_raw, occluded_dense, pack_tris
from pim_tpu_torch.render.intersect import Hit, moller_trumbore
from pim_tpu_torch.render.raysort import sorted_rays, unsort_rows
from pim_tpu_torch.render.sky import sky_corner_planes

# Past this many triangles the cluster kernels (K4/K5) take over from the
# dense ones (K1/K2).  This is the reference's crossover, measured on a TPU
# v5e.  On the H100 tools/bench_cluster.py measured 1,088 (K4 beats K1 and
# K5 beats K2 on both ray sets from there); the benchmark's decision sets
# the constant (ROADMAP item 25).
DENSE_CROSSOVER_TRIS = 8192
DEFAULT_CELLS_PER_METER = 1.0 / 1.5   # 1 / pt_dist_meters (default 1.5)
DEFAULT_BRDF_LUT_SAMPLES = 5120       # max(4096, r_brdflut_spf * 512), spf = 10

_SHADOW_BIAS = f32(np.float32(0.01) * np.float32(MILLI))
_DIST_TRI_CHUNK = 128  # triangles per [G, C] block of _min_dist_to_tris


@dataclass(frozen=True)
class SceneMeta:
    vert_count: int
    tri_count: int
    mat_count: int
    emissive_count: int
    grid_size: Tuple[int, int, int]
    grid_lo: Tuple[float, float, float]
    cells_per_meter: float
    has_sky: bool
    has_refractive: bool
    media_enabled: bool
    textured: bool
    has_normal_maps: bool
    backend: str = "dense"   # 'dense' (K1/K2) | 'cluster' (K4/K5) | 'brute' | 'bvh'
    max_leaf: int = 4        # triangles a BVH leaf holds at most (`bvh`)
    sort_rays: bool = False  # coherence-sort cluster traces (render/raysort.py)
    # the differentiable path (render/diff.py): the atlas and the sky are
    # sampled from their parameter planes through K7, and the refraction
    # probe's t carries its gradient
    differentiable: bool = False
    # the scene's medium (a render/media.py MediaDesc) where media are on;
    # None: make_media_desc()'s defaults
    media: Optional[tuple] = None

    @property
    def grid_len(self) -> int:
        return self.grid_size[0] * self.grid_size[1] * self.grid_size[2]

    def grid_spec(self) -> GridSpec:
        return GridSpec(lo=np.asarray(self.grid_lo, np.float32), size=self.grid_size,
                        cells_per_meter=self.cells_per_meter)


@dataclass
class SceneArrays:
    positions: torch.Tensor       # [V, 3] f32 triangle soup
    tris12: torch.Tensor          # [Tpad, 12] f32 Baldwin-Weber rows (pack_tris)
    tri_table: torch.Tensor       # [48, T] f32 fused attribute table (fetch.py rows)
    tri_to_emit: torch.Tensor     # [T] i32, -1 when not emissive
    emit_tris: torch.Tensor       # [E] i64 triangle of each emissive
    emissive_table: torch.Tensor  # [24, E] f32 compact NEE table (lights.E_* rows)
    cell_active: torch.Tensor     # [G] bool
    cell_active_f: torch.Tensor   # [1, G] f32
    brdf_lut: torch.Tensor        # [16, 16, 2] f32 over (NoV, alpha)
    cl_tris: torch.Tensor         # [13, C*128] f32 cluster BW rows + tri ids
    cl_clb: torch.Tensor          # [6*S, 128] f32 cluster boxes
    cl_scb: torch.Tensor          # [8, Spad] f32 supercluster boxes
    atlas_corners: torch.Tensor   # [16, H*W] f32 atlas corner planes (K6, C = 4)
    atlas_planes: torch.Tensor    # [4, H*W] f32 atlas channel planes (K7)
    tex_rec_t: torch.Tensor       # [5, Ntex] f32 (x0, y0, w, h, atlas width)
    sky: torch.Tensor             # [6, R, R, 3] f32 sky cube (R = 1, zeros: none)
    sky_corners: torch.Tensor     # [12, 6*R*R] f32 its corner planes (K6, C = 3)
    # the BVH (geom/bvh.py; one leaf of no triangle unless backend == 'bvh')
    bvh_lo: torch.Tensor          # [Nn, 3] f32
    bvh_hi: torch.Tensor          # [Nn, 3] f32
    bvh_a: torch.Tensor           # [Nn] i32 left child | first slot
    bvh_b: torch.Tensor           # [Nn] i32 right child | ~count
    tri_order: torch.Tensor       # [T] i32 leaf slots -> triangles


@dataclass
class LightState:
    pdf: torch.Tensor       # [G, E] f32
    cdf: torch.Tensor       # [G, E+1] f32
    integral: torch.Tensor  # [G] f32
    sum: torch.Tensor       # [G] i64 (the reference's uint32)
    live: torch.Tensor      # [G, E] i64 light-learning histogram


# ---------------------------------------------------------------------------
# Intersection
# ---------------------------------------------------------------------------


def _finalize_hit_fused(arrays: SceneArrays, t, tri, ro: V3, rd: V3) -> Hit:
    """Hit completion from one fused tri-table fetch (K3)."""
    rows = F.fetch_cols(arrays.tri_table, torch.clamp_min(tri, 0))
    a = F.v3_rows(rows, F.PA)
    b = F.v3_rows(rows, F.PB)
    c = F.v3_rows(rows, F.PC)
    t_mt, u, v, det = moller_trumbore(ro, rd, a, b - a, c - a)
    if t_mt.requires_grad:
        t = t + (t_mt - t_mt.detach())
    miss = tri < 0
    ng = cross(b - a, c - a)
    backface = det < 0.0
    inv_len = torch.rsqrt(torch.clamp_min(dot(ng, ng), 1e-24))
    sign = torch.where(backface, -inv_len, inv_len)
    ng = ng * sign
    zero = torch.zeros_like(t)
    return Hit(
        t=torch.where(miss, -1.0, t),
        tri=tri,
        u=torch.where(miss, 0.0, torch.clamp(u, 0.0, 1.0)),
        v=torch.where(miss, 0.0, torch.clamp(v, 0.0, 1.0)),
        backface=backface & ~miss,
        ng=where3(miss, V3(zero, zero, zero), ng),
    )


def _cluster_arrays(arrays: SceneArrays) -> CL.ClusterArrays:
    return CL.ClusterArrays(tris=arrays.cl_tris, clb=arrays.cl_clb, scb=arrays.cl_scb)


def _detached(*xs):
    """The intersectors' inputs, cut from the autograd graph."""
    return [V3(*(c.detach() for c in x)) if isinstance(x, V3)
            else x.detach() if isinstance(x, torch.Tensor) else x for x in xs]


def _bvh(arrays: SceneArrays) -> BvhArrays:
    return BvhArrays(arrays.bvh_lo, arrays.bvh_hi, arrays.bvh_a, arrays.bvh_b, arrays.tri_order)


def _mt_state(meta: SceneMeta, arrays: SceneArrays, ro: V3, rd: V3, t_near, t_far):
    """The MT backends' closest-hit state (t, tri, u, v, det), no gradient."""
    if meta.backend == "bvh":
        return MT.bvh_isect(_bvh(arrays), arrays.positions, ro, rd, t_near, t_far, meta.max_leaf)
    return MT.brute_isect(arrays.positions, ro, rd, t_near, t_far)


def _carry_mt_grad(arrays: SceneArrays, state, ro: V3, rd: V3):
    """The MT state with t, u and v taking their gradient from
    Moller-Trumbore recomputed on the hit triangle (values unchanged)."""
    t, tri, u, v, det = state
    if not any(c.requires_grad for c in (*ro, *rd)) or arrays.positions.shape[0] == 0:
        return state
    a, b, c = MT.tri_verts(arrays.positions, torch.clamp_min(tri, 0))
    t_mt, u_mt, v_mt, _ = moller_trumbore(ro, rd, a, b - a, c - a)
    return (t + (t_mt - t_mt.detach()), tri, u + (u_mt - u_mt.detach()),
            v + (v_mt - v_mt.detach()), det)


def _count_lanes(kind: str, n: int, t_far) -> None:
    """Counters `<kind>.lanes` and `<kind>.live` (the lanes with t_far > 0)
    of one intersection call, while tracing."""
    if not prof.tracing():
        return
    prof.count(kind + ".lanes", n)
    if isinstance(t_far, torch.Tensor):
        prof.count(kind + ".live", torch.broadcast_to(t_far > 0.0, (n,)).sum())
    else:
        prof.count(kind + ".live", n if t_far > 0.0 else 0)


@prof.spanned("pt.isect")
def intersect_raw(meta: SceneMeta, arrays: SceneArrays, ro: V3, rd: V3, t_near, t_far):
    """Closest hit through the scene's intersector: (t [N], tri [N] i32),
    -1 on a miss; neither carries a gradient."""
    _count_lanes("isect", ro.x.shape[0], t_far)
    return _intersect_raw(meta, arrays, ro, rd, t_near, t_far)


def _intersect_raw(meta: SceneMeta, arrays: SceneArrays, ro: V3, rd: V3, t_near, t_far):
    ro, rd, t_far = _detached(ro, rd, t_far)
    if meta.backend in ("brute", "bvh"):
        t, tri, *_ = _mt_state(meta, arrays, ro, rd, t_near, t_far)
        miss = (tri < 0) | (t >= MT.per_ray_t_far(t_far, ro.x.shape[0], ro.x.device))
        return torch.where(miss, -1.0, t), torch.where(miss, -1, tri)
    if meta.backend == "dense":
        return intersect_dense_raw(arrays.tris12, ro, rd, t_near, t_far)
    cl = _cluster_arrays(arrays)
    if not meta.sort_rays:
        return CL.cluster_isect(cl, ro, rd, t_near, t_far)
    ro_s, rd_s, tf_s, perm = sorted_rays(meta.grid_spec(), ro, rd, t_far)
    t, tri = CL.cluster_isect(cl, ro_s, rd_s, t_near, tf_s)
    return tuple(unsort_rows([t, tri], perm))


@prof.spanned("pt.isect")
def scene_intersect(meta: SceneMeta, arrays: SceneArrays, ro: V3, rd: V3,
                    t_near, t_far) -> Hit:
    _count_lanes("isect", ro.x.shape[0], t_far)
    if meta.backend in ("brute", "bvh"):
        dro, drd, dtf = _detached(ro, rd, t_far)
        state = _carry_mt_grad(arrays, _mt_state(meta, arrays, dro, drd, t_near, dtf), ro, rd)
        return MT._finalize_hit(arrays.positions, *state,
                                MT.per_ray_t_far(dtf, dro.x.shape[0], dro.x.device))
    t, tri = _intersect_raw(meta, arrays, ro, rd, t_near, t_far)
    return _finalize_hit_fused(arrays, t, tri, ro, rd)


@prof.spanned("pt.shadow")
def scene_occluded(meta: SceneMeta, arrays: SceneArrays, ro: V3, rd: V3,
                   t_near, t_far) -> torch.Tensor:
    """[N] bool, True where the segment is blocked (a dead ray, t_far <= 0:
    True through K2, False through K5 and the MT backends, as the
    reference's backends)."""
    _count_lanes("shadow", ro.x.shape[0], t_far)
    ro, rd, t_far = _detached(ro, rd, t_far)
    if meta.backend == "bvh":
        return MT.bvh_anyhit(_bvh(arrays), arrays.positions, ro, rd, t_near, t_far,
                             meta.max_leaf) > 0
    if meta.backend == "brute":
        return MT.brute_anyhit(arrays.positions, ro, rd, t_near, t_far) > 0
    if meta.backend == "dense":
        return occluded_dense(arrays.tris12, ro, rd, t_near, t_far)
    cl = _cluster_arrays(arrays)
    if not meta.sort_rays:
        return CL.cluster_anyhit(cl, ro, rd, t_near, t_far) > 0
    ro_s, rd_s, tf_s, perm = sorted_rays(meta.grid_spec(), ro, rd, t_far)
    return unsort_rows([CL.cluster_anyhit(cl, ro_s, rd_s, t_near, tf_s)], perm)[0] > 0


# ---------------------------------------------------------------------------
# Emissive detection and the compact emissive table (host numpy)
# ---------------------------------------------------------------------------


def _emission_pdf_host(flat: FlatScene, pool_atlas, pool_rec, attempts: int = 1000) -> np.ndarray:
    """Per-triangle emissive probability: fraction of random surface samples
    whose rome alpha is > 0."""
    tri_count = flat.mat_ids.shape[0]
    pdfs = np.zeros(tri_count, np.float32)
    rng_np = np.random.default_rng(0xE)
    uvs = flat.uvs.reshape(tri_count, 3, 2)
    for mat_idx in np.unique(flat.mat_ids):
        mat = flat.materials[mat_idx]
        sel = np.nonzero(flat.mat_ids == mat_idx)[0]
        if mat.flags & MatFlag.SKY:
            pdfs[sel] = 1.0
            continue
        if mat.rome_tex < 0:
            continue
        x0, y0, w, h = pool_rec[mat.rome_tex]
        tex = pool_atlas[y0 : y0 + h, x0 : x0 + w, 3]
        if w == 1 and h == 1:
            pdfs[sel] = 1.0 if tex[0, 0] > 0.0 else 0.0
            continue
        xi = rng_np.random((attempts, 2), dtype=np.float32)
        r1 = np.sqrt(np.maximum(xi[:, 0], 1e-12))
        u = r1 * (1 - xi[:, 1])
        v = xi[:, 1] * r1
        wgt = np.stack([1 - u - v, u, v], axis=-1)
        for ti in sel:
            uv = wgt @ uvs[ti]
            px = np.floor(uv[:, 0] * w).astype(np.int64) % w
            py = np.floor(uv[:, 1] * h).astype(np.int64) % h
            pdfs[ti] = (tex[py, px] > 0.0).mean()
    return pdfs


def build_emissive_table(flat: FlatScene, atlas, tex_rec,
                         emissive_tris: np.ndarray) -> np.ndarray:
    """Compact [24, E] NEE table (layout: lights.E_* rows)."""
    e = len(emissive_tris)
    t = np.zeros((max(e, 1), 24), np.float32)
    if e == 0:
        return np.ascontiguousarray(t.T)
    tri_count = flat.mat_ids.shape[0]
    pos = flat.positions.reshape(tri_count, 3, 3)
    uvs = flat.uvs.reshape(tri_count, 3, 2)
    p = pos[emissive_tris]
    t[:, 0:3] = p[:, 0]
    t[:, 3:6] = p[:, 1]
    t[:, 6:9] = p[:, 2]
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    t[:, 9] = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    t[:, 10] = emissive_tris.astype(np.float32)
    uv = uvs[emissive_tris]
    t[:, 14:16] = uv[:, 0]
    t[:, 16:18] = uv[:, 1]
    t[:, 18:20] = uv[:, 2]
    t[:, 20] = -1.0
    t[:, 21] = -1.0
    for k, ti in enumerate(emissive_tris):
        mat = flat.materials[flat.mat_ids[ti]]
        t[k, 22] = float(int(mat.flags))

        def texel(tex_id, default):
            if tex_id < 0:
                return np.asarray(default, np.float32)
            x0, y0, w, h = tex_rec[tex_id]
            if w == 1 and h == 1:
                return atlas[y0, x0]
            return None  # genuinely textured

        alb = texel(mat.albedo_tex, [1, 1, 1, 1])
        rom = texel(mat.rome_tex, [0.5, 1, 0, 0])
        if alb is not None:
            t[k, 11:14] = alb[:3]
        else:
            t[k, 20] = float(mat.albedo_tex)
        if rom is not None:
            t[k, 23] = rom[3]
        else:
            t[k, 21] = float(mat.rome_tex)
    return np.ascontiguousarray(t.T)


# ---------------------------------------------------------------------------
# Light grid bake (on the device, through K1, K2 and K3)
# ---------------------------------------------------------------------------


def _min_dist_to_tris(positions: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Unsigned min distance from each point [G, 3] to any triangle."""
    tri_count = positions.shape[0] // 3
    tris = positions[: tri_count * 3].reshape(tri_count, 3, 3)
    p3 = V3(points[:, 0, None], points[:, 1, None], points[:, 2, None])
    out = torch.full((points.shape[0],), float("inf"), dtype=torch.float32,
                     device=points.device)
    for c0 in range(0, tri_count, _DIST_TRI_CHUNK):
        tc = tris[c0 : c0 + _DIST_TRI_CHUNK]

        def vert(i):
            return V3(tc[None, :, i, 0], tc[None, :, i, 1], tc[None, :, i, 2])

        d = sd_triangle(vert(0), vert(1), vert(2), p3)  # [G, C]
        out = torch.minimum(out, torch.amin(d, dim=-1))
    return out


def bake_light_grid(meta: SceneMeta, arrays: SceneArrays) -> Tuple[torch.Tensor, LightState]:
    """Visibility-seeded per-cell light distributions."""
    g = meta.grid_len
    e = meta.emissive_count
    dev = arrays.tri_table.device
    grid = meta.grid_spec()
    radius = (1.0 / meta.cells_per_meter) * 0.666

    centers_aos = grid_position(grid, torch.arange(g, dtype=torch.int64, device=dev))

    if e == 0 or meta.tri_count == 0:
        ee = max(e, 1)
        return torch.zeros((g,), dtype=torch.bool, device=dev), LightState(
            pdf=torch.zeros((g, ee), dtype=torch.float32, device=dev),
            cdf=torch.zeros((g, ee + 1), dtype=torch.float32, device=dev),
            integral=torch.zeros((g,), dtype=torch.float32, device=dev),
            sum=torch.zeros((g,), dtype=torch.int64, device=dev),
            live=torch.zeros((g, ee), dtype=torch.int64, device=dev),
        )

    # interior test: near a surface, or most of 16 probe rays hit something
    dists = _min_dist_to_tris(arrays.positions, centers_aos)
    near_surface = dists <= radius
    hu, hv = hammersley_2d(torch.arange(16, dtype=torch.int64, device=dev), 16)
    hamm = sample_unit_sphere(hu, hv)
    centers = V3.from_aos(centers_aos)
    ro = V3(centers.x.repeat_interleave(16), centers.y.repeat_interleave(16),
            centers.z.repeat_interleave(16))
    rd = V3(hamm.x.repeat(g), hamm.y.repeat(g), hamm.z.repeat(g))
    hit = scene_intersect(meta, arrays, ro, rd, 0.0, RCP_EPS)
    hit_ratio = torch.mean((hit.t >= 0.0).reshape(g, 16).to(torch.float32), dim=-1)
    cell_active = near_surface | (hit_ratio >= 0.5)

    # visibility seeding: [G * E * S] shadow rays, chunked over cells; the
    # RNG is keyed by the global ray id, so chunking changes no ray
    s = 16

    def chunk_pdf(cell_idx: torch.Tensor) -> torch.Tensor:
        gc = cell_idx.shape[0]
        ray_id = (cell_idx[:, None] * (e * s)
                  + torch.arange(e * s, dtype=torch.int64, device=dev)).reshape(-1)
        key_state = rng.make_state(ray_id, 0, seed=0x11671)
        key_state, (ox, oy, oz, _) = rng.next_f32x4(key_state)
        key_state, (bu, bv) = rng.next_f32x2(key_state)

        def rep(x):
            return x[cell_idx].repeat_interleave(e * s)

        origins = V3(
            rep(centers.x) + (ox * 3.0 - 1.5) * radius,
            rep(centers.y) + (oy * 3.0 - 1.5) * radius,
            rep(centers.z) + (oz * 3.0 - 1.5) * radius,
        )
        tri = arrays.emit_tris.repeat(gc).repeat_interleave(s)  # [Gc*E*S]
        rows = F.fetch_cols(arrays.tri_table, tri)
        a = F.v3_rows(rows, F.PA)
        b = F.v3_rows(rows, F.PB)
        c = F.v3_rows(rows, F.PC)
        w_, u_, v_ = sample_bary_coord(bu, bv)
        target = a * w_ + b * u_ + c * v_
        delta = target - origins
        dist = torch.sqrt(torch.clamp_min(dot(delta, delta), 1e-12))
        rd2 = delta * (1.0 / dist)
        blocked = scene_occluded(meta, arrays, origins, rd2, 0.0, dist - _SHADOW_BIAS)
        vis = 1.0 - blocked.to(torch.float32)
        return torch.mean(vis.reshape(gc, e, s), dim=-1)

    max_rays = 4 << 20
    gc = max(1, min(g, max_rays // max(e * s, 1)))
    parts = [chunk_pdf(torch.arange(g0, min(g0 + gc, g), dtype=torch.int64, device=dev))
             for g0 in range(0, g, gc)]
    pdf = torch.cat(parts, dim=0) * cell_active[:, None].to(torch.float32)

    baked = dist1d.bake(pdf)
    return cell_active, LightState(
        pdf=baked.pdf, cdf=baked.cdf, integral=baked.integral, sum=baked.sum,
        live=torch.zeros((g, e), dtype=torch.int64, device=dev),
    )


# ---------------------------------------------------------------------------
# Full build
# ---------------------------------------------------------------------------


def _to_device(x, device, dtype) -> torch.Tensor:
    """A host array -> a contiguous tensor of `dtype` on `device` (copied)."""
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype).contiguous()


BACKENDS = ("dense", "cluster", "brute", "bvh")


def choose_backend(tri_count: int) -> str:
    """'dense' up to DENSE_CROSSOVER_TRIS triangles, 'cluster' past it (the
    MT backends are taken only when asked for)."""
    return "dense" if tri_count <= DENSE_CROSSOVER_TRIS else "cluster"


def one_leaf_bvh() -> BvhArrays:
    """The placeholder BVH of a scene whose backend is not 'bvh'."""
    return BvhArrays(np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
                     np.zeros(1, np.int32), np.full(1, ~0, np.int32),
                     np.zeros(0, np.int32))


def _resolve_sort_rays(sort_rays, backend: str, device: torch.device) -> bool:
    """None follows the pt_sort cvar, whose 'auto' sorts the cluster
    backend's traces on the card (the reference: on its TPU)."""
    if sort_rays is None:
        from pim_tpu_torch.core.cvars import cv_pt_sort

        mode = str(cv_pt_sort.get()).strip().lower()
        if mode in ("1", "true", "on"):
            return True
        if mode in ("0", "false", "off"):
            return False
        sort_rays = backend == "cluster" and device.type == "cuda"
    return bool(sort_rays)


def build_atlas_corner_planes(atlas: np.ndarray, tex_rec: np.ndarray) -> np.ndarray:
    """[16, H*W] corner planes of the atlas: rows corner*4 + channel for
    the corners (00, 10, 01, 11), each texel's right/down/diagonal
    neighbours clamped to its own sub-texture's edges, so K6 needs one
    index per fetch."""
    base = atlas
    right = atlas.copy()
    down = atlas.copy()
    diag = atlas.copy()
    for (x0, y0, tw, th) in np.asarray(tex_rec, np.int64).reshape(-1, 4):
        sub = atlas[y0 : y0 + th, x0 : x0 + tw]
        xs = np.minimum(np.arange(tw) + 1, tw - 1)
        ys = np.minimum(np.arange(th) + 1, th - 1)
        right[y0 : y0 + th, x0 : x0 + tw] = sub[:, xs]
        down[y0 : y0 + th, x0 : x0 + tw] = sub[ys, :]
        diag[y0 : y0 + th, x0 : x0 + tw] = sub[np.ix_(ys, xs)]
    out = np.concatenate([p.reshape(-1, 4).T for p in (base, right, down, diag)], axis=0)
    return np.ascontiguousarray(out, np.float32)


def texture_records_t(atlas: np.ndarray, tex_rec: np.ndarray) -> np.ndarray:
    """[5, Ntex] f32 records (x0, y0, w, h, atlas width) per texture."""
    rec_t = np.zeros((5, max(tex_rec.shape[0], 1)), np.float32)
    if tex_rec.shape[0] > 0:
        rec_t[:4] = tex_rec.T.astype(np.float32)
    rec_t[4] = float(atlas.shape[1])
    return rec_t


def build_scene(
    entities: Entities,
    pool: TexturePool,
    device,
    cells_per_meter: float = DEFAULT_CELLS_PER_METER,
    brdf_lut_samples: int = DEFAULT_BRDF_LUT_SAMPLES,
    backend: str = "auto",
    sky=None,
    sort_rays=None,
    media_enabled: bool = False,
    media=None,
) -> Tuple[SceneMeta, SceneArrays, LightState]:
    """Entities + textures -> (meta, device arrays, light state).

    backend: 'auto' (choose_backend), 'dense', 'cluster', 'brute' or 'bvh'
    (the BVH built by `geom.bvh.build_bvh`).  sky: a
    [6, R, R, 3] radiance cube, or None: then a scene with sky surfaces
    gets a black 1-texel cube, as the reference's.  sort_rays: None
    follows `_resolve_sort_rays`.  media_enabled: the integrator marches
    the participating medium (render/media.py); media: that medium's
    MediaDesc, which the scene carries to the integrator (None:
    make_media_desc()'s defaults).  The light grid is baked
    on `device`, so on the card the build already runs the intersection
    and fetch kernels."""
    device = torch.device(device)
    flat = flatten(entities)
    tri_count = flat.mat_ids.shape[0]
    if backend == "auto":
        backend = choose_backend(tri_count)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the port has 'auto', 'dense', 'cluster', "
                         "'brute' and 'bvh'")
    atlas, tex_rec = pool.pack()

    pdfs = _emission_pdf_host(flat, atlas, tex_rec)
    emissive_tris = np.nonzero(pdfs > 0.01)[0].astype(np.int32)
    tri_to_emit = np.full(max(tri_count, 1), -1, np.int32)
    tri_to_emit[emissive_tris] = np.arange(len(emissive_tris), dtype=np.int32)

    if tri_count > 0:
        lo = flat.positions.min(axis=0)
        hi = flat.positions.max(axis=0)
    else:
        lo = np.zeros(3, np.float32)
        hi = np.ones(3, np.float32)
    grid = make_grid(lo, hi, cells_per_meter)
    lut = bake_brdf_lut(num_samples=brdf_lut_samples, device=device)

    if sky is None:
        sky_t = torch.zeros((6, 1, 1, 3), dtype=torch.float32, device=device)
        has_sky = any(m.flags & MatFlag.SKY for m in flat.materials)
    else:
        sky_t = (sky.to(device=device, dtype=torch.float32).contiguous()
                 if isinstance(sky, torch.Tensor) else _to_device(sky, device, torch.float32))
        has_sky = True

    meta = SceneMeta(
        vert_count=flat.positions.shape[0],
        tri_count=tri_count,
        mat_count=len(flat.materials),
        emissive_count=len(emissive_tris),
        grid_size=grid.size,
        grid_lo=tuple(float(v) for v in grid.lo),
        cells_per_meter=float(cells_per_meter),
        has_sky=has_sky,
        has_refractive=any(m.flags & MatFlag.REFRACTIVE for m in flat.materials),
        media_enabled=bool(media_enabled),
        textured=any(
            (m.albedo_tex >= 0 and tuple(tex_rec[m.albedo_tex][2:]) != (1, 1))
            or (m.rome_tex >= 0 and tuple(tex_rec[m.rome_tex][2:]) != (1, 1))
            for m in flat.materials
        ),
        has_normal_maps=any(m.normal_tex >= 0 for m in flat.materials),
        backend=backend,
        sort_rays=_resolve_sort_rays(sort_rays, backend, device),
        media=media,
    )

    def dev_t(x, dtype=torch.float32):
        return _to_device(x, device, dtype)

    cluster = CL.build_clusters(flat.positions) if backend == "cluster" \
        else CL.dummy_cluster_arrays()
    bvh = build_bvh(flat.positions) if backend == "bvh" else one_leaf_bvh()
    g = grid_len(grid)
    arrays = SceneArrays(
        positions=dev_t(flat.positions),
        tris12=dev_t(pack_tris(flat.positions)),
        tri_table=dev_t(F.build_tri_table(flat, flat.materials, tri_to_emit, atlas, tex_rec)),
        tri_to_emit=dev_t(tri_to_emit[: max(tri_count, 1)], torch.int32),
        emit_tris=dev_t(emissive_tris, torch.int64),
        emissive_table=dev_t(build_emissive_table(flat, atlas, tex_rec, emissive_tris)),
        cell_active=torch.zeros((g,), dtype=torch.bool, device=device),
        cell_active_f=torch.zeros((1, g), dtype=torch.float32, device=device),
        brdf_lut=lut.texels,
        cl_tris=dev_t(cluster.tris),
        cl_clb=dev_t(cluster.clb),
        cl_scb=dev_t(cluster.scb),
        atlas_corners=dev_t(build_atlas_corner_planes(atlas, tex_rec)),
        atlas_planes=dev_t(np.ascontiguousarray(atlas.reshape(-1, 4).T)),
        tex_rec_t=dev_t(texture_records_t(atlas, tex_rec)),
        sky=sky_t,
        sky_corners=sky_corner_planes(sky_t),
        **_bvh_fields(bvh, dev_t),
    )
    cell_active, light_state = bake_light_grid(meta, arrays)
    arrays = dataclasses.replace(
        arrays, cell_active=cell_active,
        cell_active_f=cell_active.to(torch.float32).reshape(1, -1))
    return meta, arrays, light_state


def _bvh_fields(bvh: BvhArrays, dev_t) -> dict:
    return dict(bvh_lo=dev_t(bvh.node_lo), bvh_hi=dev_t(bvh.node_hi),
                bvh_a=dev_t(bvh.node_a, torch.int32), bvh_b=dev_t(bvh.node_b, torch.int32),
                tri_order=dev_t(bvh.tri_order, torch.int32))


_JAX_BACKENDS = {"pallas": "dense", "cluster": "cluster", "brute": "brute", "bvh": "bvh"}


def from_jax_scene(meta_fields: dict, arrays_np: dict, lights_np: dict,
                   device) -> Tuple[SceneMeta, SceneArrays, LightState]:
    """The JAX package's (SceneMeta, SceneArrays, LightState), given as
    `dataclasses.asdict(meta)` and `{field: numpy array}` dicts, -> the
    port's, so both packages can render the identical scene.

    The JAX backends map to the port's: 'pallas' -> 'dense', 'cluster',
    'brute' and 'bvh' to themselves.  The BVH arrays and `max_leaf` are
    carried (the JAX package builds a BVH for every backend); a tree deeper
    than the port's walk's stack is refused.  `tris9` holds the [Tpad, 12]
    BW rows (whatever its field comment says); fields the port does not
    read (slot_tri, normals, uvs) are not carried."""
    device = torch.device(device)
    backend = _JAX_BACKENDS.get(meta_fields["backend"])
    if backend is None:
        raise NotImplementedError(
            f"JAX backend {meta_fields['backend']!r}: the port has 'dense' (from 'pallas'), "
            "'cluster', 'brute' and 'bvh'")
    bvh = BvhArrays(*(np.asarray(arrays_np[k]) for k in
                      ("bvh_lo", "bvh_hi", "bvh_a", "bvh_b", "tri_order")))
    depth = bvh_depth(bvh)
    if depth > BVH_STACK_DEPTH:
        raise ValueError(f"the JAX scene's BVH has depth {depth}: the port's walk holds "
                         f"{BVH_STACK_DEPTH}")
    e = int(meta_fields["emissive_count"])

    def dev_t(x, dtype=torch.float32):
        return _to_device(x, device, dtype)

    meta = SceneMeta(
        vert_count=int(meta_fields["vert_count"]),
        tri_count=int(meta_fields["tri_count"]),
        mat_count=int(meta_fields["mat_count"]),
        emissive_count=e,
        grid_size=tuple(int(s) for s in meta_fields["grid_size"]),
        grid_lo=tuple(float(v) for v in np.asarray(arrays_np["grid_lo"], np.float32)),
        cells_per_meter=float(meta_fields["cells_per_meter"]),
        has_sky=bool(meta_fields["has_sky"]),
        has_refractive=bool(meta_fields["has_refractive"]),
        media_enabled=bool(meta_fields["media_enabled"]),
        textured=bool(meta_fields["textured"]),
        has_normal_maps=bool(meta_fields["has_normal_maps"]),
        backend=backend,
        max_leaf=int(meta_fields["max_leaf"]),
        sort_rays=bool(meta_fields["sort_rays"]),
    )
    sky = dev_t(arrays_np["sky"])
    arrays = SceneArrays(
        positions=dev_t(arrays_np["positions"]),
        tris12=dev_t(arrays_np["tris9"]),
        tri_table=dev_t(arrays_np["tri_table"]),
        tri_to_emit=dev_t(arrays_np["tri_to_emit"], torch.int32),
        emit_tris=dev_t(np.asarray(arrays_np["emit_to_tri_f"])[0, :e], torch.int64),
        emissive_table=dev_t(arrays_np["emissive_table"]),
        cell_active=dev_t(arrays_np["cell_active"], torch.bool),
        cell_active_f=dev_t(arrays_np["cell_active_f"]),
        brdf_lut=dev_t(arrays_np["brdf_lut"]),
        cl_tris=dev_t(arrays_np["cl_tris"]),
        cl_clb=dev_t(arrays_np["cl_clb"]),
        cl_scb=dev_t(arrays_np["cl_scb"]),
        atlas_corners=dev_t(arrays_np["atlas_corners"]),
        atlas_planes=dev_t(arrays_np["atlas_planes"]),
        tex_rec_t=dev_t(arrays_np["tex_rec_t"]),
        sky=sky,
        sky_corners=sky_corner_planes(sky),
        **_bvh_fields(bvh, dev_t),
    )
    lights = LightState(
        pdf=dev_t(lights_np["pdf"]),
        cdf=dev_t(lights_np["cdf"]),
        integral=dev_t(lights_np["integral"]),
        sum=dev_t(np.asarray(lights_np["sum"]).astype(np.int64), torch.int64),
        live=dev_t(np.asarray(lights_np["live"]).astype(np.int64), torch.int64),
    )
    return meta, arrays, lights


def update_light_state(state: LightState) -> LightState:
    """The per-frame fold of the live histograms into the light pdfs."""
    d = dist1d.Dist1D(pdf=state.pdf, cdf=state.cdf, integral=state.integral, sum=state.sum)
    d2, live2 = dist1d.update(d, state.live)
    return LightState(pdf=d2.pdf, cdf=d2.cdf, integral=d2.integral, sum=d2.sum, live=live2)
