"""Two-level cluster intersection: K4 (closest hit) and K5 (any hit).

Counterpart of `pim_tpu.render.cluster`.  The host build is the
reference's: a binned-SAH split of the triangle soup until each range fits
a cluster of CB = 128 slots (DFS order), 16 consecutive clusters to a
supercluster.  The layouts are the ones the builder emits:

  tris [13, C*CB] f32   BW rows 0-11 of each slot, row 12 the tri id as an
                        f32 (-1 on padding); cluster c = slots [c*CB, ...)
  clb  [6*S, 128] f32   row a*S + s, column j: component a (lox loy loz hix
                        hiy hiz) of cluster s*CPS + j
  scb  [8, Spad]  f32   rows lox..hiz of each supercluster (pad boxes are a
                        point at +BIG, which fails every slab test)

The reference culls per 512-ray block on the TPU (a cluster is tested when
any ray of the block needs it).  Here every ray is culled by its own slab
tests: superclusters against its static t_far, clusters against its running
best t (K4) or its t_far (K5), walked in slot order so the lowest slot wins
among equal t.  A lane whose own slab test rejects, by rounding, a box that
holds its hit may therefore differ from the reference; the tests count
those lanes.

For CUDA tensors the wrappers launch csrc/cluster_isect.cu; for CPU tensors
they run the plain torch versions below, which compute the same per-ray
result by brute force (BW over every slot, masked by the same slab tests).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pimbench.reference.frozen.math.vec3 import V3
from pimbench.reference.frozen.render.dense_kernels import _bw_test_plain, bw_rows

CB = 128           # triangles per cluster
CPS = 16           # clusters per supercluster
_BIG = 3.0e38
_PLAIN_RAY_CHUNK = 32768  # the port's 4096; the same rays, fewer host round trips
# The kernels test a cluster ray by ray (each lane its own slots, the ray
# broadcast) while fewer than this many of a warp's lanes enter it, and lane
# by lane (each lane its own ray over every real slot) from this many on.
# Both give the same bits; tools/cluster_variants.py --sweep times each
# value on e1m1's primary, bounce and shadow rays, where 24 came within
# 0.8% of the fastest value on each (PERF.md).  It is an argument of the
# kernels, not a constant of the .cu, so that chip_smoke.py can hold each
# way alone to the plain version on every ray set: on the tie scene most
# clusters would take one way only.
_PLAIN_CLUSTER_CHUNK = 8


class ClusterArrays(NamedTuple):
    tris: object   # [13, C*CB] f32 (numpy from the build, tensors in a scene)
    clb: object    # [6*S, 128] f32
    scb: object    # [8, Spad] f32


def dummy_cluster_arrays() -> ClusterArrays:
    """Placeholder for scenes on the dense backend (one empty supercluster
    whose boxes fail every slab test)."""
    tris0 = np.zeros((13, CB), np.float32)
    tris0[12, :] = -1.0
    scb = np.zeros((8, 8), np.float32)
    scb[0:6, :] = _BIG
    return ClusterArrays(tris=tris0, clb=np.full((6, 128), _BIG, np.float32), scb=scb)


# ---------------------------------------------------------------------------
# Host build (numpy)
# ---------------------------------------------------------------------------


def _split_until(idx: np.ndarray, tri_lo, tri_hi, centroids, cb: int, out):
    """Recursive binned-SAH split; stops the moment a range fits a cluster.
    Appends tri-index arrays to `out` in DFS order."""
    stack = [idx]
    while stack:
        cur = stack.pop()
        if len(cur) <= cb:
            out.append(cur)
            continue
        c = centroids[cur]
        lo = c.min(axis=0)
        hi = c.max(axis=0)
        ext = hi - lo
        axis = int(np.argmax(ext))
        mask = None
        if ext[axis] > 1e-12:
            nbins = 16
            scale = nbins * (1.0 - 1e-6) / ext[axis]
            bins = np.minimum(((c[:, axis] - lo[axis]) * scale).astype(np.int32), nbins - 1)
            counts = np.bincount(bins, minlength=nbins)
            blo = np.full((nbins, 3), np.inf, np.float32)
            bhi = np.full((nbins, 3), -np.inf, np.float32)
            for a in range(3):
                np.minimum.at(blo[:, a], bins, tri_lo[cur, a])
                np.maximum.at(bhi[:, a], bins, tri_hi[cur, a])

            def area(lo_, hi_):
                d = np.maximum(hi_ - lo_, 0.0)
                return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

            lcount = np.cumsum(counts)[:-1]
            rcount = counts.sum() - lcount
            llo = np.minimum.accumulate(blo, axis=0)[:-1]
            lhi = np.maximum.accumulate(bhi, axis=0)[:-1]
            rlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1][1:]
            rhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1][1:]
            cost = np.where((lcount > 0) & (rcount > 0),
                            area(llo, lhi) * lcount + area(rlo, rhi) * rcount,
                            np.inf)
            best = int(np.argmin(cost))
            if np.isfinite(cost[best]):
                mask = bins <= best
        if mask is None:
            med = np.argsort(c[:, axis], kind="stable")
            mask = np.zeros(len(cur), bool)
            mask[med[: len(cur) // 2]] = True
        # right pushed first so left is processed first (DFS order)
        stack.append(cur[~mask])
        stack.append(cur[mask])


def build_clusters(positions: np.ndarray) -> ClusterArrays:
    """Flat soup [V, 3] -> numpy cluster arrays (see the module doc)."""
    pos = np.asarray(positions, np.float32)
    tri_count = pos.shape[0] // 3
    if tri_count == 0:
        return dummy_cluster_arrays()

    tris = pos[: tri_count * 3].reshape(tri_count, 3, 3)
    tri_lo = tris.min(axis=1)
    tri_hi = tris.max(axis=1)
    centroids = (tri_lo + tri_hi) * 0.5

    groups: list = []
    _split_until(np.arange(tri_count, dtype=np.int64), tri_lo, tri_hi, centroids, CB, groups)

    c = len(groups)
    cpad = -(-c // CPS) * CPS
    bw = bw_rows(pos)  # [T, 12]

    tris_packed = np.zeros((cpad * CB, 13), np.float32)
    tris_packed[:, 12] = -1.0
    cb6 = np.full((6, cpad), _BIG, np.float32)  # point-at-+BIG: always fails
    for i, g in enumerate(groups):
        tris_packed[i * CB : i * CB + len(g), :12] = bw[g]
        tris_packed[i * CB : i * CB + len(g), 12] = g.astype(np.float32)
        cb6[0:3, i] = tri_lo[g].min(axis=0)
        cb6[3:6, i] = tri_hi[g].max(axis=0)

    n_sc = cpad // CPS
    clb = np.full((6 * n_sc, 128), _BIG, np.float32)
    for a in range(6):
        for si in range(n_sc):
            clb[a * n_sc + si, :CPS] = cb6[a, si * CPS : (si + 1) * CPS]

    spad = max(-(-n_sc // 8) * 8, 8)
    scb = np.zeros((8, spad), np.float32)
    scb[0:6, :] = _BIG
    for i in range(n_sc):
        cl = cb6[:, i * CPS : (i + 1) * CPS]
        real = cl[0, :] < _BIG * 0.5
        if real.any():
            scb[0:3, i] = cl[0:3, real].min(axis=1)
            scb[3:6, i] = cl[3:6, real].max(axis=1)

    return ClusterArrays(tris=np.ascontiguousarray(tris_packed.T), clb=clb, scb=scb)


# ---------------------------------------------------------------------------
# Plain torch versions (CPU path and the on-card reference)
# ---------------------------------------------------------------------------


def _safe_inv(x):
    return torch.where(torch.abs(x) > 1e-12, 1.0 / x, 1e12)


def _slab(box, ro, inv, t_near, bound):
    """Slab test; box [6, K] (lox..hiz), ro/inv 3-tuples of [n, 1], bound
    [n, 1] or None (open).  Returns (entry, exit) [n, K]."""
    entry = None
    exit_ = bound
    for a in range(3):
        t0 = (box[a][None, :] - ro[a]) * inv[a]
        t1 = (box[a + 3][None, :] - ro[a]) * inv[a]
        near = torch.minimum(t0, t1)
        far = torch.maximum(t0, t1)
        entry = torch.clamp_min(near, t_near) if entry is None else torch.maximum(entry, near)
        exit_ = far if exit_ is None else torch.minimum(exit_, far)
    return entry, exit_


def _cluster_boxes(clb: torch.Tensor) -> torch.Tensor:
    """clb [6*S, 128] -> [6, S*CPS] cluster boxes in slot order."""
    n_sc = clb.shape[0] // 6
    return clb[:, :CPS].reshape(6, n_sc * CPS)


def _cluster_cull(cl: ClusterArrays, ro: V3, rd: V3, t_near: float, t_far):
    """For [n] rays: (cand [n, C], entry [n, C]) where cand says the ray's
    supercluster and cluster slab tests pass against its t_far."""
    n_sc = cl.clb.shape[0] // 6
    o = (ro.x[:, None], ro.y[:, None], ro.z[:, None])
    inv = (_safe_inv(rd.x)[:, None], _safe_inv(rd.y)[:, None], _safe_inv(rd.z)[:, None])
    tf = t_far[:, None]
    e_s, x_s = _slab(cl.scb[:6, :n_sc], o, inv, t_near, tf)
    live_s = e_s <= x_s                                             # [n, S]
    e_c, x_c = _slab(_cluster_boxes(cl.clb), o, inv, t_near, tf)
    cand = (e_c <= x_c) & live_s.repeat_interleave(CPS, dim=1)      # [n, C]
    return cand, e_c


def _per_ray_t_far(t_far, n: int, dev) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(t_far, dtype=torch.float32, device=dev), (n,))


def _chunk_hits(cl: ClusterArrays, ro: V3, rd: V3, t_near: float, t_far, cand, c0, c1):
    """BW of every slot of clusters [c0, c1) against the rays: (t, lane) of
    each cluster's nearest hit with t < t_far (lowest lane on ties; t =
    BIG where none), [n, c1 - c0]."""
    rows = cl.tris[:12, c0 * CB : c1 * CB].T                         # [k*CB, 12]
    t, ok = _bw_test_plain(rows, ro, rd, t_near)                     # [k*CB, n]
    k = c1 - c0
    t = torch.where(ok & (t < t_far[None, :]) & cand.T.repeat_interleave(CB, dim=0), t, _BIG)
    t = t.T.reshape(-1, k, CB)
    tmin = torch.amin(t, dim=2)
    lane = torch.arange(CB, dtype=torch.int64, device=t.device)
    lmin = torch.amin(torch.where(t == tmin[..., None], lane, CB), dim=2)
    return tmin, lmin


def cluster_isect_plain(cl: ClusterArrays, ro: V3, rd: V3, t_near: float, t_far):
    """Plain K4: (t [N] f32, tri [N] i32)."""
    n = ro.x.shape[0]
    dev = ro.x.device
    t_far = _per_ray_t_far(t_far, n, dev)
    n_cl = cl.tris.shape[1] // CB
    t_out = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    tri_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ids = cl.tris[12]
    for r0 in range(0, n, _PLAIN_RAY_CHUNK):
        sl = slice(r0, min(r0 + _PLAIN_RAY_CHUNK, n))
        ro_c = V3(ro.x[sl], ro.y[sl], ro.z[sl])
        rd_c = V3(rd.x[sl], rd.y[sl], rd.z[sl])
        tf = t_far[sl]
        live = tf > 0.0
        cand, entry = _cluster_cull(cl, ro_c, rd_c, t_near, tf)
        cand = cand & live[:, None]
        m = torch.full(cand.shape, _BIG, dtype=torch.float32, device=dev)
        lane = torch.zeros(cand.shape, dtype=torch.int64, device=dev)
        for c0 in range(0, n_cl, _PLAIN_CLUSTER_CHUNK):
            c1 = min(c0 + _PLAIN_CLUSTER_CHUNK, n_cl)
            if not bool(cand[:, c0:c1].any()):
                continue
            m[:, c0:c1], lane[:, c0:c1] = _chunk_hits(cl, ro_c, rd_c, t_near, tf,
                                                      cand[:, c0:c1], c0, c1)
        # the walk in slot order: a cluster is entered when its slab entry
        # is within the running best t, and wins with a strictly nearer hit
        best = tf.clone()
        slot = torch.full_like(lane[:, 0], -1)
        for c in torch.nonzero(cand.any(dim=0)).flatten().tolist():
            upd = cand[:, c] & (entry[:, c] <= best) & (m[:, c] < best)
            best = torch.where(upd, m[:, c], best)
            slot = torch.where(upd, c * CB + lane[:, c], slot)
        found = slot >= 0
        t_out[sl] = torch.where(found, best, -1.0)
        tri_out[sl] = torch.where(found, ids[torch.clamp_min(slot, 0)].to(torch.int32), -1)
    return t_out, tri_out


def cluster_anyhit_plain(cl: ClusterArrays, ro: V3, rd: V3, t_near: float, t_far):
    """Plain K5: [N] i32 flag, 1 = blocked; dead rays (t_far <= 0) report 0."""
    n = ro.x.shape[0]
    dev = ro.x.device
    t_far = _per_ray_t_far(t_far, n, dev)
    n_cl = cl.tris.shape[1] // CB
    out = torch.zeros((n,), dtype=torch.int32, device=dev)
    for r0 in range(0, n, _PLAIN_RAY_CHUNK):
        sl = slice(r0, min(r0 + _PLAIN_RAY_CHUNK, n))
        ro_c = V3(ro.x[sl], ro.y[sl], ro.z[sl])
        rd_c = V3(rd.x[sl], rd.y[sl], rd.z[sl])
        tf = t_far[sl]
        cand, _ = _cluster_cull(cl, ro_c, rd_c, t_near, tf)
        cand = cand & (tf > 0.0)[:, None]
        hit = torch.zeros_like(tf, dtype=torch.bool)
        for c0 in range(0, n_cl, _PLAIN_CLUSTER_CHUNK):
            c1 = min(c0 + _PLAIN_CLUSTER_CHUNK, n_cl)
            if not bool(cand[:, c0:c1].any()):
                continue
            m, _ = _chunk_hits(cl, ro_c, rd_c, t_near, tf, cand[:, c0:c1], c0, c1)
            hit = hit | torch.any(m < _BIG, dim=1)
        out[sl] = hit.to(torch.int32)
    return out


# ---------------------------------------------------------------------------
# The benchmark reference's plain walk: the same per-ray results as
# cluster_isect_plain / cluster_anyhit_plain (the same slab tests, BW
# arithmetic and slot-order walk), computed on the (ray, cluster) pairs that
# pass the cull instead of on every slot of every cluster a chunk of rays
# touches, so that a full frame's rays take seconds, not minutes.
# ---------------------------------------------------------------------------

_PAIR_RAY_CHUNK = 65536
_PAIR_BLOCK = 1 << 17


def _pair_hits(cl: ClusterArrays, ro: V3, rd: V3, t_near: float, tf, ray, clu):
    """(t, lane) of each pair's nearest hit in its cluster with t < the
    ray's t_far (lowest lane on ties; BIG where none): `_chunk_hits` on one
    (ray, cluster) pair per row, the same op order."""
    n_cl = cl.tris.shape[1] // CB
    tris = cl.tris[:12].reshape(12, n_cl, CB)
    tmin = torch.empty(ray.shape[0], dtype=torch.float32, device=ray.device)
    lmin = torch.empty(ray.shape[0], dtype=torch.int64, device=ray.device)
    lane = torch.arange(CB, dtype=torch.int64, device=ray.device)
    for b0 in range(0, ray.shape[0], _PAIR_BLOCK):
        r = ray[b0:b0 + _PAIR_BLOCK]
        rows = tris[:, clu[b0:b0 + _PAIR_BLOCK], :]                       # [12, B, CB]
        nx, ny, nz, d, ux, uy, uz, uw, vx, vy, vz, vw = rows
        ox, oy, oz = ro.x[r][:, None], ro.y[r][:, None], ro.z[r][:, None]
        dx, dy, dz = rd.x[r][:, None], rd.y[r][:, None], rd.z[r][:, None]
        den = nx * dx + ny * dy + nz * dz
        num = d - (nx * ox + ny * oy + nz * oz)
        t = num / den
        px = ox + t * dx
        py = oy + t * dy
        pz = oz + t * dz
        u = ux * px + uy * py + uz * pz + uw
        v = vx * px + vy * py + vz * pz + vw
        ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_near)
        t = torch.where(ok & (t < tf[r][:, None]), t, _BIG)
        tm = torch.amin(t, dim=1)
        tmin[b0:b0 + _PAIR_BLOCK] = tm
        lmin[b0:b0 + _PAIR_BLOCK] = torch.amin(torch.where(t == tm[:, None], lane, CB), dim=1)
    return tmin, lmin


def _pairs(cl: ClusterArrays, ro: V3, rd: V3, t_near: float, tf):
    """(ray, cluster, slab entry) of every pair that passes the cull, in
    ray order and, within a ray, in slot order."""
    cand, entry = _cluster_cull(cl, ro, rd, t_near, tf)
    cand = cand & (tf > 0.0)[:, None]
    ray, clu = torch.nonzero(cand, as_tuple=True)
    return ray, clu, entry[ray, clu]


def cluster_isect_pairs(cl: ClusterArrays, ro: V3, rd: V3, t_near: float, t_far):
    """Plain K4 (cluster_isect_plain's results): (t [N] f32, tri [N] i32)."""
    n = ro.x.shape[0]
    dev = ro.x.device
    t_far = _per_ray_t_far(t_far, n, dev)
    t_out = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    tri_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ids = cl.tris[12]
    for r0 in range(0, n, _PAIR_RAY_CHUNK):
        sl = slice(r0, min(r0 + _PAIR_RAY_CHUNK, n))
        ro_c = V3(ro.x[sl], ro.y[sl], ro.z[sl])
        rd_c = V3(rd.x[sl], rd.y[sl], rd.z[sl])
        tf = t_far[sl]
        ray, clu, ent = _pairs(cl, ro_c, rd_c, t_near, tf)
        m, lane = _pair_hits(cl, ro_c, rd_c, t_near, tf, ray, clu)
        # the walk in slot order, one rank of every ray's pair list at a time
        counts = torch.bincount(ray, minlength=tf.shape[0])
        first = torch.cumsum(counts, 0) - counts
        rank = torch.arange(ray.shape[0], device=dev) - first[ray]
        order = torch.argsort(rank, stable=True)
        per_rank = torch.bincount(rank).tolist() if ray.numel() else []
        best = tf.clone()
        slot = torch.full_like(tf, -1, dtype=torch.int64)
        k0 = 0
        for cnt in per_rank:
            p = order[k0:k0 + cnt]
            k0 += cnt
            r = ray[p]
            b = best[r]
            upd = (ent[p] <= b) & (m[p] < b)
            best[r] = torch.where(upd, m[p], b)
            slot[r] = torch.where(upd, clu[p] * CB + lane[p], slot[r])
        found = slot >= 0
        t_out[sl] = torch.where(found, best, -1.0)
        tri_out[sl] = torch.where(found, ids[torch.clamp_min(slot, 0)].to(torch.int32), -1)
    return t_out, tri_out


def cluster_anyhit_pairs(cl: ClusterArrays, ro: V3, rd: V3, t_near: float, t_far):
    """Plain K5 (cluster_anyhit_plain's results): [N] i32, 1 = blocked."""
    n = ro.x.shape[0]
    dev = ro.x.device
    t_far = _per_ray_t_far(t_far, n, dev)
    out = torch.zeros((n,), dtype=torch.int32, device=dev)
    for r0 in range(0, n, _PAIR_RAY_CHUNK):
        sl = slice(r0, min(r0 + _PAIR_RAY_CHUNK, n))
        ro_c = V3(ro.x[sl], ro.y[sl], ro.z[sl])
        rd_c = V3(rd.x[sl], rd.y[sl], rd.z[sl])
        tf = t_far[sl]
        ray, clu, _ = _pairs(cl, ro_c, rd_c, t_near, tf)
        m, _ = _pair_hits(cl, ro_c, rd_c, t_near, tf, ray, clu)
        hit = torch.zeros_like(tf, dtype=torch.bool)
        hit[ray[m < _BIG]] = True
        out[sl] = hit.to(torch.int32)
    return out

# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def cluster_isect(cl: ClusterArrays, ro: V3, rd: V3, t_near: float, t_far):
    """K4 on [N] rays; t_far is an [N] tensor or one number for all rays.
    Returns (t [N] f32, tri [N] i32), -1 on a miss."""
    return cluster_isect_pairs(cl, ro, rd, t_near, t_far)


def cluster_anyhit(cl: ClusterArrays, ro: V3, rd: V3, t_near: float, t_far):
    """K5 on [N] rays: [N] i32 flag (1 = blocked; dead rays report 0)."""
    return cluster_anyhit_pairs(cl, ro, rd, t_near, t_far)

