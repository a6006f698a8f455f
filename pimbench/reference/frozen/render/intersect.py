"""Moller-Trumbore intersectors: the `brute` and `bvh` backends.

Counterpart of `pim_tpu.render.intersect`:

- `brute`: every ray against every triangle of the flat soup, in index
  order (the reference's `lax.scan` over chunks of TRI_CHUNK triangles);
  the lowest index wins among equal t.
- `bvh`: the lockstep stack walk of the host-built SAH BVH (geom/bvh.py),
  STACK_DEPTH entries a ray, in the reference's order, which decides ties.

Each returns the walk's state (t, tri, u, v, det): t = t_far and tri = -1
on a miss, u, v and det of the hit triangle (0 on a miss); `_finalize_hit`
completes it into a `Hit` (ng from `positions`).  The any-hit forms return
an [N] i32 flag, 1 = blocked; a dead ray (t_far <= t_near) is never
blocked, as the reference's `t >= 0` of its closest hit.  t_near is one
number for all rays (every caller passes 0); t_far an [N] tensor or one
number.

For CUDA tensors the wrappers (`brute_isect`, `brute_anyhit`, `bvh_isect`,
`bvh_anyhit`) launch csrc/mt_isect.cu, one thread a ray, or raise; for CPU
tensors they run the plain torch versions below, written op by op
(`moller_trumbore`: each dot product (x0*y0 + x1*y1) + x2*y2), so that the
kernels equal them bit for bit.  The plain walk ends its trips with a host
sync (`.item()`); the kernels never sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pimbench.reference.frozen.geom.bvh import STACK_DEPTH, BvhArrays
from pimbench.reference.frozen.math.vec3 import V3, cross, dot

TRI_CHUNK = 512
_PLAIN_RAY_CHUNK = 32768  # rays a block of the plain brute-force scan


class Hit(NamedTuple):
    t: torch.Tensor        # [N] f32, <0 on miss
    tri: torch.Tensor      # [N] i32 triangle index, -1 on miss
    u: torch.Tensor        # [N] f32 barycentric u (weight of vertex B)
    v: torch.Tensor        # [N] f32 barycentric v (weight of vertex C)
    backface: torch.Tensor  # [N] bool
    ng: V3                 # unit geometric normal, faces the ray origin


def moller_trumbore(ro: V3, rd: V3, a: V3, e1: V3, e2: V3):
    """Two-sided Moller-Trumbore on broadcast SoA lanes: (t, u, v, det)."""
    p = cross(rd, e2)
    det = dot(e1, p)
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)  # no 0 * inf in the backward
    tv = ro - a
    u = dot(tv, p) * inv_det
    q = cross(tv, e1)
    v = dot(rd, q) * inv_det
    t = dot(e2, q) * inv_det
    return t, u, v, det


def valid_hit(t, u, v, det, t_near, lim):
    """Moller-Trumbore's acceptance: a non-degenerate triangle, the hit
    inside it, t in (t_near, lim)."""
    return ((torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > t_near) & (t < lim))


def tri_verts(positions: torch.Tensor, tri: torch.Tensor):
    """Vertices (a, b, c) of triangles `tri` (any shape) of the soup."""
    base = tri.to(torch.int64) * 3

    def vert(k):
        p = positions[base + k]
        return V3(p[..., 0], p[..., 1], p[..., 2])

    return vert(0), vert(1), vert(2)


def per_ray_t_far(t_far, n: int, dev) -> torch.Tensor:
    """t_far (an [N] tensor or one number) as an [N] float32 tensor; a
    number is filled on the device (no copy from the host, no sync)."""
    if isinstance(t_far, torch.Tensor):
        return torch.broadcast_to(t_far.to(device=dev, dtype=torch.float32), (n,))
    return torch.full((n,), float(t_far), dtype=torch.float32, device=dev)


def _miss_state(t_far: torch.Tensor):
    z = torch.zeros_like(t_far)
    return t_far.clone(), torch.full_like(t_far, -1, dtype=torch.int32), z, z.clone(), z.clone()


def _finalize_hit(positions: torch.Tensor, t, tri, u, v, det, t_far) -> Hit:
    """The walk's state -> a Hit: miss where tri < 0 or t >= t_far; ng from
    the triangle's vertices, unit length, flipped to face the ray."""
    miss = (tri < 0) | (t >= t_far)
    if positions.shape[0] == 0:
        z = torch.zeros_like(t)
        ng = V3(z, z, z)
    else:
        a, b, c = tri_verts(positions, torch.clamp_min(tri, 0))
        ng = cross(b - a, c - a)
    backface = det < 0.0
    inv_len = 1.0 / torch.sqrt(torch.clamp_min(dot(ng, ng), 1e-24))
    sign = torch.where(miss, 0.0, torch.where(backface, -inv_len, inv_len))
    return Hit(
        t=torch.where(miss, -1.0, t),
        tri=torch.where(miss, -1, tri),
        u=torch.where(miss, 0.0, torch.clamp(u, 0.0, 1.0)),
        v=torch.where(miss, 0.0, torch.clamp(v, 0.0, 1.0)),
        backface=backface & ~miss,
        ng=ng * sign,
    )


# ---------------------------------------------------------------------------
# Plain torch versions (CPU path and the on-card reference)
# ---------------------------------------------------------------------------


def brute_isect_plain(positions: torch.Tensor, ro: V3, rd: V3, t_near: float, t_far):
    """The reference's scan: chunks of TRI_CHUNK triangles, the first
    minimum t of each chunk taken where it is strictly nearer than the best
    so far.  Returns (t, tri, u, v, det)."""
    n = ro.x.shape[0]
    dev = ro.x.device
    tri_count = positions.shape[0] // 3
    t_far = per_ray_t_far(t_far, n, dev)
    best = _miss_state(t_far)
    if tri_count == 0 or n == 0:
        return best
    tris = positions[: tri_count * 3].reshape(tri_count, 3, 3)
    a_all = V3(*(tris[:, 0, k] for k in range(3)))
    e1_all = V3(*(tris[:, 1, k] - tris[:, 0, k] for k in range(3)))
    e2_all = V3(*(tris[:, 2, k] - tris[:, 0, k] for k in range(3)))
    chunk = min(TRI_CHUNK, tri_count)
    out = [x.clone() for x in best]
    for r0 in range(0, n, _PLAIN_RAY_CHUNK):
        sl = slice(r0, min(r0 + _PLAIN_RAY_CHUNK, n))
        ro_c = V3(*(c[sl, None] for c in ro))
        rd_c = V3(*(c[sl, None] for c in rd))
        bt, btri, bu, bv, bd = (x[sl] for x in best)
        rows = torch.arange(bt.shape[0], device=dev)
        for c0 in range(0, tri_count, chunk):
            cs = slice(c0, min(c0 + chunk, tri_count))
            t, u, v, det = moller_trumbore(ro_c, rd_c, V3(*(c[None, cs] for c in a_all)),
                                           V3(*(c[None, cs] for c in e1_all)),
                                           V3(*(c[None, cs] for c in e2_all)))
            t = torch.where(valid_hit(t, u, v, det, t_near, bt[:, None]), t, float("inf"))
            j = torch.argmin(t, dim=1)
            tj = t[rows, j]
            better = tj < bt
            btri = torch.where(better, (j + c0).to(torch.int32), btri)
            bu = torch.where(better, u[rows, j], bu)
            bv = torch.where(better, v[rows, j], bv)
            bd = torch.where(better, det[rows, j], bd)
            bt = torch.where(better, tj, bt)
        for o, x in zip(out, (bt, btri, bu, bv, bd)):
            o[sl] = x
    return tuple(out)


def brute_anyhit_plain(positions: torch.Tensor, ro: V3, rd: V3, t_near: float, t_far):
    """[N] i32, 1 where the closest-hit scan finds a triangle."""
    return (brute_isect_plain(positions, ro, rd, t_near, t_far)[1] >= 0).to(torch.int32)


def _slab(bvh: BvhArrays, node, ro: V3, inv: V3, t_near: float, bound):
    """(entry, exit) of the nodes' boxes: max(largest near plane, t_near)
    and min(smallest far plane, bound)."""
    lo = bvh.node_lo[node]
    hi = bvh.node_hi[node]
    near, far = [], []
    for k, (o, i) in enumerate(zip(ro, inv)):
        t0 = (lo[:, k] - o) * i
        t1 = (hi[:, k] - o) * i
        near.append(torch.minimum(t0, t1))
        far.append(torch.maximum(t0, t1))
    entry = torch.clamp_min(torch.maximum(torch.maximum(near[0], near[1]), near[2]), t_near)
    exit_ = torch.minimum(torch.minimum(torch.minimum(far[0], far[1]), far[2]), bound)
    return entry, exit_


def _safe_inv(x):
    return torch.where(torch.abs(x) > 1e-12, 1.0 / x, 1e12)


def bvh_walk_plain(bvh: BvhArrays, positions: torch.Tensor, ro: V3, rd: V3, t_near: float,
                   t_far, max_leaf: int, any_hit: bool, counts: dict = None):
    """The reference's lockstep walk (`_traverse`): each trip pops one node
    a ray, tests its box against the ray's best t, and pushes both children
    (far, then near) or tests the leaf's first max_leaf slots.  Trips run
    on the rays whose stacks are not empty, until none is (a host sync a
    trip).  Returns (t, tri, u, v, det).  With `counts`, adds to it the
    walk's work: "nodes" popped, "entries" of children computed, "tris"
    tested, and the "distinct_nodes" and "distinct_tris" it read."""
    n = ro.x.shape[0]
    dev = ro.x.device
    t_far = per_ray_t_far(t_far, n, dev)
    bt, btri, bu, bv, bd = _miss_state(t_far)
    inv = V3(*(_safe_inv(c) for c in rd))
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    order = bvh.tri_order.to(torch.int64)
    # a ray that cannot hit (t_far <= t_near) does not walk: the same result
    sp = (t_far > t_near).to(torch.int64)
    if order.shape[0] == 0:  # an empty scene: a root leaf of no triangle
        sp.zero_()
    node_a = bvh.node_a.to(torch.int64)
    node_b = bvh.node_b.to(torch.int64)
    k = torch.arange(max_leaf, device=dev)
    seen_nodes = torch.zeros(bvh.node_a.shape[0], dtype=torch.bool, device=dev)
    seen_tris = torch.zeros(max(order.shape[0], 1), dtype=torch.bool, device=dev)
    tally = dict(nodes=0, entries=0, tris=0)
    while True:
        idx = torch.nonzero(sp > 0).flatten()
        if idx.numel() == 0:
            break
        top = sp[idx] - 1
        node = stack[idx, top]
        sp[idx] = top
        o = V3(*(c[idx] for c in ro))
        d = V3(*(c[idx] for c in rd))
        iv = V3(*(c[idx] for c in inv))
        best = bt[idx]
        entry, exit_ = _slab(bvh, node, o, iv, t_near, best)
        hit_box = entry <= exit_
        na, nb = node_a[node], node_b[node]
        is_leaf = nb < 0
        if counts is not None:
            tally["nodes"] += idx.numel()
            seen_nodes[node] = True
        # internal: push both children, the near one on top
        push = hit_box & ~is_leaf
        if bool(push.any()):
            pi = torch.nonzero(push).flatten()
            ca, cb = na[pi], nb[pi]
            o_p, iv_p = V3(*(c[pi] for c in o)), V3(*(c[pi] for c in iv))
            ea, _ = _slab(bvh, ca, o_p, iv_p, t_near, best[pi])
            eb, _ = _slab(bvh, cb, o_p, iv_p, t_near, best[pi])
            a_first = ea <= eb
            rows = idx[pi]
            s = sp[rows]
            stack[rows, s] = torch.where(a_first, cb, ca)
            stack[rows, s + 1] = torch.where(a_first, ca, cb)
            sp[rows] = s + 2
            if counts is not None:
                tally["entries"] += 2 * pi.numel()
                seen_nodes[ca] = True
                seen_nodes[cb] = True
        # leaf: its first max_leaf slots, the first minimum t taken where it
        # is strictly nearer than the best so far
        leaf = hit_box & is_leaf
        if bool(leaf.any()):
            li = torch.nonzero(leaf).flatten()
            slot = na[li][:, None] + k[None, :]
            slot_ok = k[None, :] < torch.clamp_max(~nb[li], max_leaf)[:, None]
            tri = order[torch.clamp(slot, 0, order.shape[0] - 1)]
            a, b, c = tri_verts(positions, tri)
            lb = best[li]
            t, u, v, det = moller_trumbore(V3(*(x[li, None] for x in o)),
                                           V3(*(x[li, None] for x in d)), a, b - a, c - a)
            t = torch.where(slot_ok & valid_hit(t, u, v, det, t_near, lb[:, None]), t,
                            float("inf"))
            j = torch.argmin(t, dim=1)
            r = torch.arange(li.numel(), device=dev)
            tj = t[r, j]
            better = tj < lb
            rows = idx[li]
            btri[rows] = torch.where(better, tri[r, j].to(torch.int32), btri[rows])
            bu[rows] = torch.where(better, u[r, j], bu[rows])
            bv[rows] = torch.where(better, v[r, j], bv[rows])
            bd[rows] = torch.where(better, det[r, j], bd[rows])
            bt[rows] = torch.where(better, tj, bt[rows])
            if counts is not None:
                tally["tris"] += int(slot_ok.sum())
                seen_tris[tri[slot_ok]] = True
        if any_hit:
            # an occlusion query: a hit empties the ray's stack
            sp[idx] = torch.where(btri[idx] >= 0, 0, sp[idx])
    if counts is not None:
        for key, val in tally.items():
            counts[key] = counts.get(key, 0) + val
        counts["distinct_nodes"] = counts.get("distinct_nodes", 0) + int(seen_nodes.sum())
        counts["distinct_tris"] = counts.get("distinct_tris", 0) + int(seen_tris.sum())
    return bt, btri, bu, bv, bd


def bvh_isect_plain(bvh: BvhArrays, positions, ro: V3, rd: V3, t_near: float, t_far,
                    max_leaf: int = 4):
    """The closest-hit walk: (t, tri, u, v, det)."""
    return bvh_walk_plain(bvh, positions, ro, rd, t_near, t_far, max_leaf, False)


def bvh_anyhit_plain(bvh: BvhArrays, positions, ro: V3, rd: V3, t_near: float, t_far,
                     max_leaf: int = 4):
    """The any-hit walk: [N] i32, 1 = blocked."""
    tri = bvh_walk_plain(bvh, positions, ro, rd, t_near, t_far, max_leaf, True)[1]
    return (tri >= 0).to(torch.int32)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def brute_isect(positions: torch.Tensor, ro: V3, rd: V3, t_near: float, t_far):
    """Closest hit over every triangle of the soup: (t, tri, u, v, det)."""
    return brute_isect_plain(positions, ro, rd, t_near, t_far)


def brute_anyhit(positions: torch.Tensor, ro: V3, rd: V3, t_near: float, t_far):
    """Any hit over every triangle: [N] i32, 1 = blocked."""
    return brute_anyhit_plain(positions, ro, rd, t_near, t_far)


def bvh_isect(bvh: BvhArrays, positions: torch.Tensor, ro: V3, rd: V3, t_near: float, t_far,
              max_leaf: int = 4):
    """Closest hit through the BVH (tensors in a BvhArrays): (t, tri, u, v,
    det)."""
    return bvh_isect_plain(bvh, positions, ro, rd, t_near, t_far, max_leaf)


def bvh_anyhit(bvh: BvhArrays, positions: torch.Tensor, ro: V3, rd: V3, t_near: float, t_far,
               max_leaf: int = 4):
    """Any hit through the BVH: [N] i32, 1 = blocked."""
    return bvh_anyhit_plain(bvh, positions, ro, rd, t_near, t_far, max_leaf)


# the reference's public entry points, on AoS-free SoA rays


