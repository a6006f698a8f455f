"""What the Moller-Trumbore kernels (csrc/mt_isect.cu) are checked on and
held against, shared by chip_smoke.py and tests/test_torch_intersect.py.

- Rays: `main_path_wavefronts` keeps the arguments one step of a `brute`
  or `bvh` scene hands the wrappers (`recorded_calls`).
- Bounds: the work a call needs, from this call's inputs, and the bytes of
  the scene it must read (the caller adds the rays and the outputs).
  `brute_work`: every live ray against every triangle (the closest hit),
  or the tests up to each live ray's first blocker in index order (the any
  hit); the triangles some ray reaches read once.  `bvh_work`: the plain
  walk's own count (`bvh_walk_plain` with `counts`) of nodes popped,
  children's entries and leaf slots tested; the distinct nodes and
  triangles it read, once each.  Operations a test as the kernels' source
  writes them (MT_TEST_OPS, SLAB_OPS, ENTRY_OPS), each product, sum,
  compare, select and the division one, plus a triangle's edges
  (EDGE_OPS) once for each distinct triangle read: they depend on the
  triangle alone.
- `flippable`: the rays on which a Moller-Trumbore compare lies near its
  limit, where another intersector's rounding may decide it the other way.
"""

from __future__ import annotations

import contextlib

import torch

# a test: the two cross products 18, det 5 and its test 2, the division 1,
# tvec 3, u, v and t 18 (a dot product 5, its scaling 1), the validity
# tests 6
MT_TEST_OPS = 53
EDGE_OPS = 6       # e1 = b - a, e2 = c - a: once a distinct triangle
# a popped node: 6 subtractions, 6 products, 6 per-axis min/max, 3 to the
# entry and 3 to the exit, the compare
SLAB_OPS = 25
# a child's entry: 6 subtractions, 6 products, 3 min, 3 max (one pair of
# children adds one compare)
ENTRY_OPS = 18
NODE_BYTES = 32    # lo, hi (24 bytes), a, b
TRI_BYTES = 40     # 9 floats of the soup, the tri_order slot
BRUTE_CHUNK = 512  # triangles a step of `brute_work`'s any-hit count
FLIP_PAIRS = 1 << 22  # (ray, triangle) pairs a block of `flippable`
BARY_TOL = 1e-4       # `flippable`: u, v or 1 - u - v this near 0
GRAZING_BARY_TOL = 1e-2  # ... at most, on a grazing ray (`other_formula`)
T_RTOL = 1e-5         # ... and t this near a limit or another t (relative)


@contextlib.contextmanager
def recorded_calls():
    """Within it, every call of the four MT wrappers through render/scene.py
    appends a copy of its rays (ro, rd, t_near, t_far) to the yielded
    {"isect": [...], "anyhit": [...]}."""
    from pim_tpu_torch.math.vec3 import V3
    from pim_tpu_torch.render import intersect as MT

    calls = {"isect": [], "anyhit": []}
    kept = {name: getattr(MT, name) for name in
            ("brute_isect", "brute_anyhit", "bvh_isect", "bvh_anyhit")}

    def recording(kind, fn, bvh: bool):
        def wrapper(*args):
            ro, rd, t_near, t_far = args[1 + bvh : 5 + bvh]
            calls[kind].append((V3(*(c.clone() for c in ro)), V3(*(c.clone() for c in rd)),
                                t_near, t_far.clone() if torch.is_tensor(t_far) else t_far))
            return fn(*args)
        return wrapper

    for name, fn in kept.items():
        setattr(MT, name, recording("anyhit" if "anyhit" in name else "isect", fn,
                                    name.startswith("bvh")))
    try:
        yield calls
    finally:
        for name, fn in kept.items():
            setattr(MT, name, fn)


def main_path_wavefronts(scene, scene_name: str, width: int = 512, height: int = 512) -> dict:
    """{"primary", "bounce", "shadow": (ro, rd, t_near, t_far)}: the rays one
    width x height, 1-bounce, 1-spp step of the scene's bench camera hands
    the closest-hit wrapper (its first and last calls) and the any-hit
    wrapper (its first call: the NEE shadow rays), copied."""
    from pim_tpu_torch.app import bench_camera, render_step

    with recorded_calls() as calls:
        render_step(scene, bench_camera(scene_name, width, height), width, height, 1, 1, 0)
    return {"primary": calls["isect"][0], "bounce": calls["isect"][-1],
            "shadow": calls["anyhit"][0]}


def brute_work(positions, ro, rd, t_near: float, t_far, anyhit: bool) -> dict:
    """{"tests", "tris_read", "ops", "scene_bytes"} of one brute-force call
    on these rays: the any hit reads the triangles up to the last first
    blocker of a live ray (all of them if one is not blocked)."""
    from pim_tpu_torch.math.vec3 import V3
    from pim_tpu_torch.render import intersect as MT

    n = ro.x.shape[0]
    t_count = positions.shape[0] // 3
    tf = MT.per_ray_t_far(t_far, n, ro.x.device)
    live = tf > t_near
    if not anyhit:
        tests = int(live.sum()) * t_count
        read = t_count if bool(live.any()) else 0
    else:  # the tests up to each live ray's first blocker, in index order
        first = torch.full((n,), t_count, dtype=torch.int64, device=ro.x.device)
        tris = positions[: t_count * 3].reshape(t_count, 3, 3)
        o = V3(*(c[:, None] for c in ro))
        d = V3(*(c[:, None] for c in rd))
        for c0 in range(0, t_count, BRUTE_CHUNK):
            tc = tris[c0 : c0 + BRUTE_CHUNK]
            a = V3(*(tc[None, :, 0, k] for k in range(3)))
            e1 = V3(*(tc[None, :, 1, k] - tc[None, :, 0, k] for k in range(3)))
            e2 = V3(*(tc[None, :, 2, k] - tc[None, :, 0, k] for k in range(3)))
            t, u, v, det = MT.moller_trumbore(o, d, a, e1, e2)
            ok = MT.valid_hit(t, u, v, det, t_near, tf[:, None])
            idx = torch.arange(c0, c0 + tc.shape[0], device=ro.x.device)
            first = torch.minimum(first, torch.where(ok, idx, t_count).amin(dim=1))
        reach = torch.where(live, torch.clamp_max(first + 1, t_count), 0)
        tests, read = int(reach.sum()), int(reach.max()) if n else 0
    return dict(tests=tests, tris_read=read, ops=tests * MT_TEST_OPS + read * EDGE_OPS,
                scene_bytes=read * 36)


def bvh_work(bvh, positions, ro, rd, t_near: float, t_far, max_leaf: int, anyhit: bool):
    """(the plain walk's output, {"nodes", "entries", "tris", "distinct_nodes",
    "distinct_tris", "ops", "scene_bytes"}) of one walk on these rays."""
    from pim_tpu_torch.render import intersect as MT

    counts = {}
    out = MT.bvh_walk_plain(bvh, positions, ro, rd, t_near, t_far, max_leaf, anyhit, counts)
    if anyhit:
        out = (out[1] >= 0).to(torch.int32)
    counts["ops"] = (counts["nodes"] * SLAB_OPS + counts["entries"] * ENTRY_OPS
                     + counts["entries"] // 2 + counts["tris"] * MT_TEST_OPS
                     + counts["distinct_tris"] * EDGE_OPS)
    counts["scene_bytes"] = (counts["distinct_nodes"] * NODE_BYTES
                             + counts["distinct_tris"] * TRI_BYTES)
    return out, counts


def _cross(x, y):
    """Cross products of broadcast [..., 3] rows."""
    return torch.stack([x[..., 1] * y[..., 2] - x[..., 2] * y[..., 1],
                        x[..., 2] * y[..., 0] - x[..., 0] * y[..., 2],
                        x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0]], -1)


def flippable(positions: torch.Tensor, ro: torch.Tensor, rd: torch.Tensor,
              t_far: torch.Tensor, other_formula: bool = False) -> torch.Tensor:
    """[n] bool: rays on which some triangle's Moller-Trumbore compare lies
    near its limit, in float64 (positions [3T, 3], ro and rd [n, 3], t_far
    [n]): u, v or 1 - u - v within BARY_TOL of 0 on a triangle the ray
    meets at t > 0, that t within T_RTOL of t_far, or two valid triangles'
    t within T_RTOL of each other.  Another rounding of the same test (FMA
    contraction) may take such a ray's triangle or flag the other way; a
    ray off these limits it may not.

    `other_formula`: the limits for another formula (Baldwin-Weber, K1/K2),
    which computes t from world coordinates: its error in t scales with
    the coordinates, so T_RTOL is taken of the larger of |t| and the ray
    origin's largest coordinate, and its error in u and v with 1 / cos of the angle of incidence, so
    BARY_TOL is divided by it (to at most GRAZING_BARY_TOL).  The rays go
    in blocks of about FLIP_PAIRS (ray, triangle) pairs."""
    tris = positions.to(torch.float64).reshape(-1, 3, 3)
    n, t_count = ro.shape[0], tris.shape[0]
    out = torch.zeros(n, dtype=torch.bool, device=ro.device)
    if n == 0 or t_count == 0:
        return out
    a = tris[None, :, 0]
    e1, e2 = tris[None, :, 1] - a, tris[None, :, 2] - a
    area2 = torch.linalg.vector_norm(_cross(e1, e2), dim=-1)
    block = max(1, FLIP_PAIRS // t_count)
    for r0 in range(0, n, block):
        o = ro[r0 : r0 + block, None].to(torch.float64)
        d = rd[r0 : r0 + block, None].to(torch.float64)
        tf = t_far[r0 : r0 + block, None].to(torch.float64)
        p = _cross(d, e2)
        det = (e1 * p).sum(-1)
        tv = o - a
        q = _cross(tv, e1)
        u = (tv * p).sum(-1) / det
        v = (d * q).sum(-1) / det
        t = (e2 * q).sum(-1) / det
        bary, t_scale = BARY_TOL, t.abs()
        if other_formula:
            cos = det.abs() / (torch.linalg.vector_norm(d, dim=-1) * area2)
            bary = torch.clamp_max(BARY_TOL / cos, GRAZING_BARY_TOL)
            t_scale = torch.maximum(t_scale, o.abs().amax(-1))
        t_tol = T_RTOL * t_scale
        near_edge = (u.abs() <= bary) | (v.abs() <= bary) | ((1.0 - u - v).abs() <= bary)
        near_t = (t - tf).abs() <= t_tol
        inside = (u >= -bary) & (v >= -bary) & (u + v <= 1.0 + bary) & (t > 0.0)
        near = inside & (near_edge | near_t)
        t_ok = torch.where(inside & (t < tf), t, float("inf"))
        t_min = t_ok.amin(1, keepdim=True)
        tie_scale = t_min.abs()
        if other_formula:
            tie_scale = torch.maximum(tie_scale, o.abs().amax(-1))
        ties = (((t_ok - t_min).abs() <= T_RTOL * tie_scale) & torch.isfinite(t_ok)).sum(1) > 1
        out[r0 : r0 + block] = near.any(1) | ties
    return out
