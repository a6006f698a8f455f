"""What K4 and K5 are checked on and held against, shared by chip_smoke.py,
tests/test_torch_cluster.py and tools/cluster_variants.py.

- Rays: `main_path_wavefronts` keeps the arguments one e1m1 step hands the
  cluster wrappers (`recorded_calls`); `tie_soup`, `aimed_rays` and
  `with_padding_supercluster` make the tie scene (equal t across slots and
  clusters, an all-padding supercluster).
- References: `against_plain` holds the wrapper bit for bit against the
  plain version on a lane subset; `launcher` forces either of the kernels'
  ways of testing a cluster through the C interface; `walk_counts` replays
  the kernels' slot-order walk in torch and counts, per ray, the clusters
  and real-slot tests a traversal needs (the bound) and the slot tests a
  walk issues.

Every import of the package is made inside the function that needs it, so
tools/cluster_variants.py can load this file beside an older tree of the
package and drive that tree's wrappers.
"""

from __future__ import annotations

import contextlib

import torch

WALK_CHUNK = 16384  # rays replayed at a time (a multiple of 32)


@contextlib.contextmanager
def recorded_calls():
    """Within it, every call of cluster_isect and cluster_anyhit appends a
    copy of its arguments (ro, rd, t_near, t_far) to the yielded
    {"isect": [...], "anyhit": [...]}."""
    from pim_tpu_torch.math.vec3 import V3
    from pim_tpu_torch.render import cluster as CL

    calls = {"isect": [], "anyhit": []}
    kept = CL.cluster_isect, CL.cluster_anyhit

    def recording(kind, fn):
        def wrapper(cl, ro, rd, t_near, t_far):
            calls[kind].append((V3(*(c.clone() for c in ro)), V3(*(c.clone() for c in rd)),
                                t_near, t_far.clone() if torch.is_tensor(t_far) else t_far))
            return fn(cl, ro, rd, t_near, t_far)
        return wrapper

    CL.cluster_isect = recording("isect", kept[0])
    CL.cluster_anyhit = recording("anyhit", kept[1])
    try:
        yield calls
    finally:
        CL.cluster_isect, CL.cluster_anyhit = kept


def main_path_wavefronts(scene, width: int = 512, height: int = 512) -> dict:
    """{"primary", "bounce", "shadow": (ro, rd, t_near, t_far)}: the
    arguments that one width x height, 1-bounce, 1-spp step of the e1m1
    bench camera passes to cluster_isect (its first and its last call) and
    to cluster_anyhit (its first call), copied; in raysort's order, as the
    wrappers receive them."""
    from pim_tpu_torch.app import bench_camera, render_step

    with recorded_calls() as calls:
        render_step(scene, bench_camera("e1m1", width, height), width, height, 1, 1, 0)
    return {"primary": calls["isect"][0], "bounce": calls["isect"][-1],
            "shadow": calls["anyhit"][0]}


def outs(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def same_bits(got, want) -> bool:
    """Whether two tuples of float32 / int32 tensors are equal bit for bit."""
    return all(a.shape == b.shape and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
               for a, b in zip(got, want))


def against_plain(cl, args, anyhit: bool, lanes: int):
    """K4 (K5 with `anyhit`) through its wrapper on rays `args` (ro, rd,
    t_near, t_far): (its outputs on every lane, as a tuple; whether they
    equal the plain version's bit for bit on the first `lanes` lanes; their
    largest difference there)."""
    from pim_tpu_torch.math.vec3 import V3
    from pim_tpu_torch.render import cluster as CL

    ro, rd, t_near, t_far = args
    tf = CL._per_ray_t_far(t_far, ro.x.shape[0], ro.x.device)
    sub = slice(0, lanes)
    wrap, plain = ((CL.cluster_anyhit, CL.cluster_anyhit_plain) if anyhit
                   else (CL.cluster_isect, CL.cluster_isect_plain))
    got = outs(wrap(cl, ro, rd, t_near, t_far))
    want = outs(plain(cl, V3(*(c[sub] for c in ro)), V3(*(c[sub] for c in rd)), t_near, tf[sub]))
    head = tuple(a[sub] for a in got)
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(head, want))
    return got, same_bits(head, want), err


def launcher(anyhit: bool, cl, ro, rd, t_near, t_far, lane_loop_min: int):
    """fn() -> the outputs of K4 (or K5 with `anyhit`) launched through the
    C interface with the given lane_loop_min, as a tuple (no launch is
    counted): 1 tests every entered cluster lane by lane, 33 ray by ray."""
    from pim_tpu_torch import native
    from pim_tpu_torch.render import cluster as CL
    from pim_tpu_torch.render.dense_kernels import ray_args

    lib = native.load()
    dev = cl.tris.device
    head = CL._cluster_args(cl, "cluster_check", dev)
    n, args = ray_args(ro, rd, t_near, t_far, "cluster_check", dev)
    s = native.stream_ptr(dev)

    def run():
        if anyhit:
            hit = torch.empty((n,), dtype=torch.int32, device=dev)
            native.check(lib, lib.pim_cluster_anyhit(*head, *args, n, lane_loop_min,
                                                     hit.data_ptr(), s), "cluster_anyhit")
            return (hit,)
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        tri = torch.empty((n,), dtype=torch.int32, device=dev)
        native.check(lib, lib.pim_cluster_isect(*head, *args, n, lane_loop_min, t.data_ptr(),
                                                tri.data_ptr(), s), "cluster_isect")
        return t, tri

    return run


def real_slots(cl) -> torch.Tensor:
    """[C] int64: 1 + the last slot of each cluster whose tri id is >= 0
    (0 for a cluster of padding only), as the kernels count it."""
    from pim_tpu_torch.render.cluster import CB

    real = (cl.tris[12] >= 0.0).reshape(-1, CB)
    last = torch.where(real, torch.arange(1, CB + 1, device=real.device), 0)
    return last.amax(dim=1)


def walk_counts(cl, ro, rd, t_near, t_far, anyhit: bool, lane_loop_min: int) -> dict:
    """The slot-order walk of K4 (K5 with `anyhit`) on [N] rays, N a multiple
    of 32, replayed as the plain versions do (the brute-force BW of each
    candidate cluster, then the walk), with sums over the rays of:

      - "needed_clusters": the (ray, cluster) pairs any traversal must test:
        K4 the clusters a live ray's slabs enter no farther than its result
        (its hit, else t_far); K5 every cluster an unblocked ray enters
        before t_far, and for a blocked ray the first cluster that blocks it;
      - "needed_tests": the slot tests those pairs need: the real slots of
        each, but one test for a blocked ray (K5), which a single slot that
        blocks it proves;
      - "union_tests": the lane slot tests of a warp-union walk (a warp
        enters a cluster that any lane enters, and every lane runs its 128
        slots; K5 stops once every lane that entered is blocked);
      - "kernel_tests": the same for the kernels of csrc/cluster_isect.cu at
        `lane_loop_min`: ray by ray, a warp test over 32 slots a chunk of
        ceil(real / 32) for each entering lane; lane by lane, real slots
        (K5: until every lane that entered is blocked);
      - "warp_clusters" and "entering_lanes": the (warp, cluster) pairs
        entered and their lanes;
      - "slab_tests": the lane slab tests both walks issue: a warp tests
        each supercluster while any lane is live (K5: open), and the 16
        clusters of each supercluster whose slab any such lane enters.

    Also returns the walk's own results under "t" and "tri" (K4) or "hit"
    (K5), which the kernels must equal bit for bit."""
    from pim_tpu_torch.math.vec3 import V3
    from pim_tpu_torch.render import cluster as CL
    from pim_tpu_torch.render.dense_kernels import _bw_test_plain

    n = ro.x.shape[0]
    dev = ro.x.device
    t_far = CL._per_ray_t_far(t_far, n, dev)
    real = real_slots(cl)
    n_cl = real.shape[0]
    ids = cl.tris[12]
    keys = ("needed_clusters", "needed_tests", "union_tests", "kernel_tests", "warp_clusters",
            "entering_lanes", "slab_tests")
    n_sc = cl.clb.shape[0] // 6
    sc_no = torch.arange(n_sc, device=dev)
    sums = dict.fromkeys(keys, 0)
    out = {"t": torch.full((n,), -1.0, device=dev),
           "tri": torch.full((n,), -1, dtype=torch.int32, device=dev),
           "hit": torch.zeros((n,), dtype=torch.int32, device=dev)}
    slot_no = torch.arange(CL.CB, device=dev)
    for r0 in range(0, n, WALK_CHUNK):
        sl = slice(r0, min(r0 + WALK_CHUNK, n))
        ro_c, rd_c, tf = V3(*(c[sl] for c in ro)), V3(*(c[sl] for c in rd)), t_far[sl]
        m = tf.shape[0]
        live = tf > 0.0
        cand, entry = CL._cluster_cull(cl, ro_c, rd_c, t_near, tf)
        cand = cand & live[:, None]
        o = (ro_c.x[:, None], ro_c.y[:, None], ro_c.z[:, None])
        inv = tuple(CL._safe_inv(c)[:, None] for c in rd_c)
        e_s, x_s = CL._slab(cl.scb[:6, :n_sc], o, inv, t_near, tf[:, None])
        sc_pass = (e_s <= x_s) & live[:, None]                     # [m, S]
        cols = torch.nonzero(cand.any(dim=0)).flatten().tolist()
        # per candidate cluster: K4 its nearest hit below t_far (lowest slot
        # among equal t), K5 its first blocking slot (CB if none)
        first = torch.full((m, n_cl), CL.CB, dtype=torch.int64, device=dev)
        tmin = torch.full((m, n_cl), CL._BIG, device=dev)
        lmin = torch.zeros((m, n_cl), dtype=torch.int64, device=dev)
        for i in range(0, len(cols), 8):
            cs = torch.tensor(cols[i : i + 8], device=dev)
            slots = (cs[:, None] * CL.CB + slot_no).reshape(-1)
            t, ok = _bw_test_plain(cl.tris[:12, slots].T, ro_c, rd_c, t_near)  # [k*CB, m]
            ok = ok & (t < tf[None, :]) & cand[:, cs].T.repeat_interleave(CL.CB, dim=0)
            ok = ok.T.reshape(m, -1, CL.CB)
            t = torch.where(ok, t.T.reshape(m, -1, CL.CB), CL._BIG)
            tm = t.amin(dim=2)
            tmin[:, cs] = tm
            lmin[:, cs] = torch.where(t == tm[..., None], slot_no, CL.CB).amin(dim=2)
            first[:, cs] = torch.where(ok, slot_no, CL.CB).amin(dim=2)
        enter = torch.zeros_like(cand)
        if anyhit:
            open_ = live.clone()
            for c in cols:
                enter[:, c] = cand[:, c] & open_
                open_ = open_ & ~(enter[:, c] & (first[:, c] < CL.CB))
            blocked = live & ~open_
            out["hit"][sl] = blocked.to(torch.int32)
            first_block = torch.where(enter & (first < CL.CB), torch.arange(n_cl, device=dev),
                                      n_cl).amin(dim=1)
            need = (cand & ~blocked[:, None]) | (
                torch.arange(n_cl, device=dev)[None, :] == first_block[:, None])
            need_tests = torch.where(blocked[:, None], need.long(), need * real[None, :])
            # slots a lane that entered steps through before it is blocked
            steps = torch.where(first < CL.CB, first + 1, CL.CB)
            # a lane is open at the start of the supercluster that blocks it
            open_at = live[:, None] & (sc_no[None, :] <= torch.where(
                blocked, first_block // CL.CPS, n_sc)[:, None])
        else:
            best = tf.clone()
            slot = torch.full((m,), -1, dtype=torch.int64, device=dev)
            for c in cols:
                enter[:, c] = cand[:, c] & (entry[:, c] <= best)
                upd = enter[:, c] & (tmin[:, c] < best)
                best = torch.where(upd, tmin[:, c], best)
                slot = torch.where(upd, c * CL.CB + lmin[:, c], slot)
            found = slot >= 0
            out["t"][sl] = torch.where(found, best, -1.0)
            out["tri"][sl] = torch.where(found, ids[slot.clamp_min(0)].to(torch.int32), -1)
            need = cand & (entry <= best[:, None])
            need_tests = need * real[None, :]
            steps = torch.full_like(first, CL.CB)
            open_at = live[:, None].expand(-1, n_sc)
        sums["needed_clusters"] += int(need.sum())
        sums["needed_tests"] += int(need_tests.sum())
        # per (warp, cluster): the lanes that enter, and how far the slowest
        # of them steps (the union walk over 128 slots, the kernels over real ones)
        w_enter = enter.reshape(-1, 32, n_cl)
        p = w_enter.sum(dim=1)
        entered = p > 0
        union_steps = torch.where(w_enter, steps.reshape(-1, 32, n_cl), 0).amax(dim=1)
        lane_steps = torch.where(w_enter, torch.minimum(steps, real[None, :]).reshape(-1, 32, n_cl)
                                 if anyhit else real[None, None, :].expand_as(w_enter), 0
                                 ).amax(dim=1)
        chunks = (real[None, :] + 31) // 32
        by_ray = p * 32 * chunks
        kernel = torch.where(p < lane_loop_min, by_ray, 32 * lane_steps)
        sums["union_tests"] += int((32 * union_steps * entered).sum())
        sums["kernel_tests"] += int((kernel * entered).sum())
        sums["warp_clusters"] += int(entered.sum())
        sums["entering_lanes"] += int(p.sum())
        visited = open_at.reshape(-1, 32, n_sc).any(dim=1)
        cl_tested = (open_at & sc_pass).reshape(-1, 32, n_sc).any(dim=1)
        sums["slab_tests"] += 32 * int(visited.sum() + CL.CPS * cl_tested.sum())
    sums.update({k: out[k] for k in (("hit",) if anyhit else ("t", "tri"))})
    return sums


def tie_soup(distinct: int, copies: int, seed: int = 0, extent: float = 10.0):
    """A flat soup [3 * distinct * copies, 3] f32 of `distinct` random
    triangles, each repeated `copies` times, shuffled: equal copies land in
    different slots and clusters (tri ids not in slot order), so rays meet
    equal t there.  Also returns the base triangles [distinct, 3, 3]."""
    import numpy as np

    rs = np.random.default_rng(seed)
    a = rs.random((distinct, 3), np.float32) * extent
    e1 = (rs.random((distinct, 3), np.float32) - 0.5) * 2.0
    e2 = (rs.random((distinct, 3), np.float32) - 0.5) * 2.0
    base = np.stack([a, a + e1, a + e2], axis=1).astype(np.float32)
    soup = np.repeat(base, copies, axis=0)[rs.permutation(distinct * copies)]
    return soup.reshape(-1, 3), base


def aimed_rays(base, n: int, seed: int, extent: float = 10.0):
    """(ro [3, n], rd [3, n], t_far [n]) f32: seeded rays from the box
    [0, extent]^3 towards random points of the triangles `base` [K, 3, 3];
    ~10% dead lanes (t_far 0), t_far 1e6 on the others."""
    import numpy as np

    rs = np.random.default_rng(seed)
    ro = (rs.random((3, n)) * extent).astype(np.float32)
    k = rs.integers(0, len(base), n)
    u = rs.random(n)
    v = rs.random(n) * (1.0 - u)
    tgt = (base[k, 0] + u[:, None] * (base[k, 1] - base[k, 0])
           + v[:, None] * (base[k, 2] - base[k, 0]))
    d = tgt.T - ro
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    t_far = np.where(rs.random(n) < 0.1, 0.0, 1e6).astype(np.float32)
    return ro, d, t_far


def with_padding_supercluster(tris, clb, scb, at: int):
    """Numpy cluster arrays with one supercluster of padding slots only
    inserted before supercluster `at`: its box and its 16 cluster boxes are
    the whole scene's (every slab test a ray of the scene makes passes), its
    slots are padding (id -1, rows 0)."""
    import numpy as np

    from pim_tpu_torch.render.cluster import CB, CPS

    n_sc = clb.shape[0] // 6
    real = scb[0, :n_sc] < 1e30
    box = np.concatenate([scb[0:3, :n_sc][:, real].min(axis=1),
                          scb[3:6, :n_sc][:, real].max(axis=1)])
    pad = np.zeros((13, CPS * CB), np.float32)
    pad[12] = -1.0
    tris2 = np.concatenate([tris[:, : at * CPS * CB], pad, tris[:, at * CPS * CB :]], axis=1)
    clb3 = clb.reshape(6, n_sc, 128)
    row = np.full((6, 1, 128), 3.0e38, np.float32)
    row[:, 0, :CPS] = box[:, None]
    clb2 = np.concatenate([clb3[:, :at], row, clb3[:, at:]], axis=1).reshape(6 * (n_sc + 1), 128)
    spad = max(-(-(n_sc + 1) // 8) * 8, 8)
    scb2 = np.zeros((8, spad), np.float32)
    scb2[0:6, :] = 3.0e38
    scb2[:, :at] = scb[:, :at]
    scb2[0:6, at] = box
    scb2[:, at + 1 : n_sc + 1] = scb[:, at:n_sc]
    return tris2, clb2, scb2
