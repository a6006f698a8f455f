"""Mrays/s of the intersection kernels against scene size: the dense/cluster crossover.

    python -m pim_tpu_torch.tools.bench_cluster [--n 262144] [--iters 20] [--device cuda|cpu]

Counterpart of `tools/bench_cluster.py`, on the card: K1 and K4 (closest
hit, t_far 1e9) and K2 and K5 (any hit, t_far 5.0) on procedural
multi-room soups of 180 to 277,056 triangles (`rooms_soup`, SOUPS), each
with a coherent (camera-like) and an incoherent (random) set of N rays
(`make_rays`); the two helpers are the JAX tool's, line for line.  The
dense kernels run at every soup: they take a table of any height, and the
JAX tool's 16,384-triangle cap was the TPU's.  The JAX tool's `xla-bvh`
column is not ported (the BVH intersector is on ROADMAP's "Do not port"
list: `intersect.py`, `geom/bvh.py`).

A kernel's time is its device time a call: one synchronised warm-up call,
then up to ITERS calls queued behind a GPU sleep between two CUDA events
(the device runs them back to back without waiting on the host).  It
prints Mrays/s for each kernel, soup and ray set, the share of rays on
which K4 gives K1's t and K5 gives K2's flag, and the measured crossover:
the smallest soup at which K4 beats K1 on both ray sets (and K5 K2).
It exits 1 unless K4 and K1 give the same t, and K5 and K2 the same flag,
on every ray.
`render/scene.py::DENSE_CROSSOVER_TRIS` is what the port uses; this tool
only measures.  `--device cpu` runs the plain versions (small N only: the
plain K4/K5 are brute force).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from pim_tpu_torch.tools import devtime

SOUPS = ((1, 1, 3), (2, 2, 4), (4, 3, 6), (6, 5, 8), (8, 8, 10), (12, 10, 12))
N_RAYS = 262144
ITERS = 20
T_FAR_CLOSEST = 1e9
T_FAR_ANYHIT = 5.0
TIMED_BUDGET_S = 0.25      # about this long a timing: fewer calls for slow kernels


def rooms_soup(rooms_x: int, rooms_y: int, sub: int, seed: int = 7) -> np.ndarray:
    """Multi-room interior soup: a rooms_x x rooms_y grid of 4x3x4 m rooms
    with door openings, floors/ceilings, each wall subdivided sub x sub.
    Returns [V, 3] f32 (V = 3*T)."""
    rng = np.random.default_rng(seed)
    quads = []  # (origin, edge_u, edge_v)
    rw, rh, rd_ = 4.0, 3.0, 4.0

    def wall(o, u, v):
        quads.append((np.asarray(o, np.float64), np.asarray(u, np.float64),
                      np.asarray(v, np.float64)))

    for ix in range(rooms_x):
        for iy in range(rooms_y):
            x0, z0 = ix * rw, iy * rd_
            # floor + ceiling
            wall([x0, 0, z0], [rw, 0, 0], [0, 0, rd_])
            wall([x0, rh, z0], [rw, 0, 0], [0, 0, rd_])
            # south wall with door gap (two segments)
            wall([x0, 0, z0], [rw * 0.4, 0, 0], [0, rh, 0])
            wall([x0 + rw * 0.6, 0, z0], [rw * 0.4, 0, 0], [0, rh, 0])
            # west wall with door gap
            wall([x0, 0, z0], [0, 0, rd_ * 0.4], [0, rh, 0])
            wall([x0, 0, z0 + rd_ * 0.6], [0, 0, rd_ * 0.4], [0, rh, 0])
            # a pillar
            px, pz = x0 + rw * 0.5, z0 + rd_ * 0.5
            wall([px, 0, pz], [0.4, 0, 0], [0, rh, 0])
            wall([px, 0, pz], [0, 0, 0.4], [0, rh, 0])
    # outer north / east closure
    wall([0, 0, rooms_y * rd_], [rooms_x * rw, 0, 0], [0, rh, 0])
    wall([rooms_x * rw, 0, 0], [0, 0, rooms_y * rd_], [0, rh, 0])

    tris = []
    for o, u, v in quads:
        for i in range(sub):
            for j in range(sub):
                a = o + u * (i / sub) + v * (j / sub)
                b = a + u / sub
                c = a + v / sub
                d = a + u / sub + v / sub
                # jitter interior verts slightly for irregularity
                tris.append([a, b, d])
                tris.append([a, d, c])
    pos = np.asarray(tris, np.float64).reshape(-1, 3)
    pos += rng.normal(0, 1e-4, pos.shape)
    return pos.astype(np.float32)


def make_rays(n, lo, hi, coherent: bool, seed=3):
    rng = np.random.default_rng(seed)
    if coherent:
        # pinhole camera in the middle of the scene looking +x
        eye = (lo + hi) * 0.5
        eye[1] = 1.6
        w = int(np.sqrt(n))
        ys, xs = np.meshgrid(np.linspace(-0.5, 0.5, w), np.linspace(-0.5, 0.5, w),
                             indexing="ij")
        d = np.stack([np.ones_like(xs), ys * 0.8, xs * 0.8], -1).reshape(-1, 3)
        d = np.concatenate([d, d[: n - d.shape[0]]], 0) if d.shape[0] < n else d[:n]
        ro = np.broadcast_to(eye, (n, 3)).astype(np.float32).copy()
    else:
        ro = (rng.random((n, 3)) * (hi - lo) * 0.9 + lo + 0.05 * (hi - lo))
        d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return ro.astype(np.float32), d


def _time_ms(fn, device: torch.device, iters: int):
    """(ms a call, whether the queued calls ran back to back): see the
    module docstring.  On the CPU, the host wall of `iters` calls."""
    t0 = time.perf_counter()
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3, True
    torch.cuda.synchronize(device)
    first = time.perf_counter() - t0
    return devtime.queued_ms(fn, max(3, min(iters, int(TIMED_BUDGET_S / max(first, 1e-6)))))


def _v3(a: np.ndarray, device: torch.device):
    from pim_tpu_torch.math.vec3 import V3

    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k])).to(device) for k in range(3)))


def run(device: torch.device, n: int = N_RAYS, iters: int = ITERS, soups=SOUPS) -> list:
    """One row a (soup, ray set): tris, rays ('coh' or 'inc'), ms and
    Mrays/s of K1, K4, K2 and K5, whether each timing ran back to back,
    and the shares of rays on which K4's t equals K1's and K5's flag K2's."""
    from pim_tpu_torch.render import cluster as CL
    from pim_tpu_torch.render.dense_kernels import dense_anyhit, dense_isect, pack_tris

    rows = []
    for rx, ry, sub in soups:
        pos = rooms_soup(rx, ry, sub)
        tris12 = torch.from_numpy(pack_tris(pos)).to(device)
        cl = CL.ClusterArrays(*(torch.from_numpy(a).to(device) for a in CL.build_clusters(pos)))
        lo, hi = pos.min(0), pos.max(0)
        for coherent in (True, False):
            ro_np, rd_np = make_rays(n, lo, hi, coherent)
            ro, rd = _v3(ro_np, device), _v3(rd_np, device)
            calls = {
                "k1": lambda: dense_isect(tris12, ro, rd, 0.0, T_FAR_CLOSEST),
                "k4": lambda: CL.cluster_isect(cl, ro, rd, 0.0, T_FAR_CLOSEST),
                "k2": lambda: dense_anyhit(tris12, ro, rd, 0.0, T_FAR_ANYHIT),
                "k5": lambda: CL.cluster_anyhit(cl, ro, rd, 0.0, T_FAR_ANYHIT),
            }
            row = {"tris": pos.shape[0] // 3, "rays": "coh" if coherent else "inc", "n": n}
            for name, fn in calls.items():
                ms, ahead = _time_ms(fn, device, iters)
                row[f"{name}_ms"] = ms
                row[f"{name}_mrays"] = n / (ms * 1e-3) / 1e6
                row[f"{name}_back_to_back"] = ahead
            t1, t4 = calls["k1"]()[0], calls["k4"]()[0]
            row["t_equal"] = float((t1 == t4).float().mean())
            row["anyhit_equal"] = float((calls["k2"]() == calls["k5"]()).float().mean())
            rows.append(row)
    return rows


def disagreements(rows) -> list:
    """The rows on which K4's t differs from K1's or K5's flag from K2's on
    some ray (the two pairs walk the same triangles with the same test)."""
    return [r for r in rows if r["t_equal"] != 1.0 or r["anyhit_equal"] != 1.0]


def crossover(rows, dense: str = "k1", cluster: str = "k4"):
    """The smallest soup (triangles) at which `cluster` beats `dense` on
    every ray set, or None."""
    by_tris = {}
    for r in rows:
        by_tris.setdefault(r["tris"], []).append(r[f"{cluster}_ms"] < r[f"{dense}_ms"])
    wins = [t for t, w in sorted(by_tris.items()) if all(w)]
    return wins[0] if wins else None


def table(rows) -> str:
    lines = [f"{'tris':>8} {'rays':>5} | {'K1 dense':>10} {'K4 cluster':>10} | "
             f"{'K2 dense':>10} {'K5 cluster':>10} | {'t equal':>8} {'hit equal':>9}   (Mrays/s; "
             "the JAX tool's xla-bvh column is not ported)"]
    for r in rows:
        lines.append(f"{r['tris']:>8} {r['rays']:>5} | {r['k1_mrays']:>10.2f} "
                     f"{r['k4_mrays']:>10.2f} | {r['k2_mrays']:>10.2f} {r['k5_mrays']:>10.2f} | "
                     f"{r['t_equal']:>8.4f} {r['anyhit_equal']:>9.4f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    from pim_tpu_torch.app import card, check_device
    from pim_tpu_torch.render.scene import DENSE_CROSSOVER_TRIS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N_RAYS)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    check_device(device)
    print(", ".join(str(c) for c in card(device)))
    rows = run(device, args.n, args.iters)
    print(table(rows))
    print(f"crossover (K4 beats K1 on both ray sets from): {crossover(rows)} tris; any hit (K5 "
          f"beats K2): {crossover(rows, 'k2', 'k5')} tris; DENSE_CROSSOVER_TRIS = "
          f"{DENSE_CROSSOVER_TRIS}")
    bad = disagreements(rows)
    if bad:
        print(f"FAIL: K4/K5 disagree with K1/K2 on {[(r['tris'], r['rays']) for r in bad]}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
