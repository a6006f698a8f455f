"""What K1 and K2 are checked on, shared by chip_smoke.py,
tests/test_torch_dense_check.py and tools/dense_variants.py:
`recorded_calls` keeps a copy of the arguments that the main path hands
dense_isect (K1) and dense_anyhit (K2); `main_path_calls` records those of
sample 0 of one Cornell serving step (the primary rays, then one
closest-hit call and one shadow-ray call a bounce, dead lanes carrying
t_far = 0); `bake_calls` those of the Cornell scene build (the light-grid
bake); `random_rays` makes seeded rays inside the Cornell box; `tie_scene`
makes rows with coincident triangles and rays aimed at them, `wide_scene`
rows of distinct triangles spread so thin that a ray's first blocker may
lie in any chunk of rows; `anyhit_tests` counts the tests K2 needs;
`K2_FORMS` forces each of K2's two forms.

Every import of the package is made inside the function that needs it, so
tools/dense_variants.py can load this file beside an older tree of the
package and drive that tree's wrappers.
"""

from __future__ import annotations

import contextlib

import torch

# warp_below values that force K2's two forms (a tile holds 512 rays)
K2_FORMS = {"ray a thread": 0, "ray a warp": 513}


@contextlib.contextmanager
def recorded_calls(limit: int = 1 << 30):
    """Within it, each of the first `limit` calls of dense_isect and of
    dense_anyhit appends a copy of its arguments (tris12, ro, rd, t_near,
    t_far) to the yielded {"isect": [...], "anyhit": [...]}."""
    from pim_tpu_torch.math.vec3 import V3
    from pim_tpu_torch.render import dense_kernels as dk

    calls = {"isect": [], "anyhit": []}
    kept = dk.dense_isect, dk.dense_anyhit

    def recording(kind, fn):
        def wrapper(tris12, ro, rd, t_near, t_far):
            if len(calls[kind]) < limit:
                calls[kind].append((tris12, V3(*(c.clone() for c in ro)),
                                    V3(*(c.clone() for c in rd)), t_near,
                                    t_far.clone() if torch.is_tensor(t_far) else t_far))
            return fn(tris12, ro, rd, t_near, t_far)
        return wrapper

    dk.dense_isect = recording("isect", kept[0])
    dk.dense_anyhit = recording("anyhit", kept[1])
    try:
        yield calls
    finally:
        dk.dense_isect, dk.dense_anyhit = kept


def main_path_calls(scene, width: int = 512, height: int = 512, bounces: int = 10) -> dict:
    """{"isect": [...], "anyhit": [...]}: the K1 and K2 calls of sample 0
    of one width x height, `bounces`-bounce step of the Cornell bench camera
    (a 16-spp step's first sample has sample id 0 too, so its rays are
    these), as the wrappers receive them: K1's primary rays first, then
    one call a bounce."""
    from pim_tpu_torch.app import bench_camera, render_step

    with recorded_calls(bounces + 1) as calls:
        render_step(scene, bench_camera("cornell", width, height), width, height, bounces, 1, 0)
    return calls


def bake_calls(dev) -> list:
    """The K2 calls of the Cornell scene build on `dev` (the light-grid
    bake), as the wrapper receives them."""
    from pim_tpu_torch.app import build_cornell_scene

    with recorded_calls() as calls:
        build_cornell_scene(dev)
    return calls["anyhit"]


def anyhit_tests(tris12, ro, rd, t_near, t_far) -> torch.Tensor:
    """[N] int64: the Baldwin-Weber tests K2 needs for each ray against the
    rows `tris12`, in row order up to its first blocker (every row where
    none blocks), 0 for a dead ray (t_far <= 0)."""
    from pim_tpu_torch.render.dense_kernels import _bw_test_plain

    n = ro.x.shape[0]
    t_far = torch.as_tensor(t_far, dtype=torch.float32, device=ro.x.device).expand(n)
    rows = tris12.shape[0]
    first = torch.full((n,), rows, dtype=torch.int64, device=ro.x.device)
    for c0 in range(0, rows, 64):
        t, ok = _bw_test_plain(tris12[c0 : c0 + 64], ro, rd, t_near)
        blk = ok & (t < t_far)
        at = torch.where(blk.any(dim=0), blk.to(torch.uint8).argmax(dim=0) + c0 + 1, rows)
        first = torch.minimum(first, at)
    return torch.where(t_far <= 0.0, 0, first)


N = 262_144


def random_rays(dev, seed: int = 1234):
    """(ro, rd, t_far) of N seeded rays inside the Cornell box: ~10% dead
    lanes plus the fully dead run [10240, 12288)."""
    import numpy as np

    from pim_tpu_torch.math.vec3 import V3

    rs = np.random.default_rng(seed)
    ro = rs.uniform(-4.9, 4.9, (3, N)).astype(np.float32)
    d = rs.normal(size=(3, N))
    d = (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)
    t_far = np.where(rs.random(N) < 0.1, 0.0, 1e6).astype(np.float32)
    t_far[5 * 2048 : 6 * 2048] = 0.0

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return V3(*(cuda(c) for c in ro)), V3(*(cuda(c) for c in d)), cuda(t_far)


def tie_scene(distinct: int, copies: int, n: int, seed: int):
    """(tris12 [Tpad, 12] f32, ro [3, n], rd [3, n], t_far [n]) as numpy:
    `distinct` random triangles each `copies` times in shuffled rows (so
    equal t across rows), padded with degenerate rows as pack_tris pads;
    n rays aimed at them, ~10% dead lanes, a 32-lane group all dead, one of
    32 equal rays and one half dead."""
    from pim_tpu_torch.render.dense_kernels import pack_tris
    from pim_tpu_torch.tools.cluster_check import aimed_rays, tie_soup

    soup, base = tie_soup(distinct, copies, seed=seed)
    ro, rd, t_far = aimed_rays(base, n, seed=seed + 1)
    t_far[:32] = 0.0
    ro[:, 32:64], rd[:, 32:64], t_far[32:64] = ro[:, 32:33], rd[:, 32:33], 1e6
    t_far[64:96:2] = 0.0
    return pack_tris(soup), ro, rd, t_far


def wide_scene(rows: int, n: int, seed: int, extent: float = 100.0):
    """(tris12 [rows, 12] f32, ro [3, n], rd [3, n], t_far [n]) as numpy:
    `rows` distinct random triangles (edges under 2) in a box of `extent`,
    so thin that a ray aimed at one seldom meets another and its first
    blocker lies in any chunk of rows; n rays aimed at them, ~10% dead
    lanes, and a third of the others stopped at t_far = 1, short of most
    triangles, so that they walk every row."""
    from pim_tpu_torch.render.dense_kernels import pack_tris
    from pim_tpu_torch.tools.cluster_check import aimed_rays, tie_soup

    soup, base = tie_soup(rows, 1, seed=seed, extent=extent)
    ro, rd, t_far = aimed_rays(base, n, seed=seed + 1, extent=extent)
    t_far[1::3] = (t_far[1::3] > 0.0) * 1.0
    return pack_tris(soup), ro, rd, t_far
