"""The port's cluster build, the plain K4/K5 and the ray-sort keys against
pim_tpu.

- The build (`tris`, `clb`, `scb`) is bitwise the reference builder's.
- The plain K4/K5 (what the wrappers run for CPU tensors) against the
  interpret-mode Pallas kernels: tri ids and any-hit flags equal, with at
  most MAX_CULL_LANES lanes allowed to differ where a ray's own slab test
  rejects, by rounding, a box that holds its hit (the reference culls per
  512-ray block; none were seen on the seeds below).  K4's t equals an
  op-by-op numpy float32 evaluation bit for bit, and the interpret-mode t
  within rtol 1e-6 except where XLA:CPU's FMA contraction moves it (ROADMAP
  F5): there it stays within 2 eps of the cancellation scale
  (|d| + sum|n_i o_i|) / |den| + |t| sum|n_i d_i| / |den|, and that scale
  stays below SCALE_CAP on every such lane.
- Ray-sort keys bitwise; the inverse permutation restores the order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import pallas_interpret

from pim_tpu.geom.entities import flatten
from pim_tpu.geom.maps import build_map_scene
from pim_tpu.math.grid import make_grid as jmake_grid
from pim_tpu.math.vec3 import V3 as JV3
from pim_tpu.render import cluster as CL
from pim_tpu.render import raysort as jraysort
from pim_tpu_torch import native
from pim_tpu_torch.math.grid import make_grid
from pim_tpu_torch.math.vec3 import V3
from pim_tpu_torch.render import cluster as pc
from pim_tpu_torch.render import raysort

torch.set_num_threads(2)

N = 4096
MAX_CULL_LANES = 4
SCALE_CAP = 1e4  # seeds 5 and 6 reach 1,717
EPS32 = float(np.finfo(np.float32).eps)


def _soup(t, seed=1, extent=10.0, size=0.8):
    """The random triangle soup of tests/test_cluster.py."""
    rs = np.random.default_rng(seed)
    a = rs.random((t, 3), np.float32) * extent
    e1 = (rs.random((t, 3), np.float32) - 0.5) * size
    e2 = (rs.random((t, 3), np.float32) - 0.5) * size
    return np.stack([a, a + e1, a + e2], axis=1).reshape(-1, 3).astype(np.float32)


def _map_positions():
    ents, _ = build_map_scene(rooms=(1, 1), spheres_per_room=2, sphere_steps=8, tex_size=8,
                              seed=2)
    return flatten(ents).positions


@pytest.fixture(scope="module")
def soup3k():
    return _soup(3000)


def _rays(seed, n=N):
    """Seeded rays in the soup's box: ~10% axis-aligned directions (they
    exercise _safe_inv), ~10% dead lanes, ~20% with t_far = 3."""
    rs = np.random.default_rng(seed)
    ro = (rs.random((3, n)) * 10).astype(np.float32)
    d = rs.standard_normal((3, n))
    ax = np.nonzero(rs.random(n) < 0.1)[0]
    d[:, ax] = 0.0
    d[rs.integers(0, 3, ax.size), ax] = rs.choice([-1.0, 1.0], ax.size)
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    t_far = np.full(n, 1e9, np.float32)
    t_far[rs.random(n) < 0.2] = 3.0
    t_far[rs.random(n) < 0.1] = 0.0
    return ro, d, t_far


def _port(cl_np):
    return pc.ClusterArrays(*(torch.from_numpy(np.ascontiguousarray(x)) for x in cl_np))


@pytest.mark.parametrize("case", ["soup3k", "empty", "one_tri", "map"])
def test_build_clusters_bitwise(soup3k, case):
    pos = {"soup3k": lambda: soup3k, "empty": lambda: np.zeros((0, 3), np.float32),
           "one_tri": lambda: np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
           "map": _map_positions}[case]()
    want = CL.build_clusters(pos)
    got = pc.build_clusters(pos)
    for name in ("tris", "clb", "scb"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.shape == b.shape and a.dtype == np.float32, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("seed", [5, 6])
def test_cluster_plain_matches_pallas(soup3k, seed):
    ro, rd, t_far = _rays(seed)
    jcl = CL.build_clusters(soup3k)
    with pallas_interpret():
        jt, jtri = CL.intersect_cluster_raw(jcl, jnp.asarray(ro.T), jnp.asarray(rd.T), 0.0,
                                            jnp.asarray(t_far))
        jocc = CL.occluded_cluster(jcl, jnp.asarray(ro.T), jnp.asarray(rd.T), 0.0,
                                   jnp.asarray(t_far))
    cl = _port(pc.build_clusters(soup3k))
    tro, trd = V3(*map(torch.from_numpy, ro)), V3(*map(torch.from_numpy, rd))
    tf = torch.from_numpy(t_far)
    t, tri = pc.cluster_isect(cl, tro, trd, 0.0, tf)
    flag = pc.cluster_anyhit(cl, tro, trd, 0.0, tf)
    assert tri.dtype == torch.int32 and flag.dtype == torch.int32
    t, tri, flag = t.numpy(), tri.numpy(), flag.numpy()
    jt, jtri, jocc = np.asarray(jt), np.asarray(jtri), np.asarray(jocc)

    dead = t_far <= 0
    assert (tri[dead] == -1).all() and (t[dead] == -1.0).all()
    assert (flag[dead] == 0).all()                       # K5: a dead lane is not a hit
    assert (tri != jtri).sum() <= MAX_CULL_LANES
    assert ((flag > 0) != jocc).sum() <= MAX_CULL_LANES
    hit = (tri >= 0) & (tri == jtri)
    assert hit.sum() > 0.2 * N
    np.testing.assert_array_equal(t[tri < 0], -1.0)

    # t: op-by-op float32 bitwise, and the FMA allowance against Pallas
    tris = pc.build_clusters(soup3k).tris.T
    slot = {int(i): s for s, i in enumerate(tris[:, 12]) if i >= 0}
    r = tris[[slot[i] for i in tri[hit]], :12].T
    o, d = ro[:, hit], rd[:, hit]
    den = r[0] * d[0] + r[1] * d[1] + r[2] * d[2]
    no = r[0] * o[0] + r[1] * o[1] + r[2] * o[2]
    np.testing.assert_array_equal(t[hit], (r[3] - no) / den)
    scale = ((np.abs(r[3]) + np.abs(r[0] * o[0]) + np.abs(r[1] * o[1]) + np.abs(r[2] * o[2])
              + np.abs(t[hit]) * (np.abs(r[0] * d[0]) + np.abs(r[1] * d[1])
                                  + np.abs(r[2] * d[2]))) / np.abs(den))
    err = np.abs(t[hit] - jt[hit])
    off = err > 1e-6 * np.abs(jt[hit])
    assert (scale[off] < SCALE_CAP).all()
    assert (err[off] <= 1e-6 * np.abs(jt[hit][off]) + 2 * EPS32 * scale[off]).all()


def test_cluster_scalar_t_far_and_counts(soup3k):
    ro, rd, _ = _rays(7, 1024)
    cl = _port(pc.build_clusters(soup3k))
    tro, trd = V3(*map(torch.from_numpy, ro)), V3(*map(torch.from_numpy, rd))
    before = dict(native.launches)
    for fn in (pc.cluster_isect, pc.cluster_anyhit):
        a, b = fn(cl, tro, trd, 0.0, 3.0), fn(cl, tro, trd, 0.0, torch.full((1024,), 3.0))
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert native.launches == before


def test_empty_and_one_triangle_scene():
    ro = np.tile(np.asarray([[0.2], [0.2], [1.0]], np.float32), (1, 8))
    rd = np.tile(np.asarray([[0.0], [0.0], [-1.0]], np.float32), (1, 8))
    tro, trd = V3(*map(torch.from_numpy, ro)), V3(*map(torch.from_numpy, rd))
    t, tri = pc.cluster_isect(_port(pc.build_clusters(np.zeros((0, 3), np.float32))),
                              tro, trd, 0.0, 1e9)
    assert (tri.numpy() == -1).all() and (t.numpy() == -1.0).all()
    one = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    t, tri = pc.cluster_isect(_port(pc.build_clusters(one)), tro, trd, 0.0, 1e9)
    np.testing.assert_allclose(t.numpy(), 1.0, rtol=1e-6)
    assert (tri.numpy() == 0).all()


@pytest.mark.parametrize("per_ray_t_far", [True, False])
def test_sort_keys_bitwise_and_unsort(per_ray_t_far):
    rs = np.random.default_rng(3)
    n = 2048
    ro = rs.uniform(-1.0, 9.0, (3, n)).astype(np.float32)
    d = rs.standard_normal((3, n))
    d[:, :64] = np.eye(3)[:, rs.integers(0, 3, 64)] * rs.choice([-1.0, 1.0], 64)
    rd = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    t_far = np.where(rs.random(n) < 0.2, 0.0, 1e6).astype(np.float32)
    tf = t_far if per_ray_t_far else 1e6
    lo, hi = np.zeros(3, np.float32), np.full(3, 8.0, np.float32)
    jkeys = jraysort.sort_rays_key(jmake_grid(lo, hi, 1.0 / 1.5), JV3(*map(jnp.asarray, ro)),
                                   JV3(*map(jnp.asarray, rd)), jnp.asarray(tf))
    grid = make_grid(lo, hi, 1.0 / 1.5)
    tro, trd = V3(*map(torch.from_numpy, ro)), V3(*map(torch.from_numpy, rd))
    ttf = torch.from_numpy(t_far) if per_ray_t_far else 1e6
    keys = raysort.sort_rays_key(grid, tro, trd, ttf)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys).astype(np.int64))

    ro_s, rd_s, tf_s, perm = raysort.sorted_rays(grid, tro, trd, ttf)
    assert (np.diff(keys.numpy()[perm.numpy()]) >= 0).all()
    if per_ray_t_far:
        np.testing.assert_array_equal(tf_s.numpy(), t_far[perm.numpy()])
    else:
        assert tf_s == 1e6
    back = raysort.unsort_rows([ro_s.x, rd_s.z, perm], perm)
    np.testing.assert_array_equal(back[0].numpy(), ro[0])
    np.testing.assert_array_equal(back[1].numpy(), rd[2])
    np.testing.assert_array_equal(back[2].numpy(), np.arange(n))
