"""The tools that hold K1 on the card (pim_tpu_torch/tools/dense_check.py)
and the tie rule they check it on.

- `tie_scene` makes coincident triangles in shuffled rows over two chunks
  of 256 rows, padded with degenerate rows, and rays aimed at them with a
  dead warp, a warp of one ray and a half-dead warp; the plain K1 (what
  the kernel must equal bit for bit) keeps the lowest row among equal t
  there, as a float32 numpy walk in row order does, for a per-ray and a
  scalar t_far.
- `main_path_calls` keeps the K1 and K2 calls of sample 0 of a Cornell step
  (the primary rays, then one K1 call a bounce) without changing the step;
  the plain K2 on its K2 calls (dead lanes at t_far = 0) equals the Pallas
  any-hit kernel in interpret mode; `bake_calls` keeps the light-grid
  bake's K2 call.
- `anyhit_tests` counts the tests up to each ray's first blocker, and
  `wide_scene` spreads the first blockers over every chunk of 8,192 rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import pallas_interpret

from pim_tpu.render import pallas_kernels as pk
from pim_tpu_torch import native
from pim_tpu_torch.app import bench_camera, build_cornell_scene
from pim_tpu_torch.core import rng
from pim_tpu_torch.math.vec3 import RCP_EPS, V3
from pim_tpu_torch.render import dense_kernels as dk
from pim_tpu_torch.render.camera import generate_primary_rays
from pim_tpu_torch.tools import dense_check as dc

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _numpy_walk(rows, ro, rd, t_far):
    """K1 in float32 numpy, one op at a time in the kernels' order: walk
    the rows in index order, accept t < min(t_far, best t)."""
    n = ro.shape[1]
    lim = np.minimum(np.broadcast_to(np.float32(t_far), (n,)), np.float32(3e38))
    best = np.full(n, -1, np.int32)
    live = lim > 0
    with np.errstate(all="ignore"):
        for j, r in enumerate(rows):
            den = r[0] * rd[0] + r[1] * rd[1] + r[2] * rd[2]
            num = r[3] - (r[0] * ro[0] + r[1] * ro[1] + r[2] * ro[2])
            t = num / den
            p = [ro[k] + t * rd[k] for k in range(3)]
            u = r[4] * p[0] + r[5] * p[1] + r[6] * p[2] + r[7]
            v = r[8] * p[0] + r[9] * p[1] + r[10] * p[2] + r[11]
            acc = live & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0) & (t < lim)
            best = np.where(acc, j, best)
            lim = np.where(acc, t, lim)
    return np.where(best >= 0, lim, np.float32(-1.0)).astype(np.float32), best


@pytest.fixture(scope="module")
def cornell():
    return build_cornell_scene("cpu")


def _camera_rays(n_side):
    cam = bench_camera("cornell", n_side, n_side)
    state = rng.make_state(torch.arange(n_side * n_side), 0)
    _, ro, rd = generate_primary_rays(cam, n_side, n_side, state)
    return ro, rd, RCP_EPS


@pytest.mark.parametrize("scalar_t_far", [False, True])
def test_tie_scene_keeps_the_lowest_row(scalar_t_far):
    rows, ro, rd, t_far = dc.tie_scene(10, 30, 2048, seed=21)
    assert rows.shape == (512, 12) and not rows[300:].any()  # two chunks, padded
    assert (t_far[:32] == 0.0).all() and (ro[:, 32:64] == ro[:, 32:33]).all()
    tf = np.float32(1e6) if scalar_t_far else t_far
    t, tri = dk.dense_isect_plain(_t(rows), V3(*(_t(c) for c in ro)), V3(*(_t(c) for c in rd)),
                                  0.0, float(tf) if scalar_t_far else _t(tf))
    want_t, want_tri = _numpy_walk(rows, ro, rd, tf)
    np.testing.assert_array_equal(tri.numpy(), want_tri)
    np.testing.assert_array_equal(t.numpy().view(np.int32), want_t.view(np.int32))
    # the rays meet copies: the same t in several rows, of which the first wins
    t_all, ok = dk._bw_test_plain(_t(rows), V3(*(_t(c) for c in ro)),
                                  V3(*(_t(c) for c in rd)), 0.0)
    hit = tri.numpy() >= 0
    ties = ((t_all == t.unsqueeze(0)) & ok).sum(dim=0).numpy()
    assert hit.mean() > 0.5 and (ties[hit] > 1).mean() > 0.5
    if not scalar_t_far:
        assert (tri.numpy()[:32] == -1).all() and (t.numpy()[:32] == -1.0).all()


def test_main_path_calls_record_sample_0(cornell):
    before = dict(native.launches)
    calls = dc.main_path_calls(cornell, 16, 16, bounces=3)
    assert native.launches == before
    assert dk.dense_isect.__name__ == "dense_isect"  # the recorder is gone
    isect = calls["isect"]
    assert len(isect) == 4 and len(calls["anyhit"]) >= 1
    tris12, ro, rd, t_near, t_far = isect[0]
    assert tris12 is cornell[1].tris12 and t_near == 0.0 and t_far == RCP_EPS
    want = _camera_rays(16)
    assert all(torch.equal(a, b) for a, b in zip(ro, want[0]))
    for _, ro, rd, _, t_far in isect[1:]:
        assert ro.x.shape == (256,) and t_far.shape == (256,)
    # later bounces carry dead lanes at t_far = 0
    assert bool((isect[-1][-1] == 0.0).any())


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def test_main_path_anyhit_calls_match_pallas(cornell):
    calls = dc.main_path_calls(cornell, 16, 16, bounces=3)["anyhit"]
    assert len(calls) == 3  # one NEE shadow-ray call a bounce
    dead_lanes = 0
    for tris12, ro, rd, t_near, t_far in calls:
        assert tris12 is cornell[1].tris12 and t_near == 0.0 and t_far.shape == (256,)
        dead_lanes += int((t_far == 0.0).sum())
        flag = dk.dense_anyhit_plain(tris12, ro, rd, t_near, t_far)
        rows = tris12.numpy()
        o, d = (np.stack([_np(c) for c in v], axis=0) for v in (ro, rd))
        with pallas_interpret():
            jhit = pk.occluded_pallas(jnp.asarray(rows), jnp.asarray(o.T), jnp.asarray(d.T),
                                      jnp.zeros(256, jnp.float32), jnp.asarray(t_far.numpy()))
        # dead lanes carry t_far = 0 and report 1 in both
        assert (flag.numpy()[t_far.numpy() <= 0.0] == 1).all()
        np.testing.assert_array_equal(flag.numpy() > 0, np.asarray(jhit))
    assert dead_lanes > 0  # later bounces carry dead lanes


def test_bake_calls_record_the_light_grid_bake(cornell):
    before = dict(native.launches)
    calls = dc.bake_calls("cpu")
    assert native.launches == before and dk.dense_anyhit.__name__ == "dense_anyhit"
    assert len(calls) == 1
    tris12, ro, rd, t_near, t_far = calls[0]
    assert ro.x.shape == (343 * 12 * 16,) and t_near == 0.0 and t_far.shape == ro.x.shape
    torch.testing.assert_close(tris12, cornell[1].tris12, rtol=0, atol=0)


def _numpy_first_blocker(rows, ro, rd, t_far):
    """[n]: 1 + the first row in index order that blocks each ray, in
    float32 numpy one op at a time; len(rows) where none blocks."""
    n = ro.shape[1]
    first = np.full(n, len(rows), np.int64)
    with np.errstate(all="ignore"):
        for j in range(len(rows) - 1, -1, -1):
            r = rows[j]
            t = (r[3] - (r[0] * ro[0] + r[1] * ro[1] + r[2] * ro[2])) / (
                r[0] * rd[0] + r[1] * rd[1] + r[2] * rd[2])
            p = [ro[k] + t * rd[k] for k in range(3)]
            u = r[4] * p[0] + r[5] * p[1] + r[6] * p[2] + r[7]
            v = r[8] * p[0] + r[9] * p[1] + r[10] * p[2] + r[11]
            blk = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0) & (t < t_far)
            first = np.where(blk, j + 1, first)
    return first


def test_anyhit_tests_count_up_to_the_first_blocker():
    rows, ro, rd, t_far = dc.tie_scene(10, 30, 1024, seed=23)
    need = dc.anyhit_tests(_t(rows), V3(*(_t(c) for c in ro)), V3(*(_t(c) for c in rd)), 0.0,
                           _t(t_far)).numpy()
    want = np.where(t_far <= 0.0, 0, _numpy_first_blocker(rows, ro, rd, t_far))
    np.testing.assert_array_equal(need, want)
    assert (need[t_far > 0] < len(rows)).mean() > 0.5 and (need[:32] == 0).all()


def test_wide_scene_spreads_first_blockers_over_every_chunk():
    rows, ro, rd, t_far = dc.wide_scene(8192, 2048, seed=31)
    assert rows.shape == (8192, 12) and rows.dtype == np.float32
    assert (np.abs(rows[:, :3]).sum(axis=1) > 0).all()  # distinct, none degenerate
    need = dc.anyhit_tests(_t(rows), V3(*(_t(c) for c in ro)), V3(*(_t(c) for c in rd)), 0.0,
                           _t(t_far)).numpy()
    live = t_far > 0
    flag = dk.dense_anyhit_plain(_t(rows), V3(*(_t(c) for c in ro)), V3(*(_t(c) for c in rd)),
                                 0.0, _t(t_far)).numpy()
    blocked = live & (flag == 1)
    chunks = np.bincount((need[blocked] - 1) // 256, minlength=32)
    assert (chunks > 0).all() and chunks[16:].sum() > 0.3 * blocked.sum()
    assert (live & (flag == 0)).sum() > 0.2 * live.sum()  # open rays walk every row
    assert (need[live & (flag == 0)] == 8192).all()
