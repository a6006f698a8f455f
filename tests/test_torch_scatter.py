"""K3-bwd, the column scatter-add: what its wrapper decides on the CPU, and
the tools that hold it on the card (tools/fetch_check.py).

- `gather_bwd_variant` picks the kernel form a CUDA call launches: the
  [F, t] sum staged in shared memory up to STAGE_MAX_BYTES (the material
  graft, the emissive table, Cornell's tri table; not e1m1's), 64-bit
  offsets only past int32, the 16-byte vector path only for a lane count
  that is a multiple of 4 with the indices and the gradient 16-byte aligned.
  Its constants are the ones csrc/gather_tiles.cuh compiles in, and the
  kernel's staged sum is a row slice no larger than a staged table.
- On the CPU the wrapper is the plain `index_add_` and launches nothing.
- `scatter_error` accepts any summation order of float32 adds and refuses
  a sum off by more than gamma(adds - 1) * sum |g|; `lane_counts` counts a
  call's lanes at column 0 and with a zero gradient.
- `recorded_calls` keeps the (g, idx, t) of every K3-bwd call of a tiny
  Cornell training step without changing the step, and the K7-bwd and K6
  calls made through the modules that make them.
"""

import os
import re

import numpy as np
import pytest
import torch

from pim_tpu_torch import native
from pim_tpu_torch.app import build_cornell_scene
from pim_tpu_torch.render import gather_kernel as gk
from pim_tpu_torch.render import sky, surface
from pim_tpu_torch.render import table_gather as tg
from pim_tpu_torch.tools import fetch_check as fc

torch.set_num_threads(2)

N = 262144
LIMIT = gk.STAGE_MAX_BYTES // 4  # floats of the largest staged sum


@pytest.mark.parametrize("f,t,n,idx_ptr,g_ptr,want", [
    # the main path: e1m1's tri table read directly; the material graft,
    # the emissive graft and Cornell's tri table staged
    (48, 81552, N, 256, 512, (False, False, True)),
    (4, 208, 81552, 256, 512, (True, False, True)),
    (4, 208, 600, 256, 512, (True, False, True)),
    (48, 108, N, 256, 512, (True, False, True)),
    (24, 600, N, 256, 512, (True, False, True)),
    # the staging threshold, from both sides
    (1, LIMIT, N, 256, 512, (True, False, True)),
    (1, LIMIT + 1, N, 256, 512, (False, False, True)),
    # N not a multiple of 4, or the indices or the gradient misaligned
    (4, 208, 81551, 256, 512, (True, False, False)),
    (4, 208, N, 260, 512, (True, False, False)),
    (4, 208, N, 256, 516, (True, False, False)),
    (4, 208, N, 256, 520, (True, False, False)),
    # offsets past int32: a gradient of 2^31 floats, or such a sum
    (48, 108, 2**26, 256, 512, (True, True, True)),
    (1, 2**31, 8, 256, 512, (False, True, True)),
])
def test_gather_bwd_variant(f, t, n, idx_ptr, g_ptr, want):
    assert tuple(gk.gather_bwd_variant(f, t, n, idx_ptr, g_ptr)) == want


@pytest.mark.parametrize("g_start,idx_start,vec", [(0, 0, True), (1, 0, False), (0, 1, False),
                                                    (4, 4, True)])
def test_gather_bwd_variant_reads_both_pointers(g_start, idx_start, vec):
    g = torch.zeros(4 * 4096 + 8)[g_start : g_start + 4 * 4096].view(4, 4096)
    idx = torch.zeros(4096 + 8, dtype=torch.int32)[idx_start : idx_start + 4096]
    assert gk.gather_bwd_variant(4, 208, 4096, idx.data_ptr(), g.data_ptr()).vec == vec


def test_bwd_constants_match_the_kernel():
    with open(os.path.join(native.CSRC, "gather_tiles.cuh")) as fh:
        tiles = fh.read()
    with open(os.path.join(native.CSRC, "gather_cols.cu")) as fh:
        src = fh.read()
    consts = {name: int(np.prod([int(x) for x in value.split("*")]))
              for name, value in re.findall(r"constexpr int (k\w+) = ([\d *]+);", tiles + src)}
    assert consts["kStageMaxBytes"] == gk.STAGE_MAX_BYTES
    assert consts["kThreads"] * consts["kLanes"] == gk.TILE_LANES
    # the backward stages a slice of min(F, kRows) rows of the sum, never
    # more than the staged table itself
    body = src[src.index("int launch_bwd_as("):]
    assert "sizeof(float) * (f < kRows ? f : kRows) * t" in body
    assert "pim_gather::staged_blocks(tiles, blocks_y, smem)" in body


@pytest.mark.parametrize("f,t,n,dtype", [(48, 300, 4096, torch.int32), (4, 7, 1001, torch.int64)])
def test_cpu_wrapper_is_the_plain_scatter_add(f, t, n, dtype):
    rs = np.random.default_rng(f + t + n)
    g = torch.from_numpy(rs.standard_normal((f, n)).astype(np.float32))
    idx = torch.from_numpy(rs.integers(-2, t + 2, n)).to(dtype)
    before = dict(native.launches)
    got = gk.gather_cols_bwd(g, idx, t)
    assert native.launches == before
    want = np.zeros((f, t), np.float64)
    ok = (idx.numpy() >= 0) & (idx.numpy() < t)
    np.add.at(want.T, idx.numpy()[ok], g.numpy()[:, ok].T.astype(np.float64))
    assert torch.equal(got, gk.gather_cols_bwd_plain(g, idx, t))
    assert fc.scatter_error(got, gk.gather_cols_bwd_plain, g, idx, t)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_scatter_error_takes_any_order_and_refuses_a_wrong_sum():
    rs = np.random.default_rng(8)
    n, t = 20000, 5
    g = torch.from_numpy(rs.standard_normal((3, n)).astype(np.float32))
    idx = torch.from_numpy(rs.integers(0, t, n))
    rev = torch.arange(n - 1, -1, -1)
    reordered = gk.gather_cols_bwd_plain(g[:, rev], idx[rev], t)
    ok, err, ratio = fc.scatter_error(reordered, gk.gather_cols_bwd_plain, g, idx, t)
    assert ok and ratio <= 1.0
    bound = fc.sum_bound(gk.gather_cols_bwd_plain, g, idx, t)
    wrong = reordered.clone()
    wrong[1, 2] += float(3.0 * bound[1, 2]) + 1e-3
    assert not fc.scatter_error(wrong, gk.gather_cols_bwd_plain, g, idx, t)[0]


def test_lane_counts():
    g = torch.tensor([[0.0, 1.0, 0.0, 0.0, 2.0], [0.0, 0.0, 0.0, 3.0, 0.0]])
    idx = torch.tensor([0, 0, 3, 0, -1])
    assert fc.lane_counts(g, idx) == {"lanes": 5, "idx0": 3, "g0": 2, "idx0_g0": 1}


@pytest.fixture(scope="module")
def cornell():
    return build_cornell_scene("cpu")


def test_recorder_keeps_the_training_steps_k3_bwd_calls(cornell):
    plain = fc.training_step_calls(cornell, 8, 8, bounces=2)
    before = dict(native.launches)
    calls = fc.training_step_calls(cornell, 8, 8, bounces=2)
    assert native.launches == before
    assert len(calls["k3_bwd"]) == len(plain["k3_bwd"]) > 0
    assert calls["k7_bwd"] == [] and calls["k6_atlas"] == [] and calls["k6_sky"] == []
    shapes = {(g.shape[0], t) for g, _, t in calls["k3_bwd"]}
    tt = cornell[1].tri_table
    assert (tt.shape[0], tt.shape[1]) in shapes  # the tri table's fetches
    for (g, idx, t), (g2, idx2, t2) in zip(calls["k3_bwd"], plain["k3_bwd"]):
        assert g.dim() == 2 and idx.shape == (g.shape[1],) and t == t2
        assert torch.equal(g, g2) and torch.equal(idx, idx2)  # recording changes nothing
        counts = fc.lane_counts(g, idx)
        assert counts["lanes"] == g.shape[1] and counts["idx0_g0"] <= counts["idx0"]
        out = gk.gather_cols_bwd(g, idx, t)
        assert fc.scatter_error(out, gk.gather_cols_bwd_plain, g, idx, t)[0]
    # the recorder is gone after the step
    assert gk.gather_cols_bwd.__name__ == "gather_cols_bwd"


def test_recorder_keeps_k6_and_k7_bwd_calls():
    rs = np.random.default_rng(9)
    t, k, n = 50, 2, 37
    planes4 = torch.from_numpy(rs.standard_normal((16, t)).astype(np.float32))
    planes3 = torch.from_numpy(rs.standard_normal((12, t)).astype(np.float32))
    idx = torch.from_numpy(rs.integers(-1, t + 1, (k, n)).astype(np.int32))
    tx = torch.from_numpy(rs.random((k, n), dtype=np.float32))
    ty = torch.from_numpy(rs.random((k, n), dtype=np.float32))
    valid = torch.from_numpy(rs.random((k, n)) < 0.7)
    p = torch.from_numpy(rs.standard_normal((3, t)).astype(np.float32)).requires_grad_(True)
    with fc.recorded_calls() as calls:
        a = surface.gather_bilinear(planes4, idx, tx, ty, valid, c=4)
        s = sky.gather_bilinear(planes3, idx[:1], tx[:1], ty[:1], valid[:1], c=3)
        tg.gather_texels(p, idx).sum().backward()
    assert surface.gather_bilinear is tg.gather_bilinear is sky.gather_bilinear
    (rec_a,), (rec_s,) = calls["k6_atlas"], calls["k6_sky"]
    assert rec_a[0] is planes4 and rec_a[-1] == 4 and rec_s[0] is planes3 and rec_s[-1] == 3
    assert torch.equal(tg.gather_bilinear_plain(*rec_a[:-1], c=4), a)
    assert torch.equal(tg.gather_bilinear_plain(*rec_s[:-1], c=3), s)
    (g, gidx, gt), = calls["k7_bwd"]
    assert gt == t and torch.equal(gidx, idx) and torch.equal(g, torch.ones((3, k, n)))
    assert torch.equal(p.grad, tg.gather_texels_bwd_plain(g, gidx, gt))
