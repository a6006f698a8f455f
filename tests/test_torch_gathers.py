"""The redesigned gathers K3 (column gather) and K7 (texel gather): what the
wrappers decide on the CPU, and the layout helpers.

- `gather_variant` picks the kernel form a CUDA call launches: the table
  staged in shared memory up to STAGE_MAX_BYTES, 64-bit offsets only past
  int32, the 16-byte vector path only for a lane count that is a multiple
  of 4 and 16-byte aligned indices.  Held at the main path's shapes, on
  both sides of each threshold, and on real index tensors (a slice that
  starts one element in is misaligned); its constants are the ones
  csrc/gather_tiles.cuh compiles in.
- `reads_rows` sends a table too large to stage, with F a multiple of 4,
  to its row-major copy; the copy gives, through a plain reader, the plain
  gather's output bit for bit on the same indices (out of range ones
  included, N not a multiple of 4), is made once per table, and is made
  again after the table changes in place.
- `gather_texels` skips its autograd Function when `planes` needs no
  gradient, and with one still returns K7-bwd's gradient (plain versions
  here); `gather_cols` keeps the table's gradient, and the row-major copy
  carries none.  Nothing launches on the CPU.
"""

import os
import re

import numpy as np
import pytest
import torch

from pim_tpu_torch import native
from pim_tpu_torch.render import gather_kernel as gk
from pim_tpu_torch.render import table_gather as tg
from pim_tpu_torch.tools import prof_frame

torch.set_num_threads(2)

N = 262144
LIMIT = gk.STAGE_MAX_BYTES // 4  # floats of the largest staged table


@pytest.mark.parametrize("f,t,lanes,out,ptr,want", [
    # K3 at the main path's tables: the Cornell tri table, the e1m1 texture
    # records and emissive table are staged; the e1m1 light and tri tables not
    (48, 108, N, 48 * N, 256, (True, False, True)),
    (5, 71, N, 5 * N, 256, (True, False, True)),
    (24, 600, N, 24 * N, 256, (True, False, True)),
    (98, 867, N, 98 * N, 256, (False, False, True)),
    (48, 81552, N, 48 * N, 256, (False, False, True)),
    # the staging threshold, from both sides
    (1, LIMIT, N, N, 256, (True, False, True)),
    (1, LIMIT + 1, N, N, 256, (False, False, True)),
    # N not a multiple of 4, or indices not 16-byte aligned: the scalar path
    (48, 108, N - 1, 48 * (N - 1), 256, (True, False, False)),
    (48, 108, N + 2, 48 * (N + 2), 256, (True, False, False)),
    (48, 108, N, 48 * N, 260, (True, False, False)),
    (48, 108, N, 48 * N, 264, (True, False, False)),
    # offsets past int32: an output of 2^31 floats, or such a table
    (48, 108, 2**26, 48 * 2**26, 256, (True, True, True)),
    (1, 2**31, 8, 8, 256, (False, True, True)),
    (1, 2**31 - gk.TILE_LANES - 1, 8, 8, 256, (False, False, True)),
    # K7: the atlas planes [4, 32768] (12 sets) read directly, the sky's
    # [3, 6144] (4 sets) staged; 3 x (N - 1) queries take the scalar path
    (4, 32768, 12 * N, 4 * 12 * N, 256, (False, False, True)),
    (3, 6144, 4 * N, 3 * 4 * N, 256, (True, False, True)),
    (4, 32768, 3 * (N - 1), 4 * 3 * (N - 1), 256, (False, False, False)),
])
def test_gather_variant(f, t, lanes, out, ptr, want):
    assert tuple(gk.gather_variant(f * t, out, lanes, ptr)) == want


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("start,n,vec", [(0, 4096, True), (0, 4095, False), (1, 4096, False),
                                         (4, 4096, True)])
def test_gather_variant_reads_the_index_pointer(dtype, start, n, vec):
    base = torch.zeros(8192, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    idx = base[start : start + n]
    assert gk.gather_variant(48 * 108, 48 * n, n, idx.data_ptr()).vec == vec


def test_variant_constants_match_the_kernels():
    with open(os.path.join(native.CSRC, "gather_tiles.cuh")) as fh:
        src = fh.read()
    consts = {name: int(np.prod([int(x) for x in value.split("*")]))
              for name, value in re.findall(r"constexpr int (k\w+) = ([\d *]+);", src)}
    assert consts["kStageMaxBytes"] == gk.STAGE_MAX_BYTES
    assert consts["kThreads"] * consts["kLanes"] == gk.TILE_LANES
    assert "gather_tiles.cuh" in native.HEADERS


def _rows_plain(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain K3 read from the row-major copy: [F, N], 0 outside [0, T)."""
    t = rows.shape[0]
    ok = (idx >= 0) & (idx < t)
    out = rows[torch.where(ok, idx, 0).to(torch.int64)].T
    return torch.where(ok[None, :], out, 0.0)


@pytest.mark.parametrize("f,t,want", [
    (48, 81552, True),   # the e1m1 tri table
    (98, 867, False),    # the e1m1 light table: F not a multiple of 4
    (48, 108, False),    # the Cornell tri table: staged
    (4, LIMIT // 4, False),
    (4, LIMIT // 4 + 1, True),
    (4, 32768, True),    # the e1m1 atlas planes (K7-bwd's texel-interleaved sum)
    (3, 6144, False),    # the sky planes: staged
])
def test_reads_rows(f, t, want):
    assert gk.reads_rows(f, t) == want


@pytest.mark.parametrize("f,t,n,dtype", [(48, 108, 4096, torch.int32), (48, 900, 3001, torch.int64),
                                         (12, 37, 1023, torch.int32)])
def test_row_major_copy_gathers_bitwise(f, t, n, dtype):
    rs = np.random.default_rng(f * t + n)
    table = torch.from_numpy(rs.standard_normal((f, t)).astype(np.float32))
    idx = torch.from_numpy(rs.integers(-3, t + 3, n)).to(dtype)
    idx[:2] = torch.tensor([-1, t])
    rows = gk.table_rows(table)
    assert rows.shape == (t, f) and rows.is_contiguous()
    got = _rows_plain(rows, idx)
    want = gk.gather_cols_plain(table, idx)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))


@pytest.mark.parametrize("change", ["none", "in place", "new table"])
def test_row_major_copy_follows_its_table(change):
    rs = np.random.default_rng(5)
    table = torch.from_numpy(rs.standard_normal((8, 40)).astype(np.float32))
    first = gk.table_rows(table)
    if change == "in place":
        table.mul_(2.0)
    elif change == "new table":
        table = table * 2.0
    rows = gk.table_rows(table)
    assert (rows is first) == (change == "none")
    assert torch.equal(rows, table.T)


@pytest.mark.parametrize("c,t", [(4, 60), (3, 50)])
def test_gather_texels_autograd_only_when_planes_need_it(c, t):
    rs = np.random.default_rng(3)
    planes = torch.from_numpy(rs.standard_normal((c, t)).astype(np.float32))
    idx = torch.from_numpy(rs.integers(-2, t + 2, (8, 301)).astype(np.int32))
    g = torch.from_numpy(rs.standard_normal((c, 8, 301)).astype(np.float32))
    before = dict(native.launches)
    out = tg.gather_texels(planes, idx, parts=1)
    assert out.grad_fn is None
    assert torch.equal(out, tg.gather_texels_plain(planes, idx))
    p = planes.clone().requires_grad_(True)
    out = tg.gather_texels(p, idx, parts=1)
    assert out.grad_fn is not None
    (out * g).sum().backward()
    assert torch.equal(p.grad, tg.gather_texels_bwd_plain(g, idx, t))
    with torch.no_grad():
        assert tg.gather_texels(p, idx).grad_fn is None
    assert native.launches == before


def test_gather_cols_row_major_copy_keeps_the_table_gradient():
    rs = np.random.default_rng(4)
    table = torch.from_numpy(rs.standard_normal((8, 40)).astype(np.float32)).requires_grad_(True)
    idx = torch.from_numpy(rs.integers(-2, 42, 203)).to(torch.int64)
    g = torch.from_numpy(rs.standard_normal((8, 203)).astype(np.float32))
    before = dict(native.launches)
    assert not gk.table_rows(table).requires_grad
    out = gk.gather_cols(table, idx)
    assert torch.equal(out.detach(), gk.gather_cols_plain(table.detach(), idx))
    (out * g).sum().backward()
    assert torch.equal(table.grad, gk.gather_cols_bwd_plain(g, idx, 40))
    assert native.launches == before


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::gather_cols_kernel<int, int, true, true>(float const*, ...)",
     "K3 gather_cols"),
    ("void (anonymous namespace)::gather_cols_rows_kernel<int, int, true>(float const*, ...)",
     "K3 gather_cols"),
    ("void (anonymous namespace)::gather_cols_bwd_kernel<int>(float const*, ...)",
     "K3-bwd gather_cols_bwd"),
    ("void (anonymous namespace)::gather_cols_bwd_rows_kernel<int, int, true>(float const*, ...)",
     "K3-bwd gather_cols_bwd"),
    ("void (anonymous namespace)::gather_texels_kernel<int, false, true>(float const*, ...)",
     "K7 gather_texels"),
    ("void (anonymous namespace)::gather_texels_kernel<int, true, false>(float const*, ...)",
     "K7 gather_texels"),
    ("(anonymous namespace)::gather_texels_bwd_kernel(float const*, int, int, ...)",
     "K7-bwd gather_texels_bwd"),
    ("void (anonymous namespace)::gather_texels_bwd_kernel<int, true, true>(float const*, ...)",
     "K7-bwd gather_texels_bwd"),
    ("void (anonymous namespace)::gather_texels_bwd_rows_kernel<int, true>(float const*, ...)",
     "K7-bwd gather_texels_bwd"),
])
def test_prof_frame_groups_the_gather_kernels(name, group):
    assert prof_frame.kernel_group(name) == group
