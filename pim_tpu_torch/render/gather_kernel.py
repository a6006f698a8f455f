"""K3, the column gather: `table_t[:, idx]` with 0 for idx outside [0, T),
and its backward, the column scatter-add.

Counterpart of `pim_tpu.render.gather_kernel.gather_cols_pallas` and of the
custom VJP around it (`pim_tpu.render.fetch._fetch_cols_pallas`).  For CUDA
tensors `gather_cols` launches csrc/gather_cols.cu, for every table size
and batch size, and its gradient launches the scatter-add of the same file;
for CPU tensors both run their plain versions.  The forward moves the
stored float32 values unchanged.  `idx` gets no gradient.

`gather_variant` picks the kernel's variant from the shapes and the index
pointer (`gather_bwd_variant` the backward's, from the gradient's pointer
too): the table staged in shared memory (up to STAGE_MAX_BYTES) or read
directly, 32- or 64-bit offsets, the 16-byte vector path or the scalar one.
A CUDA call on a table too large to stage, with F a multiple of 4
(`reads_rows`: the e1m1 tri table), reads the table's row-major [T, F]
copy instead (`table_rows`): a lane's row group then comes in two 16-byte
loads from one sector instead of 8 scattered ones.  The copy is made on the
table's first such call, kept as long as the table lives, and made again
after the table changes in place; the gradient still goes to `table_t`.
For the same tables the backward sums into a row-major [T, F] buffer, four
rows of a column with one 16-byte atomic, and returns it as its transposed
[F, T] view (not contiguous: autograd takes a gradient of any strides).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from pim_tpu_torch import native

# csrc/gather_tiles.cuh: a table up to kStageMaxBytes is staged in shared
# memory; a block covers kTileLanes lanes per tile
STAGE_MAX_BYTES = 200 * 1024
TILE_LANES = 1024
_OFFSET_LIMIT = 2**31 - 1
# table -> (its version counter when copied, its row-major copy)
_ROWS = WeakIdKeyDictionary()


class Variant(NamedTuple):
    """Which form of a gather kernel a call launches."""

    staged: bool  # the table (planes) in shared memory
    wide: bool    # 64-bit offsets
    vec: bool     # 16-byte index loads and output stores


def gather_variant(table_elems: int, out_elems: int, lanes: int, idx_ptr: int) -> Variant:
    """The variant of K3 or K7 for a table of `table_elems` floats, an
    output of `out_elems` floats over `lanes` lanes (queries), and indices
    at address `idx_ptr`: staged up to STAGE_MAX_BYTES; 32-bit offsets
    while every offset and lane tile fits in int32; the vector path when
    the lane count is a multiple of 4 and the indices are 16-byte aligned
    (each output row then starts 16-byte aligned too)."""
    return Variant(staged=table_elems * 4 <= STAGE_MAX_BYTES,
                   wide=max(table_elems, out_elems) + TILE_LANES > _OFFSET_LIMIT,
                   vec=lanes % 4 == 0 and idx_ptr % 16 == 0)


def gather_bwd_variant(f: int, t: int, n: int, idx_ptr: int, g_ptr: int) -> Variant:
    """The variant of K3-bwd for a gradient g [F, N] at address `g_ptr`
    added into [F, t] at indices at address `idx_ptr`: as `gather_variant`
    with the [F, t] sum in the table's place (staged in shared memory up
    to STAGE_MAX_BYTES), and the vector path only where g is 16-byte
    aligned too."""
    v = gather_variant(f * t, f * n, n, idx_ptr)
    return v._replace(vec=v.vec and g_ptr % 16 == 0)


def gather_cols_plain(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain K3: an index with a mask."""
    t = table_t.shape[1]
    ok = (idx >= 0) & (idx < t)
    out = table_t[:, torch.where(ok, idx, 0).to(torch.int64)]
    return torch.where(ok[None, :], out, 0.0)


def reads_rows(f: int, t: int) -> bool:
    """Whether a CUDA call on a [F, T] table reads its row-major copy: a
    table too large to stage, with F a multiple of 4."""
    return f * t * 4 > STAGE_MAX_BYTES and f % 4 == 0


def table_rows(table_t: torch.Tensor) -> torch.Tensor:
    """The row-major [T, F] copy of a [F, T] table (no gradient flows
    through it): made once per table, and again after the table changes in
    place; it lives as long as the table.  K3 reads the e1m1 tri table's,
    K6 the corner planes' (their texel-interleaved copy)."""
    version = table_t._version
    kept = _ROWS.get(table_t)
    if kept is None or kept[0] != version:
        kept = (version, table_t.detach().T.contiguous())
        _ROWS[table_t] = kept
    return kept[1]


def gather_cols_bwd_plain(g: torch.Tensor, idx: torch.Tensor, t: int) -> torch.Tensor:
    """Plain K3 backward: g [F, N] added into a zero [F, t] at column idx;
    lanes with idx outside [0, t) add nothing."""
    ok = (idx >= 0) & (idx < t)
    out = torch.zeros((g.shape[0], t), dtype=g.dtype, device=g.device)
    return out.index_add_(1, torch.where(ok, idx, 0).to(torch.int64),
                          torch.where(ok[None, :], g, 0.0))


def _check_idx(name: str, idx: torch.Tensor, dev) -> int:
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}.idx: dtype {idx.dtype}, expected int32 or int64")
    n = idx.shape[0] if idx.dim() == 1 else -1
    native.require_cuda(f"{name}.idx", idx, idx.dtype, (n,), dev)
    return n


def gather_cols_fwd(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table_t [F, T] f32, idx [N] i32/i64 -> [F, N] f32 (no autograd)."""
    if table_t.device.type == "cpu":
        return gather_cols_plain(table_t, idx)
    dev = table_t.device
    if table_t.dim() != 2:
        raise ValueError(f"gather_cols.table_t: expected [F, T], got {tuple(table_t.shape)}")
    f, t = table_t.shape
    native.require_cuda("gather_cols.table_t", table_t, torch.float32, (f, t), dev)
    n = _check_idx("gather_cols", idx, dev)
    out = torch.empty((f, n), dtype=torch.float32, device=dev)
    if n == 0 or f == 0:
        return out
    lib = native.load()
    v = gather_variant(f * t, f * n, n, idx.data_ptr())
    i32 = idx.dtype == torch.int32
    if reads_rows(f, t):
        rows = table_rows(table_t)
        fn = lib.pim_gather_cols_rows_i32 if i32 else lib.pim_gather_cols_rows_i64
        rc = fn(rows.data_ptr(), f, t, idx.data_ptr(), n, out.data_ptr(), v.wide, v.vec,
                native.stream_ptr(dev))
    else:
        fn = lib.pim_gather_cols_i32 if i32 else lib.pim_gather_cols_i64
        rc = fn(table_t.data_ptr(), f, t, idx.data_ptr(), n, out.data_ptr(), v.staged, v.wide,
                v.vec, native.stream_ptr(dev))
    native.check(lib, rc, "gather_cols")
    native.launches["gather_cols"] += 1
    return out


def gather_cols_bwd(g: torch.Tensor, idx: torch.Tensor, t: int) -> torch.Tensor:
    """g [F, N] f32, idx [N] i32/i64 -> [F, t] f32 column scatter-add (on
    the card a transposed view of a row-major sum where `reads_rows`)."""
    if g.device.type == "cpu":
        return gather_cols_bwd_plain(g, idx, t)
    dev = g.device
    if g.dim() != 2:
        raise ValueError(f"gather_cols_bwd.g: expected [F, N], got {tuple(g.shape)}")
    f, n = g.shape
    native.require_cuda("gather_cols_bwd.g", g, torch.float32, (f, n), dev)
    _check_idx("gather_cols_bwd", idx, dev)
    if n == 0 or f == 0:
        return torch.zeros((f, t), dtype=torch.float32, device=dev)
    lib = native.load()
    v = gather_bwd_variant(f, t, n, idx.data_ptr(), g.data_ptr())
    i32 = idx.dtype == torch.int32
    if reads_rows(f, t):
        sum_tf = torch.zeros((t, f), dtype=torch.float32, device=dev)
        fn = lib.pim_gather_cols_bwd_rows_i32 if i32 else lib.pim_gather_cols_bwd_rows_i64
        rc = fn(g.data_ptr(), f, t, idx.data_ptr(), n, sum_tf.data_ptr(), v.wide, v.vec,
                native.stream_ptr(dev))
        grad = sum_tf.T
    else:
        grad = torch.zeros((f, t), dtype=torch.float32, device=dev)
        fn = lib.pim_gather_cols_bwd_i32 if i32 else lib.pim_gather_cols_bwd_i64
        rc = fn(g.data_ptr(), f, t, idx.data_ptr(), n, grad.data_ptr(), v.staged, v.wide, v.vec,
                native.stream_ptr(dev))
    native.check(lib, rc, "gather_cols_bwd")
    native.launches["gather_cols_bwd"] += 1
    return grad


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_t, idx):
        ctx.save_for_backward(idx)
        ctx.t = table_t.shape[1]
        return gather_cols_fwd(table_t, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_cols_bwd(g.contiguous(), idx, ctx.t), None


def gather_cols(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table_t [F, T] f32, idx [N] i32/i64 -> [F, N] f32, differentiable in
    table_t when it requires grad."""
    if table_t.requires_grad and torch.is_grad_enabled():
        return _GatherCols.apply(table_t, idx)
    return gather_cols_fwd(table_t, idx)
