"""K3, the column gather: `table_t[:, idx]` with 0 for idx outside [0, T).

Counterpart of `pim_tpu.render.gather_kernel.gather_cols_pallas`.  For CUDA
tensors `gather_cols` launches csrc/gather_cols.cu, for every table size
and batch size; for CPU tensors it runs `gather_cols_plain`.  Both move the
stored float32 values unchanged.
"""

from __future__ import annotations

import torch

from pim_tpu_torch import native


def gather_cols_plain(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain K3: an index with a mask."""
    t = table_t.shape[1]
    ok = (idx >= 0) & (idx < t)
    out = table_t[:, torch.where(ok, idx, 0).to(torch.int64)]
    return torch.where(ok[None, :], out, 0.0)


def gather_cols(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table_t [F, T] f32, idx [N] i32/i64 -> [F, N] f32."""
    if table_t.device.type == "cpu":
        return gather_cols_plain(table_t, idx)
    dev = table_t.device
    if table_t.dim() != 2:
        raise ValueError(f"gather_cols.table_t: expected [F, T], got {tuple(table_t.shape)}")
    f, t = table_t.shape
    native.require_cuda("gather_cols.table_t", table_t, torch.float32, (f, t), dev)
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"gather_cols.idx: dtype {idx.dtype}, expected int32 or int64")
    n = idx.shape[0] if idx.dim() == 1 else -1
    native.require_cuda("gather_cols.idx", idx, idx.dtype, (n,), dev)
    out = torch.empty((f, n), dtype=torch.float32, device=dev)
    if n == 0 or f == 0:
        return out
    lib = native.load()
    fn = lib.pim_gather_cols_i32 if idx.dtype == torch.int32 else lib.pim_gather_cols_i64
    rc = fn(table_t.data_ptr(), f, t, idx.data_ptr(), n, out.data_ptr(),
            native.stream_ptr(dev))
    native.check(lib, rc, "gather_cols")
    native.launches["gather_cols"] += 1
    return out
