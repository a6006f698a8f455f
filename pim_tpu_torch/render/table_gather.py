"""K6, the filtered bilinear fetch from corner-resolved planes, and K7, the
texel gather `planes[:, clip(idx)]` with its backward.

K6 is the counterpart of `pim_tpu.render.table_gather.gather_bilinear_pallas`.
corner_planes [4C, T] hold, in rows corner*C + channel with the corners in
the order (00, 10, 01, 11), each texel and its three bilinear neighbours
already clamped inside its own sub-texture (scene.build_atlas_corner_planes)
or cube face (sky.sky_corner_planes), so one index per query names all four
corners.  Per query (k, n): the four corner loads at clip(idx, 0, T-1),
the weights of the reference kernel (sanitized: an invalid query gets 0
whatever its tx, ty carry), the sum w00 q00 + w10 q10 + w01 q01 + w11 q11
from left to right, and 0 where the query is invalid.

For CUDA tensors `gather_bilinear` launches csrc/gather_bilinear.cu; for
CPU tensors it runs `gather_bilinear_plain`.  Both read the texels as plain
float32 values, where the TPU kernel reads bf16 terms of them (exact for the
atlas, whose texels are bf16 values; 16 mantissa bits for the sky).  The
kernel reads a texel-interleaved copy of the planes ([T, 4C], a query's 4C
values in one row), which the wrapper keeps beside the planes with
`gather_kernel.table_rows`, as K3 keeps the tri table's: made on the planes'
first CUDA call, kept as long as they live, made again after they change in
place.

K7 is the counterpart of `pim_tpu.render.table_gather.gather_texels_pallas`:
planes [C, T] f32, idx [K, N] i32 -> [C, K, N] f32 = planes[:, clip(idx, 0,
T-1)].  It serves the differentiable path, which samples the learnable atlas
planes and the re-baked sky cube by their four bilinear corners; its
gradient in `planes` is the scatter-add of the output gradient at the
clipped index (`idx` gets none).  For CUDA tensors `gather_texels` launches
csrc/gather_texels.cu, forward and backward; for CPU tensors it runs their
plain versions.  The TPU kernel's `parts` (1, 2 or 3 bf16 terms) is taken
for the API and changes nothing: the port reads f32, which is exact (at
parts = 1 the atlas texels are bf16 values already, so the TPU gives the
same numbers).  `gather_texels` goes through its autograd Function only
when `planes` needs a gradient; the kernel's variant (planes staged in
shared memory, offset width, vector path) comes from
`gather_kernel.gather_variant`.
"""

from __future__ import annotations

import torch

from pim_tpu_torch import native
from pim_tpu_torch.render.gather_kernel import gather_variant, table_rows


def gather_bilinear_plain(corner_planes: torch.Tensor, idx: torch.Tensor, tx: torch.Tensor,
                          ty: torch.Tensor, valid: torch.Tensor, c: int) -> torch.Tensor:
    """Plain K6: [C, K, N] filtered texels."""
    t = corner_planes.shape[1]
    i = torch.clamp(idx, 0, t - 1).to(torch.int64)
    txv = torch.where(valid, tx, 0.0)
    tyv = torch.where(valid, ty, 0.0)
    w00 = torch.where(valid, (1.0 - txv) * (1.0 - tyv), 0.0)
    w10 = txv * (1.0 - tyv)
    w01 = (1.0 - txv) * tyv
    w11 = txv * tyv
    q = corner_planes[:, i]  # [4C, K, N]
    out = w00 * q[0:c] + w10 * q[c : 2 * c] + w01 * q[2 * c : 3 * c] + w11 * q[3 * c : 4 * c]
    return torch.where(valid, out, 0.0)


def gather_bilinear(corner_planes: torch.Tensor, idx: torch.Tensor, tx: torch.Tensor,
                    ty: torch.Tensor, valid: torch.Tensor, c: int) -> torch.Tensor:
    """corner_planes [4C, T] f32, idx [K, N] i32, tx/ty [K, N] f32, valid
    [K, N] bool -> [C, K, N] f32 filtered texels (0 where invalid).  On the
    card C is 3 or 4."""
    if corner_planes.device.type == "cpu":
        return gather_bilinear_plain(corner_planes, idx, tx, ty, valid, c)
    dev = corner_planes.device
    if c not in (3, 4):
        raise ValueError(f"gather_bilinear: C = {c}; the kernel takes 3 or 4")
    t = corner_planes.shape[1]
    native.require_cuda("gather_bilinear.corner_planes", corner_planes, torch.float32,
                        (4 * c, t), dev)
    if idx.dim() != 2:
        raise ValueError(f"gather_bilinear.idx: expected [K, N], got {tuple(idx.shape)}")
    k, n = idx.shape
    native.require_cuda("gather_bilinear.idx", idx, torch.int32, (k, n), dev)
    native.require_cuda("gather_bilinear.tx", tx, torch.float32, (k, n), dev)
    native.require_cuda("gather_bilinear.ty", ty, torch.float32, (k, n), dev)
    native.require_cuda("gather_bilinear.valid", valid, torch.bool, (k, n), dev)
    out = torch.empty((c, k, n), dtype=torch.float32, device=dev)
    if k * n == 0:
        return out
    lib = native.load()
    rows = table_rows(corner_planes)
    rc = lib.pim_gather_bilinear(rows.data_ptr(), c, t, idx.data_ptr(), tx.data_ptr(),
                                 ty.data_ptr(), valid.data_ptr(), k * n, out.data_ptr(),
                                 native.stream_ptr(dev))
    native.check(lib, rc, "gather_bilinear")
    native.launches["gather_bilinear"] += 1
    return out


def gather_texels_plain(planes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain K7: [C, K, N] = planes[:, clip(idx, 0, T-1)]."""
    t = planes.shape[1]
    return planes[:, torch.clamp(idx, 0, t - 1).to(torch.int64)]


def gather_texels_bwd_plain(g: torch.Tensor, idx: torch.Tensor, t: int) -> torch.Tensor:
    """Plain K7 backward: g [C, K, N] added into a zero [C, t] at the
    clipped index."""
    c = g.shape[0]
    out = torch.zeros((c, t), dtype=g.dtype, device=g.device)
    return out.index_add_(1, torch.clamp(idx, 0, t - 1).to(torch.int64).reshape(-1),
                          g.reshape(c, -1))


def _check_texel_idx(name: str, idx: torch.Tensor, dev):
    if idx.dim() != 2:
        raise ValueError(f"{name}.idx: expected [K, N], got {tuple(idx.shape)}")
    k, n = idx.shape
    native.require_cuda(f"{name}.idx", idx, torch.int32, (k, n), dev)
    return k, n


def gather_texels_fwd(planes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """planes [C, T] f32, idx [K, N] i32 -> [C, K, N] f32 (no autograd)."""
    if planes.device.type == "cpu":
        return gather_texels_plain(planes, idx)
    dev = planes.device
    if planes.dim() != 2:
        raise ValueError(f"gather_texels.planes: expected [C, T], got {tuple(planes.shape)}")
    c, t = planes.shape
    native.require_cuda("gather_texels.planes", planes, torch.float32, (c, t), dev)
    k, n = _check_texel_idx("gather_texels", idx, dev)
    out = torch.empty((c, k, n), dtype=torch.float32, device=dev)
    if k * n == 0 or c == 0:
        return out
    lib = native.load()
    v = gather_variant(c * t, c * k * n, k * n, idx.data_ptr())
    rc = lib.pim_gather_texels(planes.data_ptr(), c, t, idx.data_ptr(), k * n, out.data_ptr(),
                               v.staged, v.wide, v.vec, native.stream_ptr(dev))
    native.check(lib, rc, "gather_texels")
    native.launches["gather_texels"] += 1
    return out


def gather_texels_bwd(g: torch.Tensor, idx: torch.Tensor, t: int) -> torch.Tensor:
    """g [C, K, N] f32, idx [K, N] i32 -> [C, t] f32 scatter-add."""
    if g.device.type == "cpu":
        return gather_texels_bwd_plain(g, idx, t)
    dev = g.device
    k, n = _check_texel_idx("gather_texels_bwd", idx, dev)
    c = g.shape[0]
    native.require_cuda("gather_texels_bwd.g", g, torch.float32, (c, k, n), dev)
    grad = torch.zeros((c, t), dtype=torch.float32, device=dev)
    if k * n == 0 or c == 0:
        return grad
    lib = native.load()
    rc = lib.pim_gather_texels_bwd(g.data_ptr(), c, t, idx.data_ptr(), k * n, grad.data_ptr(),
                                   native.stream_ptr(dev))
    native.check(lib, rc, "gather_texels_bwd")
    native.launches["gather_texels_bwd"] += 1
    return grad


class _GatherTexels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, planes, idx):
        ctx.save_for_backward(idx)
        ctx.t = planes.shape[1]
        return gather_texels_fwd(planes, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_texels_bwd(g.contiguous(), idx, ctx.t), None


def gather_texels(planes: torch.Tensor, idx: torch.Tensor, parts: int = 3) -> torch.Tensor:
    """planes [C, T] f32, idx [K, N] i32 -> [C, K, N] f32, differentiable in
    `planes` when it requires grad.  `parts` is the TPU kernel's bf16 split
    and has no effect here (see the module note)."""
    if parts not in (1, 2, 3):
        raise ValueError(f"gather_texels: parts {parts}, expected 1, 2 or 3")
    if planes.requires_grad and torch.is_grad_enabled():
        return _GatherTexels.apply(planes, idx)
    return gather_texels_fwd(planes, idx)
