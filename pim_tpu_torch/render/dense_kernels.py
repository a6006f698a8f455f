"""Dense Baldwin-Weber intersection: K1 (closest hit) and K2 (any hit).

Counterpart of `pim_tpu.render.pallas_kernels`.  Per-triangle precompute
(bw_rows, [T, 12], float64 on the host, stored float32):
  rows 0-2   n   = cross(e1, e2)      unnormalized geometric normal
  row  3     d   = dot(n, A)          plane offset
  rows 4-6   U   barycentric-u affine row:  u = U.p + uw
  row  7     uw
  rows 8-10  V   barycentric-v affine row:  v = V.p + vw
  row  11    vw
Degenerate (padding) triangles have n = 0; their NaN t fails every compare.

The per-(ray, tri) test computes, in this order:
  den = n.dir, num = d - n.o, t = num / den, p = o + t * dir,
  u = U.p + uw, v = V.p + vw, valid = u >= 0, v >= 0, u + v <= 1, t > t_near.
K1 returns the smallest t with valid and t < t_far (lowest index on ties),
t = -1 and tri = -1 on a miss.  K2 returns whether any triangle is valid
with t < t_far; a dead ray (t_far <= 0) reports blocked, as the reference.
t_near is one number for all rays (every caller passes 0); t_far is an [N]
tensor or one number for all rays.

For CUDA tensors the wrappers launch csrc/dense_isect.cu; for CPU tensors
they run the plain torch versions below (one torch op per product and sum,
so neither device fuses them into FMAs).
"""

from __future__ import annotations

import numpy as np
import torch

from pim_tpu_torch import native
from pim_tpu_torch.math.vec3 import V3

TRI_BLOCK = 256     # padding granularity of pack_tris (as the reference)
_PLAIN_TRI_CHUNK = 256
_BIG = 3.0e38


def bw_rows(positions) -> np.ndarray:
    """positions [V, 3] -> [T, 12] Baldwin-Weber rows, f64 precompute,
    f32 output, unpadded.  Degenerate triangles get n = 0."""
    pos = np.asarray(positions, np.float64)
    tri_count = pos.shape[0] // 3
    if tri_count == 0:
        return np.zeros((0, 12), np.float32)
    tris = pos[: tri_count * 3].reshape(tri_count, 3, 3)
    a = tris[:, 0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    n = np.cross(e1, e2)
    d = np.sum(n * a, axis=-1)

    k = np.argmax(np.abs(n), axis=-1)  # dominant axis per tri
    u_row = np.zeros((tri_count, 3))
    v_row = np.zeros((tri_count, 3))
    uw = np.zeros(tri_count)
    vw = np.zeros(tri_count)
    for kk, (i, j) in enumerate(((1, 2), (2, 0), (0, 1))):
        m = k == kk
        if not m.any():
            continue
        nk = n[m, kk]
        nk = np.where(nk == 0.0, 1.0, nk)  # degenerate guard
        inv = 1.0 / nk
        # [p_i - a_i, p_j - a_j] = u*[e1_i, e1_j] + v*[e2_i, e2_j]
        u_row[m, i] = e2[m, j] * inv
        u_row[m, j] = -e2[m, i] * inv
        uw[m] = (e2[m, i] * a[m, j] - e2[m, j] * a[m, i]) * inv
        v_row[m, i] = -e1[m, j] * inv
        v_row[m, j] = e1[m, i] * inv
        vw[m] = (e1[m, j] * a[m, i] - e1[m, i] * a[m, j]) * inv

    degen = np.sum(n * n, axis=-1) == 0.0
    n[degen] = 0.0
    return np.concatenate(
        [n, d[:, None], u_row, uw[:, None], v_row, vw[:, None]], axis=-1
    ).astype(np.float32)


def pack_tris(positions) -> np.ndarray:
    """positions [V, 3] -> [Tpad, 12] BW rows padded with degenerate rows
    (to a multiple of 8, or of TRI_BLOCK past TRI_BLOCK rows), the
    reference's layout of `SceneArrays.tris9`."""
    packed = bw_rows(positions)
    if packed.shape[0] == 0:
        return np.zeros((8, 12), np.float32)
    if packed.shape[0] <= TRI_BLOCK:
        tpad = max(8, -(-packed.shape[0] // 8) * 8)
    else:
        tpad = -(-packed.shape[0] // TRI_BLOCK) * TRI_BLOCK
    pad = tpad - packed.shape[0]
    if pad:
        packed = np.pad(packed, ((0, pad), (0, 0)))
    return packed


# ---------------------------------------------------------------------------
# Plain torch versions (CPU path and the on-card reference)
# ---------------------------------------------------------------------------


def _bw_test_plain(rows: torch.Tensor, ro: V3, rd: V3, t_near):
    """[TB, 12] rows vs [N] rays -> (t, valid) [TB, N], the kernel's op
    order; the far-plane test is the caller's."""
    c = [rows[:, k : k + 1] for k in range(12)]
    nx, ny, nz, d, ux, uy, uz, uw, vx, vy, vz, vw = c
    den = nx * rd.x + ny * rd.y + nz * rd.z
    num = d - (nx * ro.x + ny * ro.y + nz * ro.z)
    t = num / den
    px = ro.x + t * rd.x
    py = ro.y + t * rd.y
    pz = ro.z + t * rd.z
    u = ux * px + uy * py + uz * pz + uw
    v = vx * px + vy * py + vz * pz + vw
    ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_near)
    return t, ok


def dense_isect_plain(tris12, ro: V3, rd: V3, t_near: float, t_far):
    """Plain K1: (t [N] f32, tri [N] i32)."""
    n = ro.x.shape[0]
    dev = ro.x.device
    t_far = torch.as_tensor(t_far, dtype=torch.float32, device=dev)
    best_t = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for c0 in range(0, tris12.shape[0], _PLAIN_TRI_CHUNK):
        rows = tris12[c0 : c0 + _PLAIN_TRI_CHUNK]
        t, ok = _bw_test_plain(rows, ro, rd, t_near)
        valid = ok & (t < t_far) & (t < best_t)
        t = torch.where(valid, t, _BIG)
        tmin = torch.amin(t, dim=0)
        slot = torch.arange(rows.shape[0], dtype=torch.int32, device=dev)[:, None] + c0
        imin = torch.amin(torch.where(t == tmin, slot, 2**31 - 1), dim=0)
        better = tmin < best_t
        best_i = torch.where(better, imin, best_i)
        best_t = torch.where(better, tmin, best_t)
    best_i = torch.where(t_far <= 0.0, -1, best_i)
    return torch.where(best_i >= 0, best_t, -1.0), best_i


def dense_anyhit_plain(tris12, ro: V3, rd: V3, t_near: float, t_far):
    """Plain K2: [N] i32 flag, 1 = blocked (and for dead rays)."""
    n = ro.x.shape[0]
    t_far = torch.as_tensor(t_far, dtype=torch.float32, device=ro.x.device)
    hit = torch.broadcast_to(t_far <= 0.0, (n,))
    for c0 in range(0, tris12.shape[0], _PLAIN_TRI_CHUNK):
        t, ok = _bw_test_plain(tris12[c0 : c0 + _PLAIN_TRI_CHUNK], ro, rd, t_near)
        hit = hit | torch.any(ok & (t < t_far), dim=0)
    return hit.to(torch.int32)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _ray_args(tris12, ro: V3, rd: V3, t_near: float, t_far, name: str):
    """The C entry points' ray arguments (see `ray_args`), after checking
    the BW rows."""
    native.require_cuda(f"{name}.tris12", tris12, torch.float32, (tris12.shape[0], 12),
                        tris12.device)
    return ray_args(ro, rd, t_near, t_far, name, tris12.device)


def ray_args(ro: V3, rd: V3, t_near: float, t_far, name: str, dev):
    """The ray arguments of the intersection kernels' C entry points: six
    [N] pointers, t_near, then t_far as an [N] pointer or, for a Python
    number, a null pointer and the value for all rays."""
    n = ro.x.shape[0]
    args = []
    for label, comp in (("ro.x", ro.x), ("ro.y", ro.y), ("ro.z", ro.z),
                        ("rd.x", rd.x), ("rd.y", rd.y), ("rd.z", rd.z)):
        native.require_cuda(f"{name}.{label}", comp, torch.float32, (n,), dev)
        args.append(comp.data_ptr())
    if not isinstance(t_near, (int, float)):
        raise TypeError(f"{name}.t_near: expected a Python number, got {type(t_near).__name__}")
    args.append(float(t_near))
    if isinstance(t_far, torch.Tensor):
        native.require_cuda(f"{name}.t_far", t_far, torch.float32, (n,), dev)
        args += [t_far.data_ptr(), 0.0]
    elif isinstance(t_far, (int, float)):
        args += [None, float(t_far)]
    else:
        raise TypeError(f"{name}.t_far: expected a tensor or a Python number, "
                        f"got {type(t_far).__name__}")
    return n, args


def dense_isect(tris12, ro: V3, rd: V3, t_near: float, t_far):
    """K1 on [N] rays; t_far is an [N] tensor or one number for all rays.
    Returns (t [N] f32, tri [N] i32)."""
    if tris12.device.type == "cpu":
        return dense_isect_plain(tris12, ro, rd, t_near, t_far)
    n, args = _ray_args(tris12, ro, rd, t_near, t_far, "dense_isect")
    t = torch.empty((n,), dtype=torch.float32, device=tris12.device)
    tri = torch.empty((n,), dtype=torch.int32, device=tris12.device)
    if n == 0:
        return t, tri
    lib = native.load()
    rc = lib.pim_dense_isect(tris12.data_ptr(), tris12.shape[0], *args, n,
                             t.data_ptr(), tri.data_ptr(), native.stream_ptr(tris12.device))
    native.check(lib, rc, "dense_isect")
    native.launches["dense_isect"] += 1
    return t, tri


def dense_anyhit(tris12, ro: V3, rd: V3, t_near: float, t_far):
    """K2 on [N] rays: [N] i32 flag (1 = blocked; dead rays report 1)."""
    if tris12.device.type == "cpu":
        return dense_anyhit_plain(tris12, ro, rd, t_near, t_far)
    n, args = _ray_args(tris12, ro, rd, t_near, t_far, "dense_anyhit")
    hit = torch.empty((n,), dtype=torch.int32, device=tris12.device)
    if n == 0:
        return hit
    lib = native.load()
    rc = lib.pim_dense_anyhit(tris12.data_ptr(), tris12.shape[0], *args, n,
                              hit.data_ptr(), native.stream_ptr(tris12.device))
    native.check(lib, rc, "dense_anyhit")
    native.launches["dense_anyhit"] += 1
    return hit


def intersect_dense_raw(tris12, ro: V3, rd: V3, t_near: float, t_far):
    """Closest hit; returns (t [N], tri [N] i32).  Hit completion happens
    in the caller (scene._finalize_hit_fused)."""
    return dense_isect(tris12, ro, rd, t_near, t_far)


def occluded_dense(tris12, ro: V3, rd: V3, t_near: float, t_far) -> torch.Tensor:
    """Any hit; returns [N] bool (True = blocked; dead rays report True)."""
    return dense_anyhit(tris12, ro, rd, t_near, t_far) > 0
