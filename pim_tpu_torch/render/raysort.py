"""Ray sorting for coherence before a cluster trace.

Counterpart of `pim_tpu.render.raysort`.  The key is (dead?, origin cell of
the light grid, one of 96 direction bins); dead lanes (t_far <= 0) sort
last.  The cluster kernels cull per ray, so sorting changes no result: it
only lets the lanes of a warp walk the same clusters.

The reference carries the rays through `jax.lax.sort` as payload (an
answer to in-scan gathers on the TPU).  Here the permutation comes from
one stable `torch.sort`, the rays move with one index gather of a stacked
[7, N] block, and results go back with the inverse permutation.  The
reference's sort is not stable, so among equal keys the two permutations
may differ; the keys are the same bit for bit.
"""

from __future__ import annotations

import torch

from pim_tpu_torch.core.profiler import spanned
from pim_tpu_torch.math.grid import GridSpec, grid_index_soa
from pim_tpu_torch.math.vec3 import V3

DIR_BINS = 96  # 6 cube faces x 4x4 sub-bins


def _dir_bin(rd: V3) -> torch.Tensor:
    """Quantize a direction to one of 96 bins: dominant-axis cube face and
    a 4x4 grid on the face plane."""
    ax = torch.abs(rd.x)
    ay = torch.abs(rd.y)
    az = torch.abs(rd.z)
    vmax = torch.maximum(ax, torch.maximum(ay, az))
    is_x = vmax == ax
    is_y = (~is_x) & (vmax == ay)
    face = torch.where(
        is_x,
        torch.where(rd.x < 0, 1, 0),
        torch.where(is_y, torch.where(rd.y < 0, 3, 2), torch.where(rd.z < 0, 5, 4)),
    )
    inv = 0.5 / torch.clamp_min(vmax, 1e-20)
    u = torch.where(is_x, rd.y, rd.x) * inv + 0.5
    v = torch.where(is_x | is_y, rd.z, rd.y) * inv + 0.5
    qu = torch.clamp((u * 4.0).to(torch.int32), 0, 3)
    qv = torch.clamp((v * 4.0).to(torch.int32), 0, 3)
    return (face * 16 + qu * 4 + qv).to(torch.int64)


def sort_rays_key(grid: GridSpec, ro: V3, rd: V3, t_far) -> torch.Tensor:
    """[N] int64 coherence keys: (alive, cell, dir-bin) packed, dead last."""
    key = grid_index_soa(grid, ro) * DIR_BINS + _dir_bin(rd)
    nx, ny, nz = grid.size
    dead_key = nx * ny * nz * DIR_BINS
    if not isinstance(t_far, torch.Tensor):  # one number for all rays (no host copy)
        return torch.full_like(key, dead_key) if t_far <= 0.0 else key
    return torch.where(t_far <= 0.0, dead_key, key)


def sort_perm(keys: torch.Tensor):
    """(perm, inv): keys[perm] is sorted (stably) and x[perm][inv] is x."""
    perm = torch.sort(keys, stable=True).indices
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return perm, inv


@spanned("pt.sort")
def sorted_rays(grid: GridSpec, ro: V3, rd: V3, t_far):
    """Sort a wavefront for coherence.  Returns (ro', rd', t_far', perm):
    lane i of the sorted rays is lane perm[i] of the input; a Python-number
    t_far stays one number.  `unsort_rows(rows, perm)` restores the order
    of results."""
    keys = sort_rays_key(grid, ro, rd, t_far)
    perm = torch.sort(keys, stable=True).indices
    cols = [*ro, *rd]
    per_ray_t_far = isinstance(t_far, torch.Tensor)
    if per_ray_t_far:
        cols.append(torch.broadcast_to(t_far, ro.x.shape))
    block = torch.stack(cols, dim=0)[:, perm]
    t_far_s = block[6] if per_ray_t_far else t_far
    return V3(block[0], block[1], block[2]), V3(block[3], block[4], block[5]), t_far_s, perm


@spanned("pt.sort")
def unsort_rows(rows, perm: torch.Tensor):
    """Restore the original lane order of [N] results of sorted rays."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return [r[inv] for r in rows]
