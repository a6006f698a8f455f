"""Uniform spatial grid: AABB -> cell index math (backs the light grid).

Counterpart of `pim_tpu.math.grid`.  Extents are Python ints; `lo` is a
float32 numpy array of 3, applied as float32 constants.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from pimbench.reference.frozen.math.vec3 import V3, f32


class GridSpec(NamedTuple):
    lo: np.ndarray                # [3] float32 world-space lower bound
    size: Tuple[int, int, int]    # cell counts per axis
    cells_per_meter: float


def make_grid(bounds_lo, bounds_hi, cells_per_meter: float) -> GridSpec:
    lo = np.asarray(bounds_lo, np.float32)
    hi = np.asarray(bounds_hi, np.float32)
    sizef = np.ceil((hi - lo) * cells_per_meter)
    size = tuple(int(max(s, 1)) for s in sizef)
    return GridSpec(lo=lo, size=size, cells_per_meter=float(cells_per_meter))


def grid_len(grid: GridSpec) -> int:
    return grid.size[0] * grid.size[1] * grid.size[2]


def grid_position(grid: GridSpec, index: torch.Tensor) -> torch.Tensor:
    """Cell index [G] -> center position [G, 3]."""
    sx, sy, _ = grid.size
    ix = index % sx
    iy = (index // sx) % sy
    iz = index // (sx * sy)
    mpc = f32(1.0 / grid.cells_per_meter)
    offs = torch.stack(
        [
            (ix.to(torch.float32) + 0.5) * mpc,
            (iy.to(torch.float32) + 0.5) * mpc,
            (iz.to(torch.float32) + 0.5) * mpc,
        ],
        dim=-1,
    )
    lo = torch.as_tensor(grid.lo, dtype=torch.float32, device=index.device)
    return lo + offs


def grid_index_soa(grid: GridSpec, position: V3) -> torch.Tensor:
    """SoA V3 position -> clamped flat cell index (int64)."""
    sx, sy, sz = grid.size
    cpm = f32(grid.cells_per_meter)
    lo = [float(v) for v in grid.lo]

    def axis(p, lo_c, s):
        return torch.clamp(((p - lo_c) * cpm).to(torch.int32), 0, s - 1).to(torch.int64)

    x = axis(position.x, lo[0], sx)
    y = axis(position.y, lo[1], sy)
    z = axis(position.z, lo[2], sz)
    return x + y * sx + z * (sx * sy)
