"""What the drivers share: the seed's words and draws, and freeing the
program's state before the reference runs."""

from __future__ import annotations

import gc
import time

import torch

MASK32 = 0xFFFFFFFF


def seed32(seed: int) -> int:
    """The run's seed as the 32-bit word the port's RNG streams take."""
    return int(seed) & MASK32


def generator(seed: int, salt: int) -> torch.Generator:
    """A CPU generator for the harness's own draws (which pixels, steps and
    cells the check samples), keyed by the seed and a salt."""
    return torch.Generator().manual_seed((int(seed) * 1000003 + salt) % (2**63))


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev):
    """(fn(), host seconds it took, synchronised)."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def grid_state(arrays, lights) -> dict:
    """The program's light grid, copied for the check (the reference
    compares a sample of its cells and then renders with it)."""
    return {"cell_active": arrays.cell_active.clone(), "pdf": lights.pdf.clone(),
            "cdf": lights.cdf.clone(), "integral": lights.integral.clone(),
            "sum": lights.sum.clone(), "live": lights.live.clone()}


def free(dev) -> None:
    """Return the freed program state's memory before the reference runs."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
