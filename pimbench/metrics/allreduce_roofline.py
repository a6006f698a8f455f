"""allreduce_roofline.<kind>: the gradient all-reduce's share (percent) of
its bound: 100 x the bound over the device time of rank 0's collective
kernels (`allreduce_ms_per_step`).

The bound is a ring all-reduce's: each rank sends 2 (N - 1) / N of the
bytes reduced over its link, at the H100 SXM's NVLink rate of 450 GB/s a
direction (900 GB/s both ways).  The bytes are the six `DiffParams`
groups' float32 gradients and the loss, from the parameters' shapes
(`reduce_bytes`), whatever implements the reduce; the program's
`reduce.bytes` counter must agree (a test).  The shapes and N come from
the cell's run (`param_shapes`, `ranks`); a run without them reads
nothing."""

import math

from pimbench import spans
from pimbench.metrics import allreduce_ms_per_step

NVLINK_BYTES_PER_S = 450e9
FLOAT_BYTES = 4


def reduce_bytes(shapes) -> int:
    """Bytes all-reduced a step: every group's float32 gradient and the loss."""
    return FLOAT_BYTES * (sum(math.prod(s) for s in shapes) + 1)


def bound_s(shapes, ranks: int) -> float:
    return 2.0 * (ranks - 1) / ranks * reduce_bytes(shapes) / NVLINK_BYTES_PER_S


def read(t, kind):
    ms = allreduce_ms_per_step.read(t, kind)
    found = spans._harness_run()
    if ms is None or found is None:
        return None
    shapes, ranks = getattr(found[0], "param_shapes", None), getattr(found[0], "ranks", 1)
    if not shapes or ranks < 2:
        return None
    return 100.0 * bound_s(shapes, ranks) / (ms / 1e3)
