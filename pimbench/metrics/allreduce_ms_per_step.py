"""allreduce_ms_per_step.<kind>: device ms a step of rank 0's collective
kernels (names beginning `nccl`: the gradient and loss all-reduces) in the
stack pass's traced window.  A kernel's time includes its wait for the
slowest rank.  A world without NCCL (gloo, one card) reads nothing."""


def read(t, kind):
    if t.steps <= 0:
        return None
    us = sum(e.dur for e in t.device if e.cat == "kernel" and e.name.startswith("nccl"))
    return us / 1e3 / t.steps if us > 0 else None
