"""reduce_host_ms_per_step.<kind>: host ms a step inside the program's
`pt.train.reduce` span on rank 0 (waiting for the gradient all-reduces,
averaging the gradients in place, the loss's all-reduce), over the
stackless pass (pimbench/spans.py).  A step with no reduce (one rank, or a
program without the span) reads nothing."""

from pimbench import spans


def read(t, kind):
    s = spans.of(t)
    if s is None or "pt.train.reduce" not in s.by_span:
        return None
    return s.by_span["pt.train.reduce"].host_us / s.steps / 1e3
