"""host_ms_per_step.<kind>: host ms a step inside the program's top-level
`pt.*` spans (the steps' enqueue, the harness's own code left out), mean
over the stackless pass's steps (pimbench/spans.py)."""

from pimbench import spans


def read(t, kind):
    s = spans.of(t)
    if s is None or s.top_host_us <= 0.0:
        return None
    return s.top_host_us / s.steps / 1e3
