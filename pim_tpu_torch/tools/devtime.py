"""Device time of a call, with the calls queued ahead of the device.

`queued_ms` holds the stream with a GPU sleep, records a CUDA event, queues
`calls` calls of fn() and a second event while the device still sleeps,
then synchronises: the device runs the calls back to back, without waiting
on the host, and the time between the two events is theirs alone.  The
caller warms fn up (one call, synchronised) before the first timing.
"""

from __future__ import annotations

import torch

QUEUE_CYCLES = 40_000_000  # GPU sleep ahead of the queued calls


def queued_ms(fn, calls: int, sleep_cycles: int = QUEUE_CYCLES):
    """(device ms a call over `calls` queued calls of fn(), whether the host
    queued them all before the device reached the first)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    ahead = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls, ahead
