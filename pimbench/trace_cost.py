"""What the tracing costs: ms a step of one cell in four modes.

    python3 -m pimbench.trace_cost --workload e1m1-render --seed <n> [--steps 6] [--rounds 3]

The cell is set up as a benchmark run sets it up (its traffic code, its
warm-up); then each reading times `--steps` queued steps (host clock, one
sync at the end) in one mode:
  off        the program's tracing off, no profiler (what `--trace 0` runs);
  on         tracing on, no profiler (the spans' ranges and the counters);
  stackless  tracing on under torch.profiler(CPU, CUDA) without stacks
             (the pass pimbench/spans.py reduces);
  stack      tracing off under torch.profiler with stacks and the hooks
             (the pass pimbench/trace.py reduces).
The readings run in three phases of `--rounds` rounds each: off and on in
turns, then stackless and stack in turns, then off and on again (`after`:
whether a profiler leaves a cost behind in the process).  Prints one JSON
line: the card, the median ms a step of each mode and phase, every
reading.  The step indices run on from reading to reading; the check is
not run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time

def _timed(torch, dev, step, first: int, steps: int, mode: str) -> float:
    from pim_tpu_torch.core import profiler
    from pimbench import hooks
    from pimbench.drivers.common import sync

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    profiler.set_tracing(mode in ("on", "stackless"))
    profiler.reset_counters()
    sync(dev)
    with contextlib.ExitStack() as ctx:
        if mode == "stack":
            ctx.enter_context(hooks.recording())
        if mode in ("stackless", "stack"):
            ctx.enter_context(torch.profiler.profile(activities=acts,
                                                     with_stack=mode == "stack"))
        t0 = time.perf_counter()
        for i in range(first, first + steps):
            step(i)
        sync(dev)
        ms = (time.perf_counter() - t0) / steps * 1e3
    profiler.set_tracing(False)
    profiler.reset_counters()
    return ms


def main(argv=None, device: str = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--root", default=None, help="the benchmark root (default: this checkout)")
    args = ap.parse_args(argv)

    import torch

    from pimbench import cell as C
    from pimbench.run import CHECKOUT, power_limit, set_caches

    set_caches()
    if device is None:
        if not torch.cuda.is_available():
            print("trace_cost: no CUDA device is available", file=sys.stderr)
            return 3
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        card = power_limit()
    else:
        dev = torch.device(device)
        card = "cpu"
    cell = C.load(args.workload, args.root or CHECKOUT)
    run = C.driver(cell.traffic["driver"]).setup(cell, args.seed, dev)
    phases = (("before", ("off", "on")), ("profiled", ("stackless", "stack")),
              ("after", ("off", "on")))
    readings = {}
    first = 0
    for phase, modes in phases:
        for r in range(args.rounds):
            for mode in (modes if r % 2 == 0 else modes[::-1]):
                key = mode if phase == "profiled" else f"{mode}_{phase}"
                ms = _timed(torch, dev, run.step, first, args.steps, mode)
                readings.setdefault(key, []).append(ms)
                first += args.steps
                print(f"# {key} {ms:.3f} ms a step", file=sys.stderr)
    print(json.dumps({"workload": args.workload, "card": card, "steps": args.steps,
                      "ms_per_step": {k: statistics.median(v) for k, v in readings.items()},
                      "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
