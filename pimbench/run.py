"""The benchmark's entry point: one run of one cell.

    python3 -m pimbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in `setup_s`, from the process's start): the cell's
driver builds the scene from the configuration file and warms up every
shape the traffic uses.  With `--trace 0` it then measures for `--seconds`
seconds (`window.run`) and reports the cell's end-to-end metrics; with
`--trace 1` it runs the traffic's traced steps under `torch.profiler` and
reports the per-layer metrics, `busy_s`, `window_s` and a breakdown.
After the window the program's state is freed and the cell's check runs
the plain reference (`pimbench/reference/`) on what the timed path
produced; each number compared is printed beside its limit, last on
standard error and last in the result line (`checks`).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device[, breakdown], checks.  Without a CUDA card, with
fewer cards than the cell asks for, or with JAX or the JAX package loaded
once the window and the check are done, it prints no result and exits
non-zero.
"""

from __future__ import annotations

import os
import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(CHECKOUT, "build", "pimbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "pim_tpu")
TRACE_PATH = os.path.join(CHECKOUT, "build", "pimbench_trace", "window.trace.json")


def process_start() -> float:
    """The process's start on the epoch clock, from /proc (else the time
    this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


def set_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port's nvcc and g++ objects already go to build/pim_tpu_torch/)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's (compared whole: `pim_tpu_torch` is not `pim_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(torch, dev, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def finite(v: float) -> float:
    """A compared number for the result line: a value that is not finite
    (the check could not compare) reads as 1e30, over any limit."""
    v = float(v)
    return v if v == v and abs(v) != float("inf") else 1e30


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def traced_window(torch, dev, drv_run, kind: str):
    """The traffic's traced steps under the profiler, with the calls into
    the intersection and gather layers recorded.  Returns a trace.Traced."""
    from pimbench import hooks, trace
    from pimbench.syncwatch import sync_watch

    syncs = {"count": 0, "at": {}}
    from pimbench.drivers.common import sync

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync(dev)
    with hooks.recording() as calls, torch.profiler.profile(activities=acts,
                                                            with_stack=True) as prof:
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            with sync_watch(dev, syncs):
                for i in range(drv_run.trace_steps):
                    drv_run.step(i)
            sync(dev)
    os.makedirs(os.path.dirname(TRACE_PATH), exist_ok=True)
    prof.export_chrome_trace(TRACE_PATH)
    print(f"# trace {os.path.getsize(TRACE_PATH) / 2**20:.1f} MiB", file=sys.stderr)
    try:
        t = trace.reduce(TRACE_PATH, kind, drv_run.trace_steps, calls,
                         {"scene_build_s": drv_run.scene_build_s})
    finally:
        trace.remove(TRACE_PATH)
    print(f"# host syncs in the traced steps: {syncs['count']} {syncs['at']}", file=sys.stderr)
    return t


def main(argv=None, root: str = CHECKOUT, device: str = None) -> int:
    """One run (see the module docstring).  `root` holds BENCHMARK.json and
    the traffic files; `device` "cpu" is for the CPU tests alone: it skips
    the look for a card."""
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="judge the control (the reference one precision lower) instead "
                         "of the program; not a benchmark run")
    ap.add_argument("--fault", default=None,
                    help="plant a fault in the program (pimbench/faults.py); not a "
                         "benchmark run")
    args = ap.parse_args(argv)
    set_caches()

    import torch

    from pimbench import cell as C
    from pimbench import window

    cell = C.load(args.workload, root)
    if device is None:
        if not torch.cuda.is_available():
            print("pimbench: no CUDA device is available", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell.chips:
            print(f"pimbench: {args.workload} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} are visible", file=sys.stderr)
            return 3
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        print(f"# {power_limit()}", file=sys.stderr)
    else:
        dev = torch.device(device)
    try:
        import pim_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as ex:
        print(f"pimbench: the program is not in this checkout: {ex}", file=sys.stderr)
        return 4

    if args.fault:
        from pimbench import faults
        faults.plant(args.fault)
    drv = C.driver(cell.traffic["driver"])
    run = drv.setup(cell, args.seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - t_start
    print(f"# setup {setup_s:.3f} s (scene build {run.scene_build_s:.3f} s)", file=sys.stderr)

    breakdown = None
    if args.trace:
        traced = traced_window(torch, dev, run, cell.traffic["driver"])
        metrics = {}
        for m in cell.per_layer:
            reader, kind = C.reader(m["name"])
            v = reader.read(traced, kind)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        breakdown = traced.breakdown()
        attempted = run.trace_steps
    else:
        w = window.run(run.step, args.seconds, dev)
        values = run.end_to_end(w)
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
        attempted = w.steps
        print(f"# window {w.wall_s:.3f} s, {w.steps} steps", file=sys.stderr)
    dinfo = (device_info(torch, dev, cell.chips) if dev.type == "cuda"
             else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    if args.trace:
        dinfo["busy_s"] = traced.busy_s
        dinfo["window_s"] = traced.window_s

    t_check = time.perf_counter()
    checks = [(n, finite(v), lim) for n, v, lim in run.check(control=args.control)]
    print(f"# check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    # after the window and the check, so that what the reference loads counts too
    bad = forbidden_modules()
    if bad:
        print(f"pimbench: loaded in the run's process: {bad}", file=sys.stderr)
        return 5
    failed = sum(1 for _, v, lim in checks if not v <= lim)
    for name, v, lim in checks:
        print(f"# check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}",
              file=sys.stderr)
    line = {"correct": failed == 0, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dinfo}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
