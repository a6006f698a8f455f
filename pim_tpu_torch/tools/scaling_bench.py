"""Scaling harness: worlds of `scaling_worker` processes, timed.

    python -m pim_tpu_torch.tools.scaling_bench [--device cuda|cpu] [--out FILE] [procs ...]

Counterpart of `tools/scaling_bench.py`.  Launches
`python -m pim_tpu_torch.tools.scaling_worker` as N processes joined
through `parallel.dist` (the worker's PIM_* environment contract; each
world on a free localhost port), once per world and PIM_SCALE_REPEATS
times (default 3), and keeps each world's best run: a shared host adds
one-sided noise.

  --device cuda (the default; an error with no GPU): each rank takes its
      card round-robin (`default_device`), so ranks beyond the card count
      share a card and reduce over gloo.
  --device cpu (as the JAX harness ran JAX_PLATFORMS=cpu): each rank is
      pinned to its own core with `taskset` (highest core first)
      and runs one torch thread, so a rank's compute stays constant as the
      world grows and the efficiency measures the collectives and the
      synchronisation.  Worlds larger than the core count are refused
      unless PIM_SCALE_OVERSUBSCRIBE=1 (they measure host contention).

PIM_SCALE_MODE=lmbake times the texel-sharded lightmap bake (strong
scaling: one map's texels split over the ranks; ideal: the wall halves a
doubling); otherwise the pixel-sharded Cornell render (weak scaling: each
rank keeps PIM_SCALE_W x PIM_SCALE_H pixels).  Efficiency(N) = paths/s at
N / (N x paths/s of the first world's rank), which is the weak-scaling
efficiency for the render and speedup / N for the bake.  Worlds are
process counts (default 1 2); a rank drives one device.

It prints each world's JSON line and the table, and writes the table and
the rows to FILE only when --out is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NCORES = os.cpu_count() or 1
WORLD_TIMEOUT_S = 1800


def run_world(nprocs: int, device: str, steps=None) -> dict:
    """One run of a world of `nprocs` worker processes; rank 0's JSON line."""
    from pim_tpu_torch.parallel.dryrun import free_port

    if steps is None:
        steps = int(os.environ.get("PIM_SCALE_STEPS", "32"))
    pinned = device == "cpu" and nprocs <= NCORES
    if device == "cpu" and not pinned and not os.environ.get("PIM_SCALE_OVERSUBSCRIBE"):
        raise SystemExit(f"world {nprocs} > {NCORES} cores: oversubscribed numbers measure host "
                         "contention, not scaling; set PIM_SCALE_OVERSUBSCRIBE=1 to force")
    path = os.environ.get("PYTHONPATH", "")
    env = dict(os.environ, PIM_COORDINATOR=f"127.0.0.1:{free_port()}",
               PIM_NUM_PROCS=str(nprocs), PIM_SCALE_STEPS=str(steps), PIM_DEVS_PER_PROC="1",
               PYTHONPATH=ROOT + (os.pathsep + path if path else ""))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs = []
    try:
        for rank in range(nprocs):
            argv = [sys.executable, "-m", "pim_tpu_torch.tools.scaling_worker"]
            if device == "cpu":
                argv += ["--device", "cpu"]
            if pinned:
                # core 0 also hosts the OS's work, so rank 0 (the reporting
                # rank) gets the quietest core
                argv = ["taskset", "-c", str(NCORES - 1 - rank)] + argv
            procs.append(subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          env=dict(env, PIM_PROC_ID=str(rank)), text=True))
        outs = [p.communicate(timeout=WORLD_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} of world {nprocs} exited {p.returncode}:\n"
                               f"{err[-2000:]}")
    for line in outs[0][0].splitlines():
        if line.strip().startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"rank 0 of world {nprocs} printed no result; stderr:\n"
                       f"{outs[0][1][-2000:]}")


def best_runs(worlds, device: str, repeats: int) -> list:
    """Each world's best of `repeats` runs, with its launch wall."""
    rows = []
    for n in worlds:
        best = None
        for _ in range(repeats):
            t0 = time.perf_counter()
            r = run_world(n, device)
            r["launch_s"] = round(time.perf_counter() - t0, 3)
            if best is None or r["mpaths_per_s"] > best["mpaths_per_s"]:
                best = r
        print(json.dumps(best), flush=True)
        rows.append(best)
    return rows


def add_efficiency(rows) -> list:
    """Each row's efficiency and speedup against the first row."""
    base = rows[0]["mpaths_per_s"]
    for r in rows:
        r["speedup"] = r["mpaths_per_s"] / base
        r["efficiency"] = r["mpaths_per_s"] / (base / rows[0]["nprocs"] * r["nprocs"])
    return rows


def table(rows, device: str) -> str:
    lmbake = rows[0].get("mode") == "lmbake"
    kind = ("strong scaling of the texel-sharded lightmap bake (texels fixed)" if lmbake
            else "weak scaling of the pixel-sharded Cornell render (pixels a rank fixed)")
    pin = ("each rank pinned to its own core, one torch thread" if device == "cpu"
           else "each rank on its card, round-robin")
    lines = [f"`python -m pim_tpu_torch.tools.scaling_bench --device {device}`: {kind}; "
             f"{pin}; best of PIM_SCALE_REPEATS runs a world.", "",
             f"| procs | devices | {'texels' if lmbake else 'pixels'} | steps | bounces | "
             "wall s | Mpaths/s | speedup | efficiency |", "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(f"| {r['nprocs']} | {r['devices']} | {r['pixels']} | {r['steps']} | "
                     f"{r['bounces']} | {r['wall_s']} | {r['mpaths_per_s']:.4f} | "
                     f"{r['speedup']:.3f} | {r['efficiency'] * 100:.1f}% |")
    return "\n".join(lines)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("worlds", nargs="*", type=int, default=[1, 2])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None, help="file for the table and the rows")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        from pim_tpu_torch.app import check_device

        check_device(torch.device("cuda"))
    repeats = int(os.environ.get("PIM_SCALE_REPEATS", "3"))
    rows = add_efficiency(best_runs(args.worlds, args.device, repeats))
    text = table(rows, args.device)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n\n```json\n" + json.dumps(rows, indent=1) + "\n```\n")
    return rows


if __name__ == "__main__":
    main()
