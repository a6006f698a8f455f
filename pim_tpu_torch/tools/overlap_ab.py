"""A/B of the gradient all-reduces overlapping the backward, on a world of ranks.

    python -m pim_tpu_torch.tools.overlap_ab [--ranks 2] [--res 32] [--steps 20]
        [--device cuda|cpu] [--out FILE]

Counterpart of `tools/overlap_ab.py`.  Spawns a world of RANKS processes
(`parallel.dryrun.spawn_world`; gloo on the CPU or for ranks sharing a
card, NCCL only with a card a rank, as `parallel/dist.py` decides).  Each
rank builds Cornell on its device and makes the sharded train step twice
(`parallel/shard.py::make_sharded_train_step`, 3 bounces):

  A: serialize_reduce=False, each group's all_reduce started from its
     post-accumulate hook while the backward runs on;
  B: serialize_reduce=True, every all_reduce after the whole backward.

From the same parameters and light state, each schedule takes one untimed
step, then STEPS steps in turns (A before B in even steps, B before A in
odd ones), each step between a barrier and a device sync, timed by the
host clock; each schedule carries its own parameters.  Rank 0 prints the
mean ms a step of each, the overlap benefit (t_B - t_A) / t_B, and whether
the two schedules' parameters after the steps are bit for bit equal (the
same sums in the same order; on the card K3-bwd's float atomics may order
them differently).  On one card the ranks' collectives are host copies
beside one device, so no benefit can show there.  The result goes to
stdout and, with --out, to FILE; rank 0 hands it over in WORKDIR.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORKDIR = os.path.join(ROOT, "build", "overlap_ab")
RANKS = 2
RES = 32
STEPS = 20
BOUNCES = 3
RESULT = "overlap_ab_rank0.json"


def _rank_main(workdir: str, res: int, steps: int, device) -> None:
    """One rank: both schedules in turns; rank 0 writes the result."""
    import torch.distributed as dist

    from pim_tpu_torch.app import bench_camera, build_cornell_scene
    from pim_tpu_torch.parallel.dist import init_distributed
    from pim_tpu_torch.parallel.shard import make_mesh, make_sharded_train_step
    from pim_tpu_torch.render.diff import extract_params

    info = init_distributed(device=device)
    mesh = make_mesh(info.num_processes, device)
    meta, arrays, lights = build_cornell_scene(mesh.device)
    cam = bench_camera("cornell", res, res)
    target = torch.zeros((res * res, 3), dtype=torch.float32, device=mesh.device)
    start = extract_params(meta, arrays, cam)
    chains = {}
    for tag, serialize in (("overlapped", False), ("serialized", True)):
        step = make_sharded_train_step(meta, mesh, res, res, max_bounces=BOUNCES,
                                       serialize_reduce=serialize)
        _, params, lights_t = step(start, arrays, lights, cam, target, 0)  # untimed
        chains[tag] = {"step": step, "params": params, "lights": lights_t, "ms": [],
                       "losses": []}

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        if dist.is_initialized():
            dist.barrier()

    for i in range(steps):
        for tag in (("overlapped", "serialized") if i % 2 == 0 else ("serialized", "overlapped")):
            c = chains[tag]
            sync()
            t0 = time.perf_counter()
            loss, c["params"], c["lights"] = c["step"](c["params"], arrays, c["lights"], cam,
                                                       target, 1 + i)
            sync()
            c["ms"].append((time.perf_counter() - t0) * 1e3)
            c["losses"].append(float(loss))
    if info.is_main:
        a, b = chains["overlapped"], chains["serialized"]
        diffs = [float((pa - pb).abs().max()) for pa, pb in zip(a["params"], b["params"])]
        t_a = sum(a["ms"]) / len(a["ms"])
        t_b = sum(b["ms"]) / len(b["ms"])
        result = {
            "ranks": info.num_processes, "device": str(mesh.device), "backend": mesh.backend,
            "res": res, "steps": steps, "bounces": BOUNCES,
            "overlapped_ms": t_a, "serialized_ms": t_b, "benefit": (t_b - t_a) / t_b,
            "overlapped_steps_ms": a["ms"], "serialized_steps_ms": b["ms"],
            "params_equal": all(torch.equal(pa.view(torch.int32), pb.view(torch.int32))
                                for pa, pb in zip(a["params"], b["params"])),
            "max_abs_param_diff": max(diffs),
            "losses": {"overlapped": a["losses"], "serialized": b["losses"]},
        }
        with open(os.path.join(workdir, RESULT), "w") as f:
            json.dump(result, f)


def run(ranks: int = RANKS, res: int = RES, steps: int = STEPS, device=None,
        workdir: str = WORKDIR) -> dict:
    """Spawn the world (device: each rank's, None for its card) and return
    rank 0's result."""
    from pim_tpu_torch.parallel.dryrun import spawn_world

    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, RESULT)
    if os.path.exists(path):
        os.remove(path)
    threads = max(1, (os.cpu_count() or 1) // ranks) if device == "cpu" else None
    spawn_world(ranks, _rank_main, (workdir, res, steps, device), threads=threads)
    with open(path) as f:
        return json.load(f)


def report(r: dict, card: str = "") -> str:
    one_card = (r["device"].startswith("cuda") and r["backend"] != "nccl")
    note = ("; the ranks share one card, so no overlap benefit can show" if one_card else "")
    return (f"overlap_ab Cornell {r['res']}^2 {r['bounces']} bounces, {r['ranks']} ranks on "
            f"{r['device']} ({r['backend']}), {r['steps']} steps each in turns: overlapped "
            f"{r['overlapped_ms']:.3f} ms/step, serialized {r['serialized_ms']:.3f} ms/step -> "
            f"benefit (t_B - t_A) / t_B = {r['benefit']:+.4f}; parameters bit for bit equal "
            f"{r['params_equal']} (max |diff| {r['max_abs_param_diff']:.3g}){note}"
            + (f" [{card}]" if card else ""))


def main(argv=None) -> int:
    from pim_tpu_torch.app import card, check_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=RANKS)
    ap.add_argument("--res", type=int, default=RES)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None, help="file for the result line and its JSON")
    args = ap.parse_args(argv)
    check_device(torch.device(args.device))
    r = run(args.ranks, args.res, args.steps, "cpu" if args.device == "cpu" else None)
    line = report(r, ", ".join(str(c) for c in card(args.device)))
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n\n```json\n" + json.dumps(r, indent=1) + "\n```\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
