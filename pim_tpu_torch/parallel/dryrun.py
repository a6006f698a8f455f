"""The multichip dry run: one sharded differentiable train step over a
process world, and its launcher.

Counterpart of `__graft_entry__.py`'s `entry` and `dryrun_multichip`.  The
launcher spawns one process a rank (start method `spawn`, which CUDA
needs), sets each rank's PIM_* variables (parallel/dist.py) and fails if
any rank fails:

    python -m pim_tpu_torch.parallel.dryrun --ranks 2 --device cpu
    python -m pim_tpu_torch.parallel.dryrun --ranks 2    # both ranks on the card

On one card two ranks reduce over gloo (NCCL refuses two ranks on one
device); with a card a rank, over NCCL.
"""

from __future__ import annotations

import argparse
import math
import os
import socket
import sys

import numpy as np
import torch

from pim_tpu_torch.parallel.dist import init_distributed
from pim_tpu_torch.parallel.shard import make_mesh, make_sharded_train_step


def _build_small_scene(device):
    from pim_tpu_torch.geom.cornell import build_cornell_box
    from pim_tpu_torch.render.scene import build_scene

    return build_scene(*build_cornell_box("boxes"), device)


def _camera(width, height):
    from pim_tpu_torch.render.camera import Camera, DofInfo, camera_arrays

    cam = Camera(position=np.array([-4, 0, 4], np.float32))
    cam.look_at([0, -1, 0])
    return camera_arrays(cam, DofInfo(autofocus=False), width, height)


def entry(device="cuda"):
    """Returns (fn, example_args): one progressive path-traced frame of the
    Cornell box (64^2, 3 bounces) on `device`."""
    from pim_tpu_torch.core import rng
    from pim_tpu_torch.render.camera import generate_primary_rays
    from pim_tpu_torch.render.integrator import trace_rays

    meta, arrays, lights = _build_small_scene(device)
    width = height = 64
    cam = _camera(width, height)

    def forward(arrays, lights, cam, sample_idx):
        n = width * height
        state = rng.make_state(torch.arange(n, device=arrays.tri_table.device), sample_idx)
        state, ro, rd = generate_primary_rays(cam, width, height, state)
        return trace_rays(meta, arrays, lights, ro, rd, state, max_bounces=3).color

    return forward, (arrays, lights, cam, 0)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run ONE sharded differentiable train step over a world of
    `n_devices` ranks (pixels split over the ranks, the scene replicated,
    gradients and histograms all-reduced) on Cornell 'boxes' at 16^2, 2
    bounces.  Goes through `init_distributed()` first, as a real launch
    does (a no-op in a world of one).  device: this rank's device (default:
    its card)."""
    from pim_tpu_torch.render.diff import extract_params

    info = init_distributed(device=device)
    assert info.num_processes >= 1
    mesh = make_mesh(n_devices, device)

    meta, arrays, lights = _build_small_scene(mesh.device)
    # the reference doubles a 16^2 frame's width until its pixels divide the
    # world, which never ends for a world with an odd factor; this is the
    # width it reaches wherever it ends
    width, height = 16 * (n_devices // math.gcd(n_devices, 256)), 16
    cam = _camera(width, height)

    step = make_sharded_train_step(meta, mesh, width, height, max_bounces=2)
    params = extract_params(meta, arrays, cam)
    target = torch.zeros((width * height, 3), dtype=torch.float32, device=mesh.device)
    loss, new_params, _ = step(params, arrays, lights, cam, target, 0)
    loss = float(loss)
    assert np.isfinite(loss), "dryrun loss is not finite"
    moved = float(torch.max(torch.abs(new_params.mat_albedo - params.mat_albedo)))
    assert moved > 0.0, "gradients did not flow into the material table"
    print(f"dryrun_multichip({n_devices}): loss={loss:.6f} ok", flush=True)


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, ranks: int, coordinator: str, threads, fn, args) -> None:
    os.environ.update(PIM_COORDINATOR=coordinator, PIM_NUM_PROCS=str(ranks),
                      PIM_PROC_ID=str(rank))
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        fn(*args)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(ranks: int, fn, args=(), coordinator=None, threads=None) -> None:
    """Run fn(*args) in `ranks` spawned processes, each with its PIM_*
    variables set (coordinator default: a free localhost port) and, when
    given, `threads` torch threads.  Raises if any rank fails; the others
    are then stopped."""
    import torch.multiprocessing as mp

    coordinator = coordinator or f"127.0.0.1:{free_port()}"
    mp.start_processes(_rank_main, args=(ranks, coordinator, threads, fn, args), nprocs=ranks,
                       join=True, start_method="spawn")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    device = "cpu" if args.device == "cpu" else None  # None: each rank its card, round-robin
    if args.ranks == 1:
        dryrun_multichip(1, device)
    else:
        threads = max(1, (os.cpu_count() or 1) // args.ranks) if device == "cpu" else None
        spawn_world(args.ranks, dryrun_multichip, (args.ranks, device), threads=threads)
    return 0


if __name__ == "__main__":
    sys.exit(main())
