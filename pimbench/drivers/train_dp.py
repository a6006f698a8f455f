"""Data-parallel inverse rendering: `render/diff.py::make_train_step` (Adam)
over a world of `ranks` processes, a card a rank: each rank traces its
contiguous rows of the pixels on the whole scene, the gradients and the
loss are averaged over the ranks each step, and every rank takes the same
Adam step.

Rank 0 is the run's own process, on the run's device (cuda:0).  Set-up
spawns ranks 1..N-1 (start method `spawn`) on cuda:1..N-1 (on the CPU for
the CPU tests), with a free localhost coordinator port.  Every rank runs
one intra-op thread, as torchrun starts a job's processes, and builds
the configuration's scene, joins the world (`parallel.dist.init_distributed`:
over gloo, its all-reduces on NCCL where each rank has a card of its own),
renders its rows of the target from the drawn perturbation and drives the
sharded step through the `set_up_steps` steps, as `drivers.train` drives
the one-card step.  Each `step(i)` on rank 0 then broadcasts i to the
workers over the world's gloo group (one small CPU broadcast, no device
sync) and takes its own step; the workers take the same step.  Both traced
passes and the window drive the workers through `step`.

The world's collectives time out after WORLD_TIMEOUT_S.  Rank 0 watches
its workers: one that exits before the run's end ends the run at once
(the others are killed and rank 0 exits non-zero).  A worker dies with
rank 0 (PR_SET_PDEATHSIG) and writes to standard error only.  After the
window the workers send rank 0 their parameters and exit; rank 0 takes
`rank_gap` from them, frees the program's state and runs the train
traffic's check on its own state (`reference.train_dp`).

    python3 -m pimbench.drivers.train_dp [--plant F] [--device cpu] [--root R] -- <run.py args>

runs one run through `pimbench.run.main` with a fault planted on every
rank (not a benchmark run; `--device cpu` is the CPU tests' form):
  reduce_left_out  the gradient all-reduce left out: each rank keeps its
                   own rows' gradient (the loss is still averaged);
  worker_exits     the last rank exits at its first window step.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import os
import signal
import socket
import sys
import threading

import torch
import torch.distributed as dist

from pimbench import scenes
from pimbench.drivers import common
from pimbench.drivers.train import Train
from pimbench.reference.train import perturb, perturbation, sun

WORLD_TIMEOUT_S = 120
PLANTS = ("reduce_left_out", "worker_exits")
CMD_STEP, CMD_PARAMS, CMD_EXIT = 0, 1, 2

planted = None  # set by `main --plant`


def _plant(name) -> None:
    """Plant fault `name` (PLANTS) in this rank's program."""
    if name != "reduce_left_out":
        return
    from pim_tpu_torch.parallel import grad_reduce

    def finish(self, loss):
        for p in self.leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=self.mesh.group)
        return loss / self.mesh.size

    grad_reduce.GradReducer.start = lambda self, i: None
    grad_reduce.GradReducer.finish = finish


class TrainDP(Train):
    """One rank's program state: its scene, its rows of the target and the
    sharded train step, after the set-up steps (the attributes of
    `drivers.train.Train`, whose step, state copies and check it keeps)."""

    def __init__(self, cfg: dict, tr: dict, seed: int, dev, rank: int, ranks: int,
                 coordinator: str, plant=None):
        from pim_tpu_torch.parallel import dist as pdist
        from pim_tpu_torch.parallel import shard
        from pim_tpu_torch.render import diff

        # one intra-op thread a rank, as torchrun starts a job's processes:
        # the ranks' thread pools would otherwise contend for the host's cores
        torch.set_num_threads(1)
        self.cfg, self.tr, self.dev = cfg, tr, dev
        self.seed = seed
        self.seed32 = common.seed32(seed)
        self.rank, self.ranks = rank, ranks
        self.trace_steps = int(tr["trace_steps"])
        w, h = int(cfg["width"]), int(cfg["height"])
        bounces, sky_steps = int(tr["bounces"]), int(tr["sky_steps"])

        self.scene, self.scene_build_s = common.timed(
            lambda: scenes.build(cfg, dev, "program"), dev)
        os.environ["PIM_DIST_INIT_S"] = str(WORLD_TIMEOUT_S)  # the world's timeout
        pdist.init_distributed(coordinator, ranks, rank, device=dev)
        self.mesh = shard.make_mesh(ranks, dev)
        _plant(plant)

        meta, arrays, lights = self.scene
        self.cam = scenes.camera(cfg, "program")
        sun_dir, sun_lum = sun(cfg)
        params = diff.extract_params(meta, arrays, self.cam, sun_dir=sun_dir, sun_lum=sun_lum)
        self.param_shapes = [tuple(p.shape) for p in params]
        self.pert = perturbation(seed, tr)
        _, pixel_ids = pdist.local_pixels(self.mesh, w * h)
        render = diff.make_render_fn(meta, w, h, bounces, sky_steps)
        with torch.no_grad():
            self.target, _ = render(perturb(params, self.pert), arrays, lights, self.cam,
                                    self.sample(-1), pixel_ids)
        init, self.train_step = diff.make_train_step(
            meta, w, h, bounces, sky_steps, float(tr["learning_rate"]), mesh=self.mesh)
        self.params = params
        self.opt = init(params)
        start = [p.detach().clone() for p in params]
        self.losses, self.grads = [], None
        self.set_up_steps = int(tr["set_up_steps"])
        for k in range(self.set_up_steps):
            self._step(k)
            self.losses.append(self.loss.clone())
            if k == 0:
                self.grads = [p.grad.detach().clone() for p in self.params]
        self.changes = [p.detach() - s for p, s in zip(self.params, start)]
        self.kept = None
        self.world = None
        common.sync(dev)

    def step(self, i: int) -> None:
        self.world.command(CMD_STEP, i)
        super().step(i)

    def check(self, control: bool = False):
        from pimbench.reference import train_dp as R

        others = self.world.gather_params(self.params)
        gap = R.rank_gap([p.detach() for p in self.params], others)
        self.world.close()
        return super().check(control) + [("rank_gap", gap, self.tr["limits"]["rank_gap"])]


def _flat(params) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).cpu() for p in params])


def _die_with(parent: int) -> None:
    """Have the kernel kill this process when its parent exits."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def _worker(rank: int, ranks: int, coordinator: str, cfg: dict, tr: dict, seed: int,
            device_type: str, plant, parent: int) -> None:
    """Rank `rank` of the world: set up as rank 0 does, then take every step
    rank 0 broadcasts, send the parameters when asked, exit when told."""
    _die_with(parent)
    os.dup2(2, 1)  # rank 0's standard output ends in the result line
    sys.stdout = sys.stderr
    os.environ.update(PIM_COORDINATOR=coordinator, PIM_NUM_PROCS=str(ranks),
                      PIM_PROC_ID=str(rank))
    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    r = TrainDP(cfg, tr, seed, dev, rank, ranks, coordinator, plant)
    buf = torch.zeros(2, dtype=torch.int64)
    while True:
        dist.broadcast(buf, src=0)
        cmd, arg = buf.tolist()
        if cmd == CMD_STEP:
            if plant == "worker_exits" and rank == ranks - 1:
                os._exit(3)
            r._step(r.set_up_steps + arg)
        elif cmd == CMD_PARAMS:
            dist.gather(_flat(r.params), dst=0)
        else:
            break
    dist.destroy_process_group()  # with rank 0's
    from pimbench.run import forbidden_modules

    bad = forbidden_modules()
    if bad:
        print(f"pimbench: loaded in rank {rank}: {bad}", file=sys.stderr, flush=True)
        sys.exit(5)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """Rank 0's side of the world: the workers' processes, a thread that
    watches them, and the commands."""

    def __init__(self, cfg: dict, tr: dict, seed: int, dev, ranks: int, plant):
        import multiprocessing as mp

        self.ranks = ranks
        self.coordinator = f"127.0.0.1:{_free_port()}"
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(r, ranks, self.coordinator, cfg, tr, seed, dev.type,
                                        plant, os.getpid()))
                      for r in range(1, ranks)]
        for p in self.procs:
            p.start()
        self.closing = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        while not self.closing.wait(0.25):
            for r, p in enumerate(self.procs, 1):
                if p.exitcode is not None and not self.closing.is_set():
                    print(f"pimbench: rank {r} exited ({p.exitcode}) before the run's end",
                          file=sys.stderr, flush=True)
                    self.kill()
                    os._exit(6)

    def kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()

    def command(self, cmd: int, arg: int = 0) -> None:
        dist.broadcast(torch.tensor([cmd, arg], dtype=torch.int64), src=0)

    def gather_params(self, params) -> list:
        """Every worker's parameters (CPU tensors shaped as `params`), by rank."""
        self.command(CMD_PARAMS)
        flat = _flat(params)
        parts = [torch.empty_like(flat) for _ in range(self.ranks)]
        dist.gather(flat, parts, dst=0)
        sizes = [p.numel() for p in params]
        return [[x.reshape(p.shape) for x, p in zip(part.split(sizes), params)]
                for part in parts[1:]]

    def close(self) -> None:
        """Tell the workers to exit, wait for them and leave the world;
        raises if one failed."""
        self.closing.set()
        self.command(CMD_EXIT)
        # with the workers': NCCL's teardown waits for every rank of the group
        dist.destroy_process_group()
        for p in self.procs:
            p.join(timeout=WORLD_TIMEOUT_S)
        self.kill()
        bad = {r: p.exitcode for r, p in enumerate(self.procs, 1) if p.exitcode != 0}
        if bad:
            raise RuntimeError(f"ranks exited with {bad}")


def setup(cell, seed: int, dev) -> TrainDP:
    from pim_tpu_torch.render import diff

    if "mesh" not in inspect.signature(diff.make_train_step).parameters:
        raise SystemExit("pimbench: this program's diff.make_train_step takes no mesh; "
                         "it has no data-parallel train step")
    ranks = int(cell.traffic["ranks"])
    if dev.type == "cuda" and torch.cuda.device_count() < ranks:
        raise SystemExit(f"pimbench: {ranks} ranks need {ranks} cards, "
                         f"{torch.cuda.device_count()} are visible")
    world = World(cell.config, cell.traffic, seed, dev, ranks, planted)
    try:
        run = TrainDP(cell.config, cell.traffic, seed, dev, 0, ranks, world.coordinator,
                      planted)
    except BaseException:
        world.kill()
        raise
    run.world = world
    print(f"# world: {ranks} ranks, all-reduces on {run.mesh.backend}", file=sys.stderr)
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one pimbench run, a fault planted on every rank")
    ap.add_argument("--plant", choices=PLANTS, default=None)
    ap.add_argument("--device", choices=("cpu",), default=None)
    ap.add_argument("--root", default=None)
    args, rest = ap.parse_known_args(argv)
    import pimbench.drivers.train_dp as me  # this module as the harness imports it
    from pimbench import run

    me.planted = args.plant
    return run.main([a for a in rest if a != "--"], root=args.root or run.CHECKOUT,
                    device=args.device)


if __name__ == "__main__":
    sys.exit(main())
