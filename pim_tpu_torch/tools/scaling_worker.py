"""One process of a scaling world: a pixel-sharded Cornell render or a
texel-sharded lightmap bake over the ranks of `parallel.dist`.

Counterpart of tools/scaling_worker.py, with its environment contract:
  PIM_PROC_ID, PIM_NUM_PROCS, PIM_COORDINATOR, PIM_DIST_INIT_S  the world
      (parallel/dist.py)
  PIM_SCALE_MODE        "lmbake" for the bake, else the render
  PIM_SCALE_W / _H      per-rank frame (weak scaling: H grows with the world;
                        default 64 x 64)
  PIM_SCALE_STEPS       timed steps or bake passes (default 8)
  PIM_SCALE_BOUNCES     bounces (default 3)
  PIM_SCALE_LM_ROOMS / _LM_DENSITY  the bake's map (rooms x rooms) and
                        texels per meter (default 2, 4.0)
  PIM_DEVS_PER_PROC     must be 1: a rank drives one device

Rank 0 prints one JSON line with the timing.  Each rank runs on its card
(`--device cpu` for CPU ranks):

    PIM_NUM_PROCS=2 PIM_PROC_ID=0 python -m pim_tpu_torch.tools.scaling_worker &
    PIM_NUM_PROCS=2 PIM_PROC_ID=1 python -m pim_tpu_torch.tools.scaling_worker
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from pim_tpu_torch.parallel.dist import (allgather_rows, default_device, global_mesh,
                                         init_distributed)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _sync(mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    if dist.is_initialized():
        dist.barrier()


def render_main(info, mesh, steps: int, bounces: int) -> dict:
    """Weak scaling: each rank keeps PIM_SCALE_W x PIM_SCALE_H pixels of a
    Cornell frame whose height grows with the world."""
    from pim_tpu_torch.app import bench_camera, build_cornell_scene
    from pim_tpu_torch.parallel.shard import make_sharded_render_step

    width = _env_int("PIM_SCALE_W", 64)
    height = _env_int("PIM_SCALE_H", 64) * info.num_processes
    meta, arrays, lights = build_cornell_scene(mesh.device)
    cam = bench_camera("cornell", width, height)
    step = make_sharded_render_step(meta, mesh, width, height, max_bounces=bounces)
    for i in range(2):
        step(arrays, lights, cam, i)
    _sync(mesh)
    t0 = time.perf_counter()
    for i in range(steps):
        step(arrays, lights, cam, 2 + i)
    _sync(mesh)
    wall = time.perf_counter() - t0
    n = width * height
    return {"nprocs": info.num_processes, "devices": mesh.size, "pixels": n, "steps": steps,
            "bounces": bounces, "wall_s": round(wall, 4),
            "mpaths_per_s": round(n * steps / wall / 1e6, 4)}


def shard_range(t_total: int, rank: int, ranks: int):
    """(offset, count, per): a rank's contiguous slice of t_total texels,
    `per` = ceil(t_total / ranks) each, the last slice shorter."""
    per = -(-t_total // ranks)
    off = rank * per
    return off, max(min(per, t_total - off), 0), per


def gather_shards(pack, off: int, cnt: int, per: int):
    """The pack with every rank's rows of probes and sample counts (slices of
    `per` texels, the last maybe shorter) reassembled by `allgather_rows`."""
    t_total = pack.position.shape[1]
    sl = slice(off, off + cnt)

    def padded(x):
        out = np.zeros((per,) + tuple(x.shape[1:]), np.float32)
        out[:cnt] = x[sl].cpu().numpy()
        return out

    probes = allgather_rows(padded(pack.probes))[:t_total]
    counts = allgather_rows(padded(pack.sample_counts))[:t_total]
    dev = pack.probes.device
    return pack._replace(probes=torch.from_numpy(probes).to(dev),
                         sample_counts=torch.from_numpy(counts).to(dev))


def lmbake_main(info, mesh, steps: int) -> dict:
    """Strong scaling over one map's texels: each rank bakes its contiguous
    slice of the texel axis; the RNG is keyed by (texel id, frame), so the
    sharded bake is bit for bit the whole one.  The slices are gathered back
    after the timed passes."""
    from pim_tpu_torch.geom.entities import flatten
    from pim_tpu_torch.geom.maps import build_map_scene
    from pim_tpu_torch.render import lightmap as lm
    from pim_tpu_torch.render.scene import build_scene

    rooms = _env_int("PIM_SCALE_LM_ROOMS", 2)
    density = float(os.environ.get("PIM_SCALE_LM_DENSITY", "4.0"))
    bounces = _env_int("PIM_SCALE_BOUNCES", 2)
    ents, pool = build_map_scene(rooms=(rooms, rooms), spheres_per_room=2, sphere_steps=8,
                                 tex_size=16, seed=1)
    meta, arrays, lights = build_scene(ents, pool, mesh.device)
    flat = flatten(ents)
    pack = lm.pack_lightmaps(flat.positions, flat.normals, texels_per_meter=density,
                             device=mesh.device)
    t_total = pack.position.shape[1]
    off, cnt, per = shard_range(t_total, info.process_id, info.num_processes)
    pack = lm.bake_step(meta, arrays, lights, pack, 0, max_bounces=bounces, texel_offset=off,
                        texel_count=cnt)  # warm-up
    _sync(mesh)
    t0 = time.perf_counter()
    for f in range(1, steps + 1):
        pack = lm.bake_step(meta, arrays, lights, pack, f, max_bounces=bounces,
                            texel_offset=off, texel_count=cnt)
    _sync(mesh)
    wall = time.perf_counter() - t0
    gather_shards(pack, off, cnt, per)
    return {"mode": "lmbake", "nprocs": info.num_processes, "devices": mesh.size,
            "pixels": int(t_total), "steps": steps, "bounces": bounces,
            "wall_s": round(wall, 4), "mpaths_per_s": round(t_total * steps / wall / 1e6, 4)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="this rank's device (default: its card, cards taken round-robin)")
    args = ap.parse_args(argv)
    if _env_int("PIM_DEVS_PER_PROC", 1) != 1:
        raise SystemExit("PIM_DEVS_PER_PROC: a rank of the port drives one device")
    steps = _env_int("PIM_SCALE_STEPS", 8)
    bounces = _env_int("PIM_SCALE_BOUNCES", 3)
    rank = _env_int("PIM_PROC_ID", 0)
    device = torch.device(args.device) if args.device else default_device(rank)
    info = init_distributed(device=device)
    mesh = global_mesh(device)
    if os.environ.get("PIM_SCALE_MODE") == "lmbake":
        out = lmbake_main(info, mesh, steps)
    else:
        out = render_main(info, mesh, steps, bounces)
    if info.is_main:
        print(json.dumps(out), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
