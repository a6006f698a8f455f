"""Where the time of one progressive step goes, on a CUDA device.

    python -m pim_tpu_torch.tools.prof_frame [--scene cornell|e1m1] [--train] [--media]
        [--bounces N] [--out DIR]

Builds the scene on the card and renders steps of its 512^2, 10-bounce
bench frame at SPP[scene] samples each (2 for Cornell, 1 for e1m1, whose
steps also run the exposure pass): one warm-up step, WALLS untraced steps
(host wall clock after `torch.cuda.synchronize`), then one step traced with
`torch.profiler`.  With `--train` a step is instead one training step of the
differentiable path (render/diff.py): 512^2, TRAIN_BOUNCES bounces, 1 spp,
every parameter group trainable, Adam against a target rendered with the
albedos moved (x0.8); the sky is re-baked at the scene's own bake steps.
With `--media` the steps march the default participating medium (one
sample a step; `--bounces` cuts the depth, since a media step launches
~125k kernels a segment and the trace grows with them).
From the trace it prints:

  - the device time of every CUDA kernel of the traced step, summed, and
    the kernel count;
  - the busy share: that traced device time over the median wall of the
    untraced steps.  The two come from different runs of the same step (the
    profiler inflates the traced step's own wall many times over), so the
    share estimates how much of an untraced step the device works;
  - the device time by kernel group (GROUPS: each kernel goes to the first
    group whose name fragment its name holds, else to "other");
  - the host ops (aten::*) with the most self CPU time.

With `--out DIR` it also writes DIR/kernels.txt (the profiler's table,
by self device time) and DIR/summary.json (every number printed).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch

WIDTH = HEIGHT = 512
BOUNCES = 10
SPP = {"cornell": 2, "e1m1": 1}  # samples per profiled step
WALLS = 3  # untraced steps timed for the busy share
TRAIN_BOUNCES = 3  # make_render_fn's default

# (group, name fragments), in the order a kernel name is matched
GROUPS = (
    ("K1 dense_isect", ("dense_isect_kernel",)),
    ("K2 dense_anyhit", ("dense_anyhit_kernel",)),
    ("K3 gather_cols", ("gather_cols_kernel", "gather_cols_rows_kernel")),
    ("K3-bwd gather_cols_bwd", ("gather_cols_bwd_kernel", "gather_cols_bwd_rows_kernel")),
    ("K4 cluster_isect", ("cluster_isect_kernel",)),
    ("K5 cluster_anyhit", ("cluster_anyhit_kernel",)),
    ("K6 gather_bilinear", ("gather_bilinear_kernel",)),
    ("K7 gather_texels", ("gather_texels_kernel",)),
    ("K7-bwd gather_texels_bwd", ("gather_texels_bwd_kernel", "gather_texels_bwd_rows_kernel")),
    ("torch index/gather/scatter", ("index", "scatter", "gather")),
    ("torch sort/scan", ("sort", "scan", "radix")),
    ("torch reduce", ("reduce",)),
    ("torch elementwise", ("elementwise",)),
)


def kernel_group(name: str) -> str:
    for group, fragments in GROUPS:
        if any(f in name for f in fragments):
            return group
    return "other"


def _device_ms(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
        us = evt.self_cuda_time_total
    return us / 1e3


def _is_kernel(evt) -> bool:
    return evt.device_type == torch.autograd.DeviceType.CUDA


def device_time(avgs):
    """(device events, their summed device ms, their count) of a
    profiler's key_averages."""
    kernels = [e for e in avgs if _is_kernel(e)]
    return kernels, sum(_device_ms(e) for e in kernels), sum(e.count for e in kernels)


def _train_step_fn(scene, cam, dev):
    """step(i) of the differentiable path: one Adam step of every group."""
    from pim_tpu_torch.app import SKY_STEPS, SUN_DIR, SUN_LUM
    from pim_tpu_torch.render import diff

    meta, arrays, lights = scene
    params = diff.extract_params(meta, arrays, cam, sun_dir=SUN_DIR, sun_lum=(SUN_LUM,) * 3)
    with torch.no_grad():
        target, _ = diff.make_render_fn(meta, WIDTH, HEIGHT, TRAIN_BOUNCES, SKY_STEPS)(
            params._replace(mat_albedo=params.mat_albedo * 0.8), arrays, lights, cam, 0)
    init, train = diff.make_train_step(meta, WIDTH, HEIGHT, TRAIN_BOUNCES, SKY_STEPS)
    opt = init(params)

    def step(i: int):
        train(params, opt, arrays, lights, cam, target, i)
        torch.cuda.synchronize(dev)

    return step


def frame_step(scene_name: str, scene, dev, spp: int, bounces: int, width: int = WIDTH,
               height: int = HEIGHT):
    """step(i) of the bench frame: `spp` samples of step i (the exposure
    pass too where the scene runs it), then a sync of a CUDA device."""
    from pim_tpu_torch.app import EXPOSURE_DT, SCENES, bench_camera, render_step
    from pim_tpu_torch.render.exposure import (
        ExposureParams,
        exposure_pass,
        make_exposure_state,
    )

    cam = bench_camera(scene_name, width, height)
    exp_params = ExposureParams.from_cvars() if SCENES[scene_name].exposed else None

    def step(i: int):
        res = render_step(scene, cam, width, height, bounces, spp, i)
        if exp_params is not None:
            exposure_pass(res.color, exp_params, make_exposure_state(dev), EXPOSURE_DT)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return res

    return step


def untraced_walls(step, first: int = 1):
    """Host walls (s) of WALLS untraced steps first, first + 1, ... (each
    ends in a device sync) and their median in ms."""
    walls = []
    for i in range(WALLS):
        t0 = time.perf_counter()
        step(first + i)
        walls.append(time.perf_counter() - t0)
    return walls, statistics.median(walls) * 1e3


def main(argv=None) -> None:
    from pim_tpu_torch import native
    from pim_tpu_torch.app import SCENES, bench_camera, card

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="cornell", choices=sorted(SPP))
    ap.add_argument("--train", action="store_true",
                    help="profile a training step of the differentiable path")
    ap.add_argument("--media", action="store_true",
                    help="march the default medium (render/media.py), 1 spp a step")
    ap.add_argument("--bounces", type=int, default=BOUNCES)
    ap.add_argument("--out", default=None, help="directory for kernels.txt and summary.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prof_frame: no CUDA device is available")

    dev = torch.device("cuda", 0)
    smi = ", ".join(card(dev))
    print(smi)
    spp = 1 if args.media else SPP[args.scene]
    scene = SCENES[args.scene].build(dev)
    if args.media:
        import dataclasses

        scene = (dataclasses.replace(scene[0], media_enabled=True),) + tuple(scene[1:])
    step = frame_step(args.scene, scene, dev, spp, args.bounces)
    kind = f"{spp}-spp{' media' if args.media else ''} {args.bounces}-bounce"
    if args.train:
        step = _train_step_fn(scene, bench_camera(args.scene, WIDTH, HEIGHT), dev)
        kind = f"{TRAIN_BOUNCES}-bounce training"
    torch.cuda.reset_peak_memory_stats(dev)
    step(0)  # warm-up: the kernel library and torch's own kernels load here
    walls, wall_ms = untraced_walls(step)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"untraced {kind} {args.scene} step walls s: {walls} (median {wall_ms:.3f} ms); "
          f"max_memory_allocated {peak / 2**30:.3f} GiB")

    native.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(1 + WALLS)
        traced_s = time.perf_counter() - t0
    launches = dict(native.launches)
    avgs = prof.key_averages()

    kernels, device_ms, n_kernels = device_time(avgs)
    if device_ms <= 0.0:
        raise RuntimeError("the trace holds no device time; time with CUDA events instead")
    groups = {}
    for e in kernels:
        calls, ms = groups.get(kernel_group(e.key), (0, 0.0))
        groups[kernel_group(e.key)] = (calls + e.count, ms + _device_ms(e))
    busy = device_ms / wall_ms
    print(f"traced step: wall {traced_s:.3f} s (profiler on), launches {launches}")
    print(f"device time of the traced step: {device_ms:.3f} ms in {n_kernels} kernels")
    print(f"busy share (traced device time / median untraced wall): {busy:.4f}; "
          f"idle {1.0 - busy:.4f}")
    for name, (calls, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        per_call = ms / calls * 1e3
        print(f"group {name}: calls={calls} device_ms={ms:.3f} share={ms / device_ms:.4f} "
              f"us/call={per_call:.2f}")

    host = sorted((e for e in avgs if e.key.startswith("aten::")),
                  key=lambda e: -e.self_cpu_time_total)
    n_aten = sum(e.count for e in host)
    print(f"host aten ops: {n_aten}")
    for e in host[:15]:
        print(f"host {e.key}: calls={e.count} self_cpu_ms={e.self_cpu_time_total / 1e3:.3f}")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        sort_key = ("self_device_time_total" if hasattr(kernels[0], "self_device_time_total")
                    else "self_cuda_time_total")
        with open(os.path.join(args.out, "kernels.txt"), "w") as f:
            f.write(avgs.table(sort_by=sort_key, row_limit=80))
        summary = dict(
            card=smi, scene=args.scene, train=args.train, media=args.media, width=WIDTH,
            height=HEIGHT, bounces=TRAIN_BOUNCES if args.train else args.bounces,
            spp=1 if args.train else spp,
            max_memory_allocated=peak,
            untraced_walls_s=walls, traced_wall_s=traced_s,
            device_ms=device_ms, kernels=n_kernels, busy_share=busy, launches=launches,
            groups={k: list(v) for k, v in groups.items()}, aten_ops=n_aten,
            host_top={e.key: [e.count, e.self_cpu_time_total / 1e3] for e in host[:15]})
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
