"""The progressive-frame entry point of the port (the Cornell 512^2 frame).

Counterpart of the reference's bench frame step: build the scene, then per
step and per sample `make_state(arange(n), step * spp + i)` ->
`generate_primary_rays` -> `trace_rays`, average the spp samples, and
`accumulate` the step into the progressive buffers.  Light adaptation and
exposure are not part of this frame (the reference bench leaves them out
too).

    python -m pim_tpu_torch.app --scene cornell --width 512 --height 512 \
        --bounces 10 --spp 16 --steps 4 --device cuda

`--device cpu` runs the same path with the kernels' plain versions; it is
meant for tests at small sizes.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from pim_tpu_torch import native
from pim_tpu_torch.core import rng
from pim_tpu_torch.geom.cornell import build_cornell_box
from pim_tpu_torch.render.camera import Camera, CameraArrays, DofInfo, camera_arrays, generate_primary_rays
from pim_tpu_torch.render.integrator import (
    TraceBuffers,
    TraceResult,
    accumulate,
    luminance_stddev,
    make_trace_buffers,
    trace_rays,
)
from pim_tpu_torch.render.scene import build_scene


def build_cornell_scene(device):
    """The Cornell 'boxes' scene built on `device` (light grid baked there)."""
    ents, pool = build_cornell_box("boxes")
    return build_scene(ents, pool, device)


def bench_camera(width: int, height: int) -> CameraArrays:
    """The reference bench's Cornell camera."""
    cam = Camera(position=np.array([-4, 0, 4], np.float32))
    cam.look_at([0, -1, 0])
    return camera_arrays(cam, DofInfo(autofocus=False), width, height)


def render_step(scene, cam: CameraArrays, width: int, height: int, bounces: int,
                spp: int, step: int) -> TraceResult:
    """One progressive step: the mean of `spp` one-sample traces with
    sample ids step*spp .. step*spp + spp-1.  rays_traced is the step's
    total (float64, on the device)."""
    meta, arrays, lights = scene
    dev = arrays.tri_table.device
    n = width * height
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.float64, device=dev)
    for i in range(spp):
        state = rng.make_state(pix, step * spp + i)
        state, ro, rd = generate_primary_rays(cam, width, height, state)
        res = trace_rays(meta, arrays, lights, ro, rd, state, bounces)
        acc = acc + res.color
        rays = rays + res.rays_traced.to(torch.float64)
    z = torch.zeros_like(acc)
    return TraceResult(color=acc * (1.0 / spp), albedo=z, normal=z, live=res.live,
                       rays_traced=rays)


@dataclass
class FrameResult:
    buffers: TraceBuffers
    mean: float
    stddev: float
    rays: float                # rays traced over all steps
    step_seconds: List[float]  # host wall time of each step, synchronised
    ms_per_step: float         # mean over steps after the first (warm-up)
    mrays_per_s: float         # rays / time over the same steps
    launches: Dict[str, int]   # kernel launches counted during the frame


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_frame(scene, width: int, height: int, bounces: int, spp: int,
                 steps: int) -> FrameResult:
    """Render `steps` progressive steps of `spp` samples through the bench
    camera; one host sync per step.  The first step counts as warm-up in
    the timing when steps > 1."""
    meta, arrays, lights = scene
    dev = arrays.tri_table.device
    cam = bench_camera(width, height)
    before = dict(native.launches)
    bufs = make_trace_buffers(width, height, dev)
    ray_counts = []
    step_seconds = []
    for step in range(steps):
        t0 = time.perf_counter()
        res = render_step(scene, cam, width, height, bounces, spp, step)
        bufs = accumulate(bufs, res, 1.0 / (step + 1))
        ray_counts.append(res.rays_traced)
        _sync(dev)
        step_seconds.append(time.perf_counter() - t0)
    rays = [float(r) for r in ray_counts]
    timed = slice(1, None) if steps > 1 else slice(0, None)
    t_timed = sum(step_seconds[timed])
    return FrameResult(
        buffers=bufs,
        mean=float(torch.mean(bufs.color)),
        stddev=float(luminance_stddev(bufs.color)),
        rays=sum(rays),
        step_seconds=step_seconds,
        ms_per_step=t_timed / len(step_seconds[timed]) * 1e3,
        mrays_per_s=sum(rays[timed]) / t_timed / 1e6,
        launches={k: native.launches[k] - before[k] for k in native.launches},
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="cornell", choices=["cornell"])
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--bounces", type=int, default=10)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    scene = build_cornell_scene(device)
    _sync(device)
    fr = render_frame(scene, args.width, args.height, args.bounces, args.spp, args.steps)
    print(f"image mean: {fr.mean:.6f}")
    print(f"luminance_stddev: {fr.stddev:.6f}")
    print(f"rays traced: {fr.rays:.0f}")
    print(f"ms/step: {fr.ms_per_step:.3f}")
    print(f"Mrays/s: {fr.mrays_per_s:.3f}")
    print("launches: " + " ".join(f"{k}={v}" for k, v in fr.launches.items()))


if __name__ == "__main__":
    main()
