"""The progressive-frame entry point of the port: the reference bench's
Cornell and e1m1 frames.

Counterpart of the reference's bench frame steps: build the scene, then per
step and per sample `make_state(arange(n), step * spp + i)` ->
`generate_primary_rays` -> `trace_rays`, average the spp samples, and
`accumulate` the step into the progressive buffers.  The e1m1 frame also
runs the histogram auto-exposure on each step's image, with the exposure
settings of the cvars and a fresh state, as its reference bench does.

    python -m pim_tpu_torch.app --scene cornell --width 512 --height 512 \
        --bounces 10 --spp 16 --steps 4 --device cuda
    python -m pim_tpu_torch.app --scene e1m1 --width 512 --height 512 \
        --bounces 10 --spp 1 --steps 16 --device cuda

`--device cpu` runs the same path with the kernels' plain versions; it is
meant for tests at small sizes.
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pim_tpu_torch import native
from pim_tpu_torch.core import rng
from pim_tpu_torch.geom.cornell import build_cornell_box
from pim_tpu_torch.geom.gltf import load_gltf_scene
from pim_tpu_torch.render.camera import Camera, CameraArrays, DofInfo, camera_arrays, generate_primary_rays
from pim_tpu_torch.render.exposure import ExposureParams, exposure_pass, make_exposure_state
from pim_tpu_torch.render.integrator import (
    TraceBuffers,
    TraceResult,
    accumulate,
    luminance_stddev,
    make_trace_buffers,
    trace_rays,
)
from pim_tpu_torch.render.scene import build_scene
from pim_tpu_torch.render.sky import bake_sky_cubemap, earth_atmosphere

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E1M1_GLTF = os.path.join(ROOT, "data", "e1m1", "glTF", "e1m1.gltf")
SUN_DIR = (0.35, 0.82, 0.45)
SUN_LUM = 3800.0
SKY_SIZE = 32
SKY_STEPS = 8
EXPOSURE_DT = 1.0 / 60.0


def build_cornell_scene(device):
    """The Cornell 'boxes' scene built on `device` (light grid baked there)."""
    ents, pool = build_cornell_box("boxes")
    return build_scene(ents, pool, device)


def build_e1m1_scene(device):
    """The e1m1 map (data/e1m1/glTF) with its sky, built on `device`: the
    sky is baked there and the light grid through the cluster kernels.
    The asset is committed; it is never regenerated here."""
    if not os.path.exists(E1M1_GLTF):
        raise FileNotFoundError(f"{E1M1_GLTF}: the e1m1 asset is missing from the checkout")
    ents, pool = load_gltf_scene(E1M1_GLTF)
    sky = bake_sky_cubemap(earth_atmosphere(), SUN_DIR, SUN_LUM, SKY_SIZE, SKY_STEPS,
                           device=device)
    return build_scene(ents, pool, device, sky=sky)


@dataclass(frozen=True)
class SceneSpec:
    """A scene of the reference bench: its builder (device -> (meta, arrays,
    lights)), its camera (position, look-at target), its default samples per
    step, and whether each step runs the auto-exposure pass."""
    build: Callable
    position: Tuple[float, float, float]
    target: Tuple[float, float, float]
    spp: int
    exposed: bool


SCENES = {
    "cornell": SceneSpec(build_cornell_scene, (-4.0, 0.0, 4.0), (0.0, -1.0, 0.0), 16, False),
    "e1m1": SceneSpec(build_e1m1_scene, (-2.5, 1.7, -2.5), (6.0, 1.0, 6.0), 1, True),
}


def bench_camera(scene_name: str, width: int, height: int) -> CameraArrays:
    """The reference bench's camera of a scene (depth of field off)."""
    spec = SCENES[scene_name]
    cam = Camera(position=np.array(spec.position, np.float32))
    cam.look_at(list(spec.target))
    return camera_arrays(cam, DofInfo(autofocus=False), width, height)


def render_step(scene, cam: CameraArrays, width: int, height: int, bounces: int,
                spp: int, step: int) -> TraceResult:
    """One progressive step of `spp` one-sample traces with sample ids
    step*spp .. step*spp + spp-1, as the reference's frame step folds them:
    the mean of their color, albedo and normal; the sum of their light
    histograms, wrapped to 32 bits as the reference's uint32 sum; and
    rays_traced, the step's total (float64, on the device)."""
    meta, arrays, lights = scene
    dev = arrays.tri_table.device
    n = width * height
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    color, albedo, normal = (torch.zeros((n, 3), dtype=torch.float32, device=dev)
                             for _ in range(3))
    live = torch.zeros(lights.live.shape, dtype=torch.int64, device=dev)
    rays = torch.zeros((), dtype=torch.float64, device=dev)
    for i in range(spp):
        state = rng.make_state(pix, step * spp + i)
        state, ro, rd = generate_primary_rays(cam, width, height, state)
        res = trace_rays(meta, arrays, lights, ro, rd, state, bounces)
        color = color + res.color
        albedo = albedo + res.albedo
        normal = normal + res.normal
        live = live + res.live
        rays = rays + res.rays_traced.to(torch.float64)
    inv = 1.0 / spp
    return TraceResult(color=color * inv, albedo=albedo * inv, normal=normal * inv,
                       live=live & 0xFFFFFFFF, rays_traced=rays)


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
    exposure: Optional[float]  # the last step's auto-exposure (e1m1), else None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_frame(scene, scene_name: str, width: int, height: int, bounces: int, spp: int,
                 steps: int) -> FrameResult:
    """Render `steps` progressive steps of `spp` samples of `scene`, built as
    SCENES[scene_name], through that scene's bench camera; one host sync per
    step.  The first step counts as warm-up in the timing when steps > 1."""
    meta, arrays, lights = scene
    dev = arrays.tri_table.device
    cam = bench_camera(scene_name, width, height)
    exp_params = ExposureParams.from_cvars() if SCENES[scene_name].exposed else None
    before = dict(native.launches)
    bufs = make_trace_buffers(width, height, dev)
    ray_counts = []
    step_seconds = []
    exp = None
    for step in range(steps):
        t0 = time.perf_counter()
        res = render_step(scene, cam, width, height, bounces, spp, step)
        if exp_params is not None:
            exp = exposure_pass(res.color, exp_params, make_exposure_state(dev), EXPOSURE_DT)
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
        exposure=None if exp is None else float(exp.exposure),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="cornell", choices=sorted(SCENES))
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--bounces", type=int, default=10)
    ap.add_argument("--spp", type=int, default=None,
                    help="samples per step (default: 16 for cornell, 1 for e1m1)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    spec = SCENES[args.scene]
    spp = spec.spp if args.spp is None else args.spp
    scene = spec.build(device)
    _sync(device)
    fr = render_frame(scene, args.scene, args.width, args.height, args.bounces, spp,
                      args.steps)
    print(f"image mean: {fr.mean:.6f}")
    print(f"luminance_stddev: {fr.stddev:.6f}")
    print(f"rays traced: {fr.rays:.0f}")
    print(f"ms/step: {fr.ms_per_step:.3f}")
    print(f"Mrays/s: {fr.mrays_per_s:.3f}")
    if fr.exposure is not None:
        print(f"exposure: {fr.exposure:.6g}")
    print("launches: " + " ".join(f"{k}={v}" for k, v in fr.launches.items()))


if __name__ == "__main__":
    main()
