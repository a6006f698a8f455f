"""The port's entry points: the engine shell, and the bench frames.

The engine shell (`Engine`, as `pim_tpu.app`): init -> frame loop ->
shutdown, each frame the time system, the deferred command queue and one
progressive frame of the render system.  A batch run enqueues `--exec`'s
commands, loops until `quit` or until the queue drains, and exits non-zero
when a deferred command failed (a failed `pt_gate`, for one):

    python -m pim_tpu_torch.app --width 512 --height 512 \
        --exec "pt_test -frames 64"
    python -m pim_tpu_torch.app --width 128 --height 128 \
        --exec "exec scripts/pt_test_e1m1.cmd"

Without `--exec` (or `--frames`) it renders the reference bench's Cornell
and e1m1 frames.

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

`--device cpu` runs either mode with the kernels' plain versions; it is
meant for tests at small sizes.  `--device cuda` (the default) with no GPU
is an error.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pim_tpu_torch import native
from pim_tpu_torch.core import cvars  # registers the engine cvars
from pim_tpu_torch.core import profiler
from pim_tpu_torch.core.cmd import get_cmd_system
from pim_tpu_torch.core.console import LogSev, con_logf, get_console
from pim_tpu_torch.core.profiler import profile
from pim_tpu_torch.core.timesys import get_timesys
from pim_tpu_torch.geom.cornell import build_cornell_box
from pim_tpu_torch.geom.gltf import load_gltf_scene
from pim_tpu_torch.render.camera import Camera, CameraArrays, DofInfo, camera_arrays
from pim_tpu_torch.render.exposure import ExposureParams, exposure_pass, make_exposure_state
from pim_tpu_torch.render.integrator import (
    TraceBuffers,
    TraceResult,
    accumulate,
    luminance_stddev,
    make_trace_buffers,
)
from pim_tpu_torch.render.render_system import RenderSystem, trace_samples
from pim_tpu_torch.render.scene import build_scene
from pim_tpu_torch.render.sky import bake_sky_cubemap, earth_atmosphere

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E1M1_GLTF = os.path.join(ROOT, "data", "e1m1", "glTF", "e1m1.gltf")
GATE_BANDS = os.path.join(ROOT, "pim_tpu_torch", "render", "gate_bands.json")
SUN_DIR = (0.35, 0.82, 0.45)
SUN_LUM = 3800.0
SKY_SIZE = 32
SKY_STEPS = 8
EXPOSURE_DT = 1.0 / 60.0


def build_cornell_scene(device, backend: str = "auto"):
    """The Cornell 'boxes' scene built on `device` (light grid baked there)
    with `backend` (scene.build_scene's)."""
    ents, pool = build_cornell_box("boxes")
    return build_scene(ents, pool, device, backend=backend)


def build_e1m1_scene(device, backend: str = "auto"):
    """The e1m1 map (data/e1m1/glTF) with its sky, built on `device`: the
    sky is baked there and the light grid through the scene's intersector
    (`auto`: the cluster kernels).  The asset is committed; it is never
    regenerated here."""
    if not os.path.exists(E1M1_GLTF):
        raise FileNotFoundError(f"{E1M1_GLTF}: the e1m1 asset is missing from the checkout")
    ents, pool = load_gltf_scene(E1M1_GLTF)
    sky = bake_sky_cubemap(earth_atmosphere(), SUN_DIR, SUN_LUM, SKY_SIZE, SKY_STEPS,
                           device=device)
    return build_scene(ents, pool, device, sky=sky, backend=backend)


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


def gate_band(tag: str):
    """(lo, hi) of band `tag` of render/gate_bands.json, the band that the
    mean of a frame of SCENES through its bench camera must lie in (the
    band's mean -/+ its half width); None when the file has no such band."""
    with open(GATE_BANDS) as f:
        band = json.load(f).get(tag)
    return None if band is None else (band["mean"] - band["half"], band["mean"] + band["half"])


def render_step(scene, cam: CameraArrays, width: int, height: int, bounces: int,
                spp: int, step: int) -> TraceResult:
    """One progressive step of `spp` one-sample traces with sample ids
    step*spp .. step*spp + spp-1, folded as the reference's frame step
    folds them (`render_system.trace_samples`)."""
    return trace_samples(scene, cam, width, height, bounces, spp, step * spp)


@dataclass
class FrameResult:
    buffers: TraceBuffers
    mean: float
    stddev: float
    rays: float                # rays traced over all steps
    warmup_seconds: float      # host wall time of the warm-up step, synchronised
    seconds: float             # host wall time of the timed steps, queued, one sync
    ms_per_step: float         # mean over the timed steps (all but the first)
    mrays_per_s: float         # rays / time over the same steps
    launches: Dict[str, int]   # kernel launches counted during the frame
    exposure: Optional[float]  # the last step's auto-exposure (e1m1), else None


def sync(device) -> None:
    """Wait for a CUDA device's queued work (nothing for the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card(device):
    """(name, power limit) of a CUDA device's card as nvidia-smi reports
    them; ("cpu", None) for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu", None
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    name, _, limit = out.rpartition(",")
    return name.strip(), limit.strip()


def timed_steps(step, device, iters: int, warmup: int, watch=None):
    """The port's one timed loop of frame steps (the bench frames' and
    chip_smoke.py's): step(0 .. warmup-1), a sync, then step(warmup ..
    warmup + iters-1) queued with no sync between them, and one sync at the
    end: a sync a step would put host round trips into what is timed.  step(i)
    returns device tensors and waits on nothing.  `watch`, a context
    manager, wraps the queued steps only.  Returns (the timed steps'
    outputs, their seconds, the kernel launches during them)."""
    for i in range(warmup):
        step(i)
    sync(device)
    with (contextlib.nullcontext() if watch is None else watch):
        before = dict(native.launches)
        t0 = time.perf_counter()
        outs = [step(warmup + i) for i in range(iters)]
    sync(device)
    seconds = time.perf_counter() - t0
    return outs, seconds, {k: native.launches[k] - before[k] for k in native.launches}


def render_frame(scene, scene_name: str, width: int, height: int, bounces: int, spp: int,
                 steps: int) -> FrameResult:
    """Render `steps` progressive steps of `spp` samples of `scene`, built as
    SCENES[scene_name], through that scene's bench camera.  The first step
    is the warm-up when steps > 1; the others are timed by `timed_steps`."""
    meta, arrays, lights = scene
    dev = arrays.tri_table.device
    cam = bench_camera(scene_name, width, height)
    exp_params = ExposureParams.from_cvars() if SCENES[scene_name].exposed else None
    before = dict(native.launches)
    bufs = make_trace_buffers(width, height, dev)
    ray_counts = []
    exp = None

    def step(i: int):
        nonlocal bufs, exp
        res = render_step(scene, cam, width, height, bounces, spp, i)
        if exp_params is not None:
            exp = exposure_pass(res.color, exp_params, make_exposure_state(dev), EXPOSURE_DT)
        bufs = accumulate(bufs, res, 1.0 / (i + 1))
        ray_counts.append(res.rays_traced)
        return res.rays_traced

    warmup = 1 if steps > 1 else 0
    t0 = time.perf_counter()
    timed_rays, seconds, _ = timed_steps(step, dev, steps - warmup, warmup)
    warmup_seconds = time.perf_counter() - t0 - seconds
    return FrameResult(
        buffers=bufs,
        mean=float(torch.mean(bufs.color)),
        stddev=float(luminance_stddev(bufs.color)),
        rays=sum(float(r) for r in ray_counts),
        warmup_seconds=warmup_seconds,
        seconds=seconds,
        ms_per_step=seconds / len(timed_rays) * 1e3,
        mrays_per_s=sum(float(r) for r in timed_rays) / seconds / 1e6,
        launches={k: native.launches[k] - before[k] for k in native.launches},
        exposure=None if exp is None else float(exp.exposure),
    )


@dataclass
class Engine:
    """The headless engine shell.  `sync_frames` synchronises the device at
    the end of each frame and records the frame's wall time in `frame_ms`
    (for measurement; the shell itself syncs only where the reference
    does)."""
    width: Optional[int] = None
    height: Optional[int] = None
    max_frames: Optional[int] = None
    device: str = "cuda"
    sync_frames: bool = False

    render: RenderSystem = None
    frame: int = 0
    frame_ms: List[float] = field(default_factory=list)

    def init(self) -> None:
        from pim_tpu_torch.core.cvars import cv_con_logpath, cv_r_height, cv_r_scale, cv_r_width

        get_cmd_system().reset()
        if cv_con_logpath.get():
            get_console().set_log_path(cv_con_logpath.get())
        # explicit --width/--height pin the base-resolution cvars; r_scale
        # applies on top
        if self.width is not None:
            cv_r_width.set(self.width)
        if self.height is not None:
            cv_r_height.set(self.height)
        w = max(1, int(round(cv_r_width.get() * cv_r_scale.get())))
        h = max(1, int(round(cv_r_height.get() * cv_r_scale.get())))
        if self.width is None and self.height is None and w * h > (1 << 20):
            con_logf(LogSev.Warning, "app",
                     "no --width/--height given; cvars resolve to %dx%d (r_width*r_scale) -- "
                     "pass --width/--height or set r_scale for faster batch runs", w, h)
        self.render = RenderSystem(width=w, height=h, device=self.device)
        self.render.init()
        con_logf(LogSev.Info, "app", "pim_tpu_torch engine initialized (%dx%d, %s)", w, h,
                 self.render.device)

    def update(self) -> None:
        t0 = time.perf_counter()
        get_timesys().update()
        with profile("cmd"):
            get_cmd_system().update()
        profiler.set_tracing(cvars.cv_prof_trace.get())
        with profile("render"):
            self.render.update()
        if self.sync_frames:
            sync(self.render.device)
            self.frame_ms.append((time.perf_counter() - t0) * 1e3)
        self.frame += 1

    def run(self, script: Optional[str] = None) -> int:
        """Batch mode: enqueue a script, loop until quit or until the queue
        drains.  Returns the exit code: 1 when a deferred command failed."""
        cmds = get_cmd_system()
        if script:
            cmds.enqueue(script)
        while not cmds.quit_requested:
            self.update()
            if self.max_frames is not None and self.frame >= self.max_frames:
                break
            if not cmds.pending() and script is not None:
                break
        return 1 if cmds.error_count else 0

    def shutdown(self) -> None:
        """The profiler's report: logged where the console prints it when
        the shell traced (`prof_trace 1`: marks, pt.* spans and counters),
        else to the console's ring only."""
        prof = profiler.get_profiler()
        if prof.stats or profiler.counters():
            sev = LogSev.Info if cvars.cv_prof_trace.get() else LogSev.Verbose
            con_logf(sev, "prof", "\n%s", prof.report())


def check_device(device: torch.device) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")


def shell_main(args) -> int:
    check_device(torch.device(args.device))
    engine = Engine(width=args.width, height=args.height, max_frames=args.frames,
                    device=args.device)
    engine.init()
    rc = engine.run(args.script)
    engine.shutdown()
    return rc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--exec", dest="script", default=None,
                    help="engine shell: the command script to run (e.g. 'pt_test -frames 64')")
    ap.add_argument("--frames", type=int, default=None,
                    help="engine shell: stop after this many frames")
    ap.add_argument("--scene", default="cornell", choices=sorted(SCENES))
    ap.add_argument("--width", type=int, default=None,
                    help="default: 512 for a bench frame, the cvar r_width in the shell")
    ap.add_argument("--height", type=int, default=None,
                    help="default: 512 for a bench frame, the cvar r_height in the shell")
    ap.add_argument("--bounces", type=int, default=10)
    ap.add_argument("--spp", type=int, default=None,
                    help="samples per step (default: 16 for cornell, 1 for e1m1)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.script is not None or args.frames is not None:
        raise SystemExit(shell_main(args))

    device = torch.device(args.device)
    check_device(device)
    args.width = 512 if args.width is None else args.width
    args.height = 512 if args.height is None else args.height
    spec = SCENES[args.scene]
    spp = spec.spp if args.spp is None else args.spp
    scene = spec.build(device)
    sync(device)
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
