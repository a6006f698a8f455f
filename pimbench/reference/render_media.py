"""The reference of the render_media traffic (see `pimbench.drivers.render_media`).

`reference/render.py`'s check with the configuration's medium: the frozen
copy builds the scene again from the same raw inputs with media on, bakes
its whole light grid itself (`grid_gap` compares every table of it with
the program's), and traces the sampled pixels of two of the window's
steps through the frozen plain marches (`frozen/render/media.py`,
`frozen/math/noise.py`) with the frozen `make_media_desc` of the
configuration's `media`.  `pixels_off` and `accum_gap` are render.py's.

Control (`control=True`): render.py's, the reference one precision lower
(its geometry in bfloat16, its light grid baked on that geometry, every
value it reports rounded to bfloat16), through the same medium.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from pimbench import scenes
from pimbench.reference import render as R
from pimbench.reference.compare import max_rel_gap, share_off, to_bf16


def medium(cfg):
    """The frozen copy's MediaDesc of the configuration's `media`."""
    from pimbench.reference.frozen.render import media
    return media.make_media_desc(**cfg["media"])


def build(cfg, dev):
    """The frozen scene with media on, its light grid baked whole."""
    t0 = time.perf_counter()
    scene = scenes.build(cfg, dev, "reference", media_enabled=True)
    print(f"# reference scene and light grid {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return scene


def trace_pixels(scene, cam, cfg, desc, spp: int, first_sample: int, seed32: int,
                 pix: torch.Tensor) -> torch.Tensor:
    """[P, 9] color, albedo and normal of the pixels `pix` of a step through
    the medium `desc`, as `render_system.trace_samples` computes them."""
    from pimbench.reference.frozen.core import rng
    from pimbench.reference.frozen.math.vec3 import f32
    from pimbench.reference.frozen.render import camera, integrator
    meta, arrays, lights = scene
    w, h = int(cfg["width"]), int(cfg["height"])
    p = pix.shape[0]
    dev = pix.device
    color, albedo, normal = (torch.zeros((p, 3), dtype=torch.float32, device=dev)
                             for _ in range(3))
    for i in range(spp):
        state = rng.make_state(pix, (first_sample + i) & rng.MASK32, seed=seed32)
        state, ro, rd = camera.generate_primary_rays(cam, w, h, state, 5,
                                                     float(np.pi / 10.0), pixel_ids=pix)
        res = integrator.trace_rays(meta, arrays, lights, ro, rd, state, int(cfg["bounces"]),
                                    media_desc=desc)
        color = color + res.color
        albedo = albedo + res.albedo
        normal = normal + res.normal
    inv = f32(1.0 / spp)
    return torch.cat([color * inv, albedo * inv, normal * inv], dim=1)


def check(cfg, tr, seed32: int, pix, prog: dict, dev, control: bool = False):
    """[(name, value, limit)] of the render check through the medium."""
    limits = tr["limits"]
    desc = medium(cfg)
    scene = build(cfg, dev)
    ref_grid = R.grid_state(*scene[1:])
    cam = scenes.camera(cfg, "reference")
    spp = int(tr["spp"])
    steps = prog["steps"]
    ref = {i: trace_pixels(scene, cam, cfg, desc, spp, i * spp, seed32, pix) for i in steps}
    kept = prog["kept"]
    accum = prog["accum"]
    grid = R.grid_gap(prog["grid"], ref_grid)
    if control:
        low = R.control_scene(scene)
        grid = R.grid_gap(R.grid_state(*low[1:]), ref_grid)
        values = {i: to_bf16(trace_pixels(low, cam, cfg, desc, spp, i * spp, seed32, pix))
                  for i in steps}
        kept = to_bf16(kept)
        accum = to_bf16(R.accumulate(kept.to(torch.bfloat16).to(torch.float32)))
    else:
        values = prog["values"]
    return [("pixels_off", share_off([(values[i], ref[i]) for i in steps]),
             limits["pixels_off"]),
            ("accum_gap", max_rel_gap(accum, R.accumulate(prog["kept"])), limits["accum_gap"]),
            ("grid_gap", grid, limits["grid_gap"])]
