"""The reference of the render traffic (see `pimbench.drivers.render`).

It builds the configuration's scene again through the frozen copy, from
the same raw inputs (the Cornell generator's entities or the glTF file,
the sky's parameters), and bakes its whole light grid itself (8.3 million
shadow rays on e1m1, through the frozen pair walk); `grid_gap` compares
every table of that grid with the program's, and the reference renders
with its own.  Every pixel's path depends only on its own RNG stream, so
the sampled pixels are traced alone.

Control (`control=True`): the reference itself put in the program's
place, one precision lower: its geometry rounded to bfloat16 (vertex
positions, the BW rows of both intersectors, the triangle table's corner
rows), its light grid baked on that geometry, and every value it reports
rounded to bfloat16.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from pimbench import scenes
from pimbench.reference.compare import max_rel_gap, share_off, to_bf16


def _fz():
    from pimbench.reference.frozen.core import rng
    from pimbench.reference.frozen.render import camera, exposure, integrator
    from pimbench.reference.frozen.render import fetch as F
    from pimbench.reference.frozen.render import scene as S
    return rng, camera, exposure, integrator, F, S


def lower_precision(arrays):
    """The control's scene arrays: their geometry rounded to bfloat16."""
    _, _, _, _, F, _ = _fz()
    tt = arrays.tri_table.clone()
    for rows in (F.PA, F.PB, F.PC):
        tt[rows] = to_bf16(tt[rows])
    cl = arrays.cl_tris.clone()
    cl[:12] = to_bf16(cl[:12])
    return dataclasses.replace(arrays, positions=to_bf16(arrays.positions),
                               tris12=to_bf16(arrays.tris12), tri_table=tt, cl_tris=cl)


def build(cfg, dev, ents=None):
    """The frozen scene, from the same raw inputs as the program's, its
    light grid baked whole by the frozen copy."""
    t0 = time.perf_counter()
    scene = scenes.build(cfg, dev, "reference", ents=ents)
    print(f"# reference scene and light grid {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return scene


def control_scene(scene):
    """The control's scene: the reference's geometry in bfloat16, its light
    grid baked again on that geometry."""
    _, _, _, _, _, S = _fz()
    meta, arrays, _ = scene
    low = lower_precision(arrays)
    cell_active, lights = S.bake_light_grid(meta, low)
    low = dataclasses.replace(low, cell_active=cell_active,
                              cell_active_f=cell_active.to(torch.float32).reshape(1, -1))
    return meta, low, lights


GRID_KEYS = ("cell_active", "pdf", "cdf", "integral", "sum", "live")


def grid_state(arrays, lights) -> dict:
    """The light grid's tables of a scene (either side's)."""
    return {"cell_active": arrays.cell_active, "pdf": lights.pdf, "cdf": lights.cdf,
            "integral": lights.integral, "sum": lights.sum, "live": lights.live}


def grid_gap(got: dict, ref: dict) -> float:
    """The largest relative gap of the whole light grid's tables (pdf, cdf,
    integral, sum, live): 1 where a table's shape or a cell's activity
    differs."""
    if any(tuple(got[k].shape) != tuple(ref[k].shape) for k in GRID_KEYS):
        return 1.0
    mismatch = float((got["cell_active"] != ref["cell_active"]).any())
    return max([mismatch] + [max_rel_gap(got[k], ref[k]) for k in GRID_KEYS[1:]])


def trace_pixels(scene, cam, cfg, spp: int, first_sample: int, seed32: int,
                 pix: torch.Tensor) -> torch.Tensor:
    """[P, 9] color, albedo and normal of the pixels `pix` of a step, as
    `render_system.trace_samples` computes them for the whole frame."""
    rng, camera, _, integrator, _, _ = _fz()
    from pimbench.reference.frozen.math.vec3 import f32
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
        res = integrator.trace_rays(meta, arrays, lights, ro, rd, state, int(cfg["bounces"]))
        color = color + res.color
        albedo = albedo + res.albedo
        normal = normal + res.normal
    inv = f32(1.0 / spp)
    return torch.cat([color * inv, albedo * inv, normal * inv], dim=1)


def accumulate(kept: torch.Tensor) -> torch.Tensor:
    """The progressive buffers' values after the steps kept [S, P, C]:
    `integrator.accumulate`'s lerp with weight 1/(step+1)."""
    acc = torch.zeros_like(kept[0])
    for i in range(kept.shape[0]):
        acc = acc + (kept[i] - acc) * float(1.0 / (i + 1))
    return acc


def check(cfg, tr, seed32: int, pix, prog: dict, dev, control: bool = False):
    """[(name, value, limit)] of the render check (module docstring)."""
    _, _, exposure, _, _, _ = _fz()
    limits = tr["limits"]
    scene = build(cfg, dev)
    ref_grid = grid_state(*scene[1:])
    cam = scenes.camera(cfg, "reference")
    spp = int(tr["spp"])
    steps = prog["steps"]
    ref = {i: trace_pixels(scene, cam, cfg, spp, i * spp, seed32, pix) for i in steps}
    kept = prog["kept"]
    accum = prog["accum"]
    images = prog["images"]
    exps = prog["exposure"]
    grid = grid_gap(prog["grid"], ref_grid)
    if control:
        low = control_scene(scene)
        grid = grid_gap(grid_state(*low[1:]), ref_grid)
        values = {i: to_bf16(trace_pixels(low, cam, cfg, spp, i * spp, seed32, pix))
                  for i in steps}
        kept = to_bf16(kept)
        accum = to_bf16(accumulate(kept.to(torch.bfloat16).to(torch.float32)))
        images = {i: to_bf16(images[i]) for i in steps}
        exps = {i: None for i in steps}
    else:
        values = prog["values"]
    out = [("pixels_off", share_off([(values[i], ref[i]) for i in steps]),
            limits["pixels_off"]),
           ("accum_gap", max_rel_gap(accum, accumulate(prog["kept"])), limits["accum_gap"]),
           ("grid_gap", grid, limits["grid_gap"])]
    exp_cfg = cfg.get("exposure") if tr.get("exposure", False) else None
    if exp_cfg:
        params = exposure.ExposureParams(**exp_cfg["params"])
        gaps = []
        for i in steps:
            e = exposure.exposure_pass(prog["images"][i], params,
                                       exposure.make_exposure_state(dev), float(exp_cfg["dt"]))
            r = torch.stack([e.avg_lum, e.exposure])
            if control:
                el = exposure.exposure_pass(images[i], params,
                                            exposure.make_exposure_state(dev),
                                            float(exp_cfg["dt"]))
                p = to_bf16(torch.stack([el.avg_lum, el.exposure]))
            else:
                p = exps[i]
            gaps.append(max_rel_gap(p, r))
        out.append(("exposure_gap", max(gaps), limits["exposure_gap"]))
    return out
