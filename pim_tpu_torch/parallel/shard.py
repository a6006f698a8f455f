"""Sharded render and train steps over a process world.

Counterpart of `pim_tpu.parallel.shard`, whose `shard_map` over the mesh's
'dp' axis becomes one rank per process:

  rays/pixels   -> each rank traces its contiguous slice of pixel ids
  scene arrays  -> replicated on every rank's device (`dist.replicate`)
  light 'live'  -> per-rank partials, summed with `all_reduce`
  param grads   -> averaged with `all_reduce` (the reference's pmean)

A pixel's RNG is keyed by its global id, so a pixel traces the same path
whatever rank traces it.  With no process group initialised, both steps
are a world of one, as the reference's one-device mesh.

Two train steps run on a mesh, and share `grad_reduce.GradReducer`, the
gradient average overlapped with the backward:
  `diff.make_train_step(..., mesh=mesh)`  the deployment's step: Adam over
      `DiffParams` on each rank, after the ranks' gradients are averaged
      (the one-card training step, sharded);
  `make_sharded_train_step`  the JAX package's counterpart, plain SGD
      p - lr * g, held against `pim_tpu.parallel.shard` by the tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from pim_tpu_torch.core import profiler as prof
from pim_tpu_torch.core import rng
from pim_tpu_torch.parallel.dist import Mesh, global_mesh, local_pixels
from pim_tpu_torch.parallel.grad_reduce import GradReducer
from pim_tpu_torch.render.camera import CameraArrays, generate_primary_rays
from pim_tpu_torch.render.integrator import trace_rays
from pim_tpu_torch.render.scene import SceneMeta


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of the current world; `n_devices`, when given, must be its
    size (one device a rank)."""
    mesh = global_mesh(device)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"a mesh of {n_devices} devices needs a world of {n_devices} ranks, "
                         f"this one has {mesh.size}")
    return mesh


def _sum_live(live: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' histogram deltas summed, wrapped to 32 bits as the
    reference's uint32 psum."""
    if mesh.group is not None:
        live = live.clone()
        dist.all_reduce(live, group=mesh.group)
    return live & rng.MASK32


def _raygen_for_pixels(cam: CameraArrays, width: int, height: int, pixel_ids, state):
    """Primary rays for an arbitrary pixel-id subset (sharded raygen)."""
    return generate_primary_rays(cam, width, height, state, pixel_ids=pixel_ids)


def make_sharded_render_step(meta: SceneMeta, mesh: Mesh, width: int, height: int,
                             max_bounces: int = 4):
    """Returns step(arrays, lights, cam, sample_idx) -> (color, albedo,
    normal, live): this rank's rows ([N / ranks, 3] each) and the light
    histogram delta summed over ranks."""
    _, pixel_ids = local_pixels(mesh, width * height)

    def step(arrays, lights, cam, sample_idx):
        state = rng.make_state(pixel_ids, int(sample_idx) & rng.MASK32)
        state, ro, rd = _raygen_for_pixels(cam, width, height, pixel_ids, state)
        res = trace_rays(meta, arrays, lights, ro, rd, state, max_bounces)
        return res.color, res.albedo, res.normal, _sum_live(res.live, mesh)

    return step


def make_sharded_train_step(meta: SceneMeta, mesh: Mesh, width: int, height: int,
                            max_bounces: int = 3, lr: float = 0.05,
                            serialize_reduce: bool = False, sky_steps: int = 16):
    """The full differentiable training step, sharded over the ranks.

    Loss = L2 between the rendered image and a target; parameters = the
    whole `diff.DiffParams` surface.  Per rank: raygen -> trace -> local
    loss -> backward; loss and gradients are averaged over the ranks and
    `live` summed, then one plain SGD step p - lr * g (the JAX package's
    counterpart; `diff.make_train_step(..., mesh=mesh)` is the Adam step).

    Returns step(params, arrays, lights, cam, target, sample_idx)
        -> (loss, new_params, new_lights), with `target` the whole
    [width * height, 3] image.

    serialize_reduce=False starts each group's all_reduce from a
    post-accumulate-grad hook while the backward runs on (the overlap the
    reference leaves to XLA's scheduler); True reduces after the whole
    backward, the A/B control.  sky_steps: the view steps of the sky's
    re-bake inside the render (`diff.make_loss_fn`'s).  While tracing,
    the reduce runs in span `pt.train.reduce`."""
    from pim_tpu_torch.render.diff import DiffParams, make_loss_fn

    rows, pixel_ids = local_pixels(mesh, width * height)
    loss_fn = make_loss_fn(meta, width, height, max_bounces, sky_steps)

    def step(params, arrays, lights, cam, target, sample_idx):
        leaves = [p.detach().clone().requires_grad_(True) for p in params]
        reducer = GradReducer(mesh, leaves) if mesh.group is not None else None
        hooks = reducer.hooks() if reducer is not None and not serialize_reduce else []
        try:
            loss, live = loss_fn(DiffParams(*leaves), arrays, lights, cam, target[rows],
                                 sample_idx, pixel_ids)
            loss.backward()
        finally:
            for h in hooks:
                h.remove()
        loss = loss.detach()
        if reducer is None:
            for p in leaves:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        else:
            with prof.span("pt.train.reduce"):
                loss = reducer.finish(loss)
        with torch.no_grad():
            new_params = DiffParams(*(p - lr * p.grad for p in leaves))
        live = _sum_live(live.detach(), mesh)
        return loss, new_params, dataclasses.replace(lights,
                                                     live=(lights.live + live) & rng.MASK32)

    return step
