"""Differentiable rendering: the learnable parameters, the render and loss
functions, and the training step.

Counterpart of `pim_tpu.render.diff`.  The rendered image is
differentiable in:
  - the per-material flat albedo and ROME (emission = albedo * e^2 * scale);
  - the texture atlas texels;
  - the sun's direction and luminance (the sky cube is re-baked inside the
    render, so gradients flow through the Rayleigh/Mie march);
  - the camera position.

`apply_params` grafts the parameters into the scene on the device: the
tri-table ALBEDO/ROME rows and the emissive table's albedo and emission
through K3, whose backward (a column scatter-add, K3-bwd) carries their
gradients back to the [M, 4] tables.  The render runs the integrator with
`SceneMeta.differentiable` set: the atlas and the sky are read from their
parameter planes through K7 (forward and backward), Russian roulette is off
and every discrete choice rides the counter RNG, so for a fixed seed the
estimator is piecewise smooth and its autograd derivative is the
derivative of the same estimator.

On the TPU the JAX package reads the stale atlas corner planes in the
forward, so its atlas gradient is lost there (ROADMAP F6); its CPU
semantics, which its tests check, are the ones the port follows.

Training is this library API, as in the JAX package: `make_train_step`
returns (init, step), with `torch.optim.Adam` at optax's defaults, on one
device or data-parallel over a mesh of ranks (its `mesh` argument).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from pim_tpu_torch.core import profiler as prof
from pim_tpu_torch.core import rng
from pim_tpu_torch.parallel.dist import local_pixels
from pim_tpu_torch.parallel.grad_reduce import GradReducer
from pim_tpu_torch.render import fetch as F
from pim_tpu_torch.render import lights as L
from pim_tpu_torch.render.camera import CameraArrays, generate_primary_rays
from pim_tpu_torch.render.integrator import trace_rays
from pim_tpu_torch.render.scene import SceneArrays, SceneMeta
from pim_tpu_torch.render.sky import bake_sky_cubemap, earth_atmosphere, sky_corner_planes

# optax.adam's defaults
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


class DiffParams(NamedTuple):
    """The learnable parameters (each a float32 tensor)."""

    mat_albedo: torch.Tensor    # [M, 4] flat per-material albedo (rgba)
    mat_rome: torch.Tensor      # [M, 4] roughness/occlusion/metallic/emission
    atlas_planes: torch.Tensor  # [4, H*W] texture atlas texels
    sun_dir: torch.Tensor       # [3] (normalized inside apply)
    sun_lum: torch.Tensor       # [3]
    cam_eye: torch.Tensor       # [3]


def extract_params(meta: SceneMeta, arrays: SceneArrays, cam: CameraArrays,
                   sun_dir=(0.0, 1.0, 0.0), sun_lum=(1.0, 1.0, 1.0)) -> DiffParams:
    """The current parameter values of a built scene, as new tensors on the
    scene's device.  A material's values are those of its first triangle."""
    dev = arrays.tri_table.device
    tt = arrays.tri_table.detach().cpu().numpy()
    mat_ids = tt[F.MAT_ID].astype(np.int64)
    m = meta.mat_count
    alb = np.zeros((m, 4), np.float32)
    rom = np.zeros((m, 4), np.float32)
    present, first = np.unique(mat_ids, return_index=True)
    alb[present] = tt[F.ALBEDO, first].T
    rom[present] = tt[F.ROME, first].T

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return DiffParams(mat_albedo=t(alb), mat_rome=t(rom),
                      atlas_planes=arrays.atlas_planes.detach().clone(),
                      sun_dir=t(sun_dir), sun_lum=t(sun_lum),
                      cam_eye=torch.as_tensor(cam.eye, dtype=torch.float32,
                                              device=dev).detach().clone())


def from_jax_params(params, device) -> DiffParams:
    """A JAX package `DiffParams` (its leaves as arrays) -> the port's."""
    return DiffParams(*(torch.tensor(np.asarray(x, np.float32), device=device) for x in params))


def _set_rows(table: torch.Tensor, rows: slice, values: torch.Tensor) -> torch.Tensor:
    """`table` with rows [rows] replaced by `values` (a new tensor; the
    graft stays differentiable)."""
    return torch.cat([table[: rows.start], values, table[rows.stop :]], dim=0)


def apply_params(meta: SceneMeta, arrays: SceneArrays, cam: CameraArrays, params: DiffParams,
                 sky_steps: int = 16):
    """Graft `params` into (arrays, cam) on the device; differentiable.

    Flat materials get their tri-table ALBEDO/ROME rows from the [M, 4]
    tables through K3; textured triangles keep their zero rows and read the
    atlas planes.  The emissive table's albedo and emission alpha are
    grafted the same way (the NEE side of the estimator reads them there).
    A scene with a sky has its cube re-baked from (sun_dir, sun_lum)."""
    tt = arrays.tri_table
    mat_ids = tt[F.MAT_ID].to(torch.int64)
    alb_rows = F.fetch_cols(params.mat_albedo.T.contiguous(), mat_ids)  # [4, T]
    rom_rows = F.fetch_cols(params.mat_rome.T.contiguous(), mat_ids)
    alb_flat = (tt[F.ALBEDO_TEX] < 0.0)[None, :]
    rom_flat = (tt[F.ROME_TEX] < 0.0)[None, :]
    tt = _set_rows(tt, F.ALBEDO, torch.where(alb_flat, alb_rows, tt[F.ALBEDO]))
    tt = _set_rows(tt, F.ROME, torch.where(rom_flat, rom_rows, tt[F.ROME]))
    arrays = dataclasses.replace(arrays, tri_table=tt, atlas_planes=params.atlas_planes)

    if meta.emissive_count > 0:
        et = arrays.emissive_table
        mat_e = mat_ids[et[L.E_TRI].to(torch.int64)]                  # [E]
        alb_e = F.fetch_cols(params.mat_albedo.T.contiguous(), mat_e)  # [4, E]
        rome_e = F.fetch_cols(params.mat_rome.T.contiguous(), mat_e)
        a_flat_e = (et[L.E_ALBEDO_TEX] < 0.0)[None, :]
        r_flat_e = et[L.E_ROME_TEX] < 0.0
        et = _set_rows(et, L.E_ALBEDO, torch.where(a_flat_e, alb_e[0:3], et[L.E_ALBEDO]))
        emit_a = slice(L.E_EMIT_A, L.E_EMIT_A + 1)
        et = _set_rows(et, emit_a, torch.where(r_flat_e, rome_e[3], et[L.E_EMIT_A])[None, :])
        arrays = dataclasses.replace(arrays, emissive_table=et)

    if meta.has_sky:
        sd = params.sun_dir / torch.sqrt(torch.clamp_min(torch.sum(params.sun_dir ** 2), 1e-12))
        sky = bake_sky_cubemap(earth_atmosphere(), sd, params.sun_lum, int(arrays.sky.shape[1]),
                               sky_steps, device=tt.device)
        arrays = dataclasses.replace(arrays, sky=sky, sky_corners=sky_corner_planes(sky))

    return arrays, cam._replace(eye=params.cam_eye)


def make_render_fn(meta: SceneMeta, width: int, height: int, max_bounces: int = 3,
                   sky_steps: int = 16):
    """render(params, arrays, lights, cam, sample_idx[, pixel_ids])
    -> ([N, 3] color, [G, E] live), differentiable in `params`."""
    dmeta = dataclasses.replace(meta, differentiable=True)

    def render(params: DiffParams, arrays, lights, cam, sample_idx, pixel_ids=None):
        with prof.span("pt.train.params"):
            arrays, cam = apply_params(dmeta, arrays, cam, params, sky_steps)
        dev = arrays.tri_table.device
        if pixel_ids is None:
            pixel_ids = torch.arange(width * height, dtype=torch.int64, device=dev)
        state = rng.make_state(pixel_ids, sample_idx)
        state, ro, rd = generate_primary_rays(cam, width, height, state, pixel_ids=pixel_ids)
        # full MIS and no Russian roulette: the estimator stays smooth in the
        # parameters (no strategy or termination flips)
        res = trace_rays(dmeta, arrays, lights, ro, rd, state, max_bounces,
                         mis_both=True, use_rr=False)
        return res.color, res.live

    return render


def make_loss_fn(meta: SceneMeta, width: int, height: int, max_bounces: int = 3,
                 sky_steps: int = 16):
    """L2 image loss against a target: loss_fn(params, arrays, lights, cam,
    target, sample_idx[, pixel_ids]) -> (loss, live)."""
    render = make_render_fn(meta, width, height, max_bounces, sky_steps)

    def loss_fn(params, arrays, lights, cam, target, sample_idx, pixel_ids=None):
        color, live = render(params, arrays, lights, cam, sample_idx, pixel_ids)
        return torch.mean((color - target) ** 2), live

    return loss_fn


def make_train_step(meta: SceneMeta, width: int, height: int, max_bounces: int = 3,
                    sky_steps: int = 16, learning_rate: float = 2e-2,
                    trainable: Optional[DiffParams] = None, mesh=None):
    """Inverse-rendering step: Adam over `DiffParams`, on one device or
    data-parallel over a mesh (`parallel.shard.make_mesh`).

    trainable: optional DiffParams of bools selecting the groups that are
    updated (default: all).  A frozen group gets a zero gradient, as in the
    JAX package, which leaves it unchanged; its gradient is not computed.

    mesh: None or a world of one traces every pixel, as it always has.  On a
    world of N ranks each rank traces its contiguous rank-major slice of the
    pixel ids (the RNG keyed by the global id, so a pixel traces the same
    path on any rank) and its loss is the mean over its rows; each trainable
    group's gradient is then averaged over the ranks in place
    (`parallel.grad_reduce.GradReducer`, each all_reduce started from a
    post-accumulate-grad hook while the backward runs on), the loss too,
    and the same Adam step runs on every rank.  After a step `p.grad` holds the whole batch's mean gradient and
    every rank's parameters are the same bits.  This is the deployment's
    step; `shard.make_sharded_train_step` is the JAX package's plain-SGD
    counterpart.  The light histogram (`live`) the render returns is
    dropped on any world, so the lights are left unchanged.

    Returns (init, step):
      init(params) -> opt_state, a `torch.optim.Adam` over the leaves of
        `params` (which must be leaf tensors; they are updated in place);
      step(params, opt_state, arrays, lights, cam, target, sample_idx)
        -> (loss, params, opt_state); on a mesh `target` is the whole
        [width * height, 3] image or this rank's rows of it, and the loss
        the ranks' mean, the whole batch's.
    Every group gets a gradient (zeros where none reached it) before the
    update, so all of Adam's per-tensor step counts advance together, as
    optax's one count does."""
    loss_fn = make_loss_fn(meta, width, height, max_bounces, sky_steps)
    mask = DiffParams(*([True] * len(DiffParams._fields))) if trainable is None else trainable
    rows = pixel_ids = None
    if mesh is not None and mesh.size > 1:
        rows, pixel_ids = local_pixels(mesh, width * height)

    def init(params: DiffParams) -> torch.optim.Adam:
        for p, on in zip(params, mask):
            p.requires_grad_(bool(on))
        return torch.optim.Adam(list(params), lr=learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS)

    @prof.spanned("pt.train")
    def step(params: DiffParams, opt_state: torch.optim.Adam, arrays, lights, cam, target,
             sample_idx):
        opt_state.zero_grad(set_to_none=True)
        reducer, hooks = None, []
        if pixel_ids is not None:
            reducer = GradReducer(mesh, [p for p in params if p.requires_grad])
            hooks = reducer.hooks()
            if target.shape[0] == width * height:
                target = target[rows]
        try:
            # pt.train.params (the sky re-bake) nests in the forward: the loss
            # function applies the parameters
            with prof.span("pt.train.forward"):
                loss, _ = loss_fn(params, arrays, lights, cam, target, sample_idx, pixel_ids)
            with prof.span("pt.train.backward"):
                loss.backward()
        finally:
            for h in hooks:
                h.remove()
        loss = loss.detach()
        if reducer is not None:
            with prof.span("pt.train.reduce"):
                loss = reducer.finish(loss)
        with prof.span("pt.train.adam"):
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            opt_state.step()
        return loss, params, opt_state

    return init, step
