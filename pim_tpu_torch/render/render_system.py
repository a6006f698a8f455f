"""Render system: the per-frame orchestrator and its console commands.

Counterpart of `pim_tpu.render.render_system`.  It owns the progressive
trace buffers, the scene, the camera and depth of field, the exposure state
and the adaptive light state, and registers the shell's commands
(cornell_box, teleport, lookat, pt_test, pt_gate, pt_stddev, screenshot,
mapsave, mapload, mapgen, ckpt_save, ckpt_load, loadtest, probe_bake,
probe_report).

One frame (`frame_step`) is: the autofocus probe (one closest-hit ray down
the view), `pt_spp` one-sample traces with sample ids sample_idx + i,
their mean folded into the buffers with weight spp / count, the frame's
light histogram folded into the light pdfs, and the auto-exposure pass on
the carried exposure state.  It runs on the device with no host sync; the
shell syncs once a frame, reading the new focal length back as the
reference does.  Everything runs on `RenderSystem.device`, the card unless
the caller asks for the CPU.

Before the frame, `update` runs the bakes in the reference's order: the
sky (when a sun or atmosphere cvar changed), the progressive SG lightmap
while `lm_gen` is on (`_lightmap_trace`: pack once, then one timesliced
`lightmap.bake_step` a `lm_spp` pass) and the reflection probes while
`r_refl_gen` is on (`_cubemap_trace`: every registered cubemap baked and
convolved, a 64^2 "default" probe when none is registered).  The
`probe_bake` and `probe_report` commands bake and log an ambient-cube and
L1 SH light probe.  Checkpoints carry the lightmap pack, the light probes
and the lightmap's frame counter; the reflection probes are not in a
checkpoint, as in the reference.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field, replace
from typing import List, Optional

import numpy as np
import torch

from pim_tpu_torch.core import cvars as cv
from pim_tpu_torch.core import rng
from pim_tpu_torch.core.cmd import CmdStat, cmd_getopt, get_cmd_system
from pim_tpu_torch.core.console import LogSev, con_logf
from pim_tpu_torch.core.crate import Crate
from pim_tpu_torch.core.profiler import profile, spanned
from pim_tpu_torch.core.timesys import get_timesys
from pim_tpu_torch.geom.cornell import build_cornell_box
from pim_tpu_torch.geom.entities import Entities
from pim_tpu_torch.geom.material import TexturePool
from pim_tpu_torch.math.vec3 import RCP_EPS, V3, f32
from pim_tpu_torch.render.camera import (Camera, CameraArrays, DofInfo, camera_arrays,
                                         generate_primary_rays)
from pim_tpu_torch.render.exposure import (ExposureParams, ExposureState, exposure_pass,
                                           make_exposure_state)
from pim_tpu_torch.render.integrator import (TraceBuffers, TraceResult, accumulate,
                                             luminance_stddev, make_trace_buffers, trace_rays)
from pim_tpu_torch.render.scene import (LightState, SceneMeta, build_scene, scene_intersect,
                                        update_light_state)
from pim_tpu_torch.render.screenshot import quantize_dithered, tonemap_for_display, write_png

BANDS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "pt_gate_bands.json")
# the pt_backend cvar's names -> the port's intersectors
_BACKENDS = {"auto": "auto", "pallas": "dense", "dense": "dense", "cluster": "cluster",
             "brute": "brute", "bvh": "bvh"}
_LIGHT_FIELDS = ("pdf", "cdf", "integral", "sum", "live")
_U32_FIELDS = ("sum", "live")  # uint32 words in a crate, int64 in the port


def load_gate_band(sample_count: int, scene: str = "cornell"):
    """The calibrated pt_gate band of `scene` for `sample_count` samples: the
    tier with the most samples not above the count, from the port's band
    file.  Returns (maxstddev, meanlo, meanhi), or None when no tier covers
    the count."""
    with open(BANDS_PATH) as f:
        data = json.load(f)
    best = None
    for e in data.get("entries", []):
        if e.get("scene", "cornell") != scene:
            continue
        if e["min_samples"] <= sample_count and (best is None
                                                 or e["min_samples"] > best["min_samples"]):
            best = e
    if best is None:
        return None
    return float(best["maxstddev"]), float(best["meanlo"]), float(best["meanhi"])


@spanned("pt.trace")
def trace_samples(scene, cam: CameraArrays, width: int, height: int, bounces: int, spp: int,
                  first_sample: int, seed: int = rng.DEFAULT_SEED, blade_count: int = 5,
                  blade_rot: float = float(np.pi / 10.0)) -> TraceResult:
    """`spp` one-sample traces with sample ids first_sample + i, folded as
    the reference's frame step folds them: the mean of their color, albedo
    and normal; the sum of their light histograms, wrapped to 32 bits as
    the reference's uint32 sum; rays_traced, their total (float64, on the
    device)."""
    meta, arrays, lights = scene
    dev = arrays.tri_table.device
    n = width * height
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    color, albedo, normal = (torch.zeros((n, 3), dtype=torch.float32, device=dev)
                             for _ in range(3))
    live = torch.zeros(lights.live.shape, dtype=torch.int64, device=dev)
    rays = torch.zeros((), dtype=torch.float64, device=dev)
    for i in range(spp):
        state = rng.make_state(pix, (first_sample + i) & rng.MASK32, seed=seed)
        state, ro, rd = generate_primary_rays(cam, width, height, state, blade_count, blade_rot)
        res = trace_rays(meta, arrays, lights, ro, rd, state, bounces)
        color = color + res.color
        albedo = albedo + res.albedo
        normal = normal + res.normal
        live = live + res.live
        rays = rays + res.rays_traced.to(torch.float64)
    inv = f32(1.0 / spp)
    return TraceResult(color=color * inv, albedo=albedo * inv, normal=normal * inv,
                       live=live & rng.MASK32, rays_traced=rays)


@dataclass(frozen=True)
class FrameConfig:
    """What a frame step holds fixed: the scene's meta, the resolution and
    the cvars it reads once."""
    meta: SceneMeta
    width: int
    height: int
    max_bounces: int
    blade_count: int
    blade_rot: float
    autofocus_rate: float
    debug: bool = False
    spp: int = 1


def frame_step(cfg: FrameConfig, arrays, lights: LightState, buffers: TraceBuffers,
               exp_state: ExposureState, exp_params: ExposureParams, cam: CameraArrays,
               sample_idx: int, sample_weight: float, dt: float, autofocus: bool, seed: int):
    """One progressive frame on the scene's device, with no host sync
    (unless cfg.debug).  Returns (buffers, lights, exposure state, focal
    length as a 0-d device tensor)."""
    dev = arrays.tri_table.device

    # the autofocus probe: one ray down the view
    def one(v):
        return torch.full((1,), float(v), dtype=torch.float32, device=dev)

    probe = scene_intersect(cfg.meta, arrays, V3(*(one(v) for v in cam.eye)),
                            V3(*(one(v) for v in cam.fwd)), 0.0, RCP_EPS)
    f0 = cam.focal_length
    focal = torch.full_like(probe.t[0], f0)
    if autofocus:
        t_af = f32(np.clip(np.float32(1.0) - np.exp(-np.float32(dt)
                                                    * np.float32(cfg.autofocus_rate)), 0.0, 1.0))
        t = probe.t[0]
        focal = torch.where(t > 0.0, f0 + (t - f0) * t_af, focal)

    batch = trace_samples((cfg.meta, arrays, lights), cam._replace(focal_length=focal),
                          cfg.width, cfg.height, cfg.max_bounces, cfg.spp, int(sample_idx),
                          int(seed), cfg.blade_count, cfg.blade_rot)
    buffers = accumulate(buffers, batch, sample_weight)

    # fold the frame's light histogram, then adapt the light pdfs
    lights = update_light_state(replace(lights, live=(lights.live + batch.live) & rng.MASK32))
    exp_state = exposure_pass(buffers.color, exp_params, exp_state, dt)

    if cfg.debug:
        checks = (
            (torch.isfinite(buffers.color).all(),
             "non-finite radiance in the accumulated color buffer"),
            (torch.isfinite(lights.pdf).all(), "non-finite adapted light pdf"),
            (torch.isfinite(exp_state.avg_lum) & torch.isfinite(focal),
             "non-finite exposure/autofocus state"),
        )
        for ok, what in checks:
            if not bool(ok):
                raise FloatingPointError(f"pt_debug: {what} (sample {int(sample_idx)})")
    return buffers, lights, exp_state, focal


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclass
class RenderSystem:
    width: int = 256
    height: int = 256
    device: str = "cuda"

    entities: Entities = field(default_factory=Entities)
    pool: TexturePool = field(default_factory=TexturePool)
    camera: Camera = field(default_factory=Camera)
    dof: DofInfo = field(default_factory=DofInfo)

    meta: Optional[SceneMeta] = None
    arrays: object = None
    lights: Optional[LightState] = None
    buffers: Optional[TraceBuffers] = None
    exp_state: Optional[ExposureState] = None
    sample_count: int = 0
    scene_modtime: int = -1
    lm_pack: Optional[object] = None                   # lightmap.LmPack while lm_gen bakes
    probes: dict = field(default_factory=dict)          # name -> probes.LightProbe
    _lm_frame: int = 0
    _refl_version: int = -1
    _step: Optional[FrameConfig] = None
    _cam_snapshot: tuple = ()
    _sky_versions: dict = field(default_factory=dict)
    _cfg_versions: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RenderSystem(device='cuda'): no CUDA device is available")
        if self.exp_state is None:
            self.exp_state = make_exposure_state(self.device)

    def init(self) -> None:
        self._register_cmds()

    # --- scene management ---------------------------------------------------

    def _ensure_scene(self) -> None:
        if self.meta is None or self.entities.modtime != self.scene_modtime:
            with profile("PtScene_Update"):
                name = str(cv.cv_pt_backend.get()).strip().lower()
                if name not in _BACKENDS:
                    raise ValueError(f"pt_backend {name!r}: the port has auto, pallas (dense), "
                                     "cluster, brute and bvh")
                self.meta, self.arrays, self.lights = build_scene(
                    self.entities, self.pool, self.device, backend=_BACKENDS[name],
                    media_enabled=bool(cv.cv_pt_media.get()))
                con_logf(LogSev.Info, "scene",
                         "built scene: %d tris, %d emissives, grid %s, backend=%s, media=%d",
                         self.meta.tri_count, self.meta.emissive_count, self.meta.grid_size,
                         self.meta.backend, int(self.meta.media_enabled))
                self.scene_modtime = self.entities.modtime
                self._step = None
                # a rebuilt scene holds a black sky cube until it is baked again
                self._sky_versions = {}
                self.reset_accumulation()

    def reset_accumulation(self) -> None:
        self.buffers = make_trace_buffers(self.width, self.height, self.device)
        self.sample_count = 0

    def set_resolution(self, width: int, height: int) -> None:
        if (width, height) != (self.width, self.height):
            self.width = width
            self.height = height
            self._step = None
            self.reset_accumulation()

    def _camera_snapshot(self):
        return (
            tuple(np.round(self.camera.position, 6).tolist()),
            tuple(np.round(self.camera.rotation, 6).tolist()),
            round(self.camera.fov_y, 4),
        )

    # --- per-frame ----------------------------------------------------------

    def _check_dirty(self, *cvars) -> bool:
        dirty = False
        for c in cvars:
            d, v = c.check_dirty(self._cfg_versions.get(c.name, -1))
            self._cfg_versions[c.name] = v
            dirty = dirty or d
        return dirty

    def _check_config(self) -> None:
        """Honour cvar changes that the scene or the frame step holds fixed.
        The first call records the versions; later changes invalidate the
        layer they belong to (pt_media, pt_backend, pt_sort and
        r_brdflut_spf rebuild the scene)."""
        first = not self._cfg_versions
        res_dirty = self._check_dirty(cv.cv_r_width, cv.cv_r_height, cv.cv_r_scale)
        scene_dirty = self._check_dirty(cv.cv_pt_backend, cv.cv_pt_media, cv.cv_r_brdflut_spf,
                                        cv.cv_pt_sort)
        step_dirty = self._check_dirty(cv.cv_pt_max_bounces, cv.cv_pt_debug, cv.cv_pt_spp)
        accum_dirty = self._check_dirty(cv.cv_pt_seed)
        if first:
            return
        if res_dirty:
            s = float(cv.cv_r_scale.get())
            self.set_resolution(max(1, int(round(cv.cv_r_width.get() * s))),
                                max(1, int(round(cv.cv_r_height.get() * s))))
        if scene_dirty:
            self.scene_modtime = -1  # a full rebuild next frame
        elif step_dirty:
            self._step = None
            self.reset_accumulation()
        elif accum_dirty:
            # mixing seeds within one accumulation breaks reproducibility
            self.reset_accumulation()

    def update(self) -> None:
        """One progressive frame."""
        if not cv.cv_pt_trace.get():
            return
        self._check_config()
        self._ensure_scene()
        if self.meta.tri_count == 0:
            return

        snap = self._camera_snapshot()
        if snap != self._cam_snapshot:
            self._cam_snapshot = snap
            self.reset_accumulation()

        self._bake_sky()
        self._lightmap_trace()
        self._cubemap_trace()

        if self._step is None:
            self._step = FrameConfig(
                self.meta, self.width, self.height, int(cv.cv_pt_max_bounces.get()),
                self.dof.blade_count, float(self.dof.blade_rot), float(self.dof.autofocus_speed),
                bool(cv.cv_pt_debug.get()), max(int(cv.cv_pt_spp.get()), 1))

        dt = f32(max(get_timesys().smooth_delta, 1.0 / 240.0))
        spp = self._step.spp
        base_idx = self.sample_count
        self.sample_count += spp
        # folding the mean of spp samples with weight spp / count equals spp
        # sequential 1 / n folds
        sw = f32(spp / self.sample_count)
        cam = camera_arrays(self.camera, self.dof, self.width, self.height,
                            focal_length=self.dof.focal_length)
        with profile("Pt_Trace"):
            self.buffers, self.lights, self.exp_state, focal = frame_step(
                self._step, self.arrays, self.lights, self.buffers, self.exp_state,
                ExposureParams.from_cvars(), cam, base_idx, sw, dt, bool(self.dof.autofocus),
                int(cv.cv_pt_seed.get()))
        self.dof.focal_length = float(focal)  # the frame's one host sync

    def _bake_sky(self, reset: bool = True) -> None:
        """Re-bake `arrays.sky` (and its corner planes) when a sun or
        atmosphere cvar changed and the scene has a sky; then restart the
        accumulation unless `reset` is False."""
        if not getattr(self.meta, "has_sky", False):
            return
        watched = (cv.cv_r_sun_dir, cv.cv_r_sun_lum, cv.cv_r_sun_res, cv.cv_r_sun_steps,
                   cv.cv_sky_rad_cr, cv.cv_sky_rad_at, cv.cv_sky_rlh_mfp, cv.cv_sky_rlh_sh,
                   cv.cv_sky_mie_mfp, cv.cv_sky_mie_sh, cv.cv_sky_mie_g)
        dirty = False
        for c in watched:
            d, v = c.check_dirty(self._sky_versions.get(c.name, -1))
            self._sky_versions[c.name] = v
            dirty = dirty or d
        if not dirty:
            return
        from pim_tpu_torch.render.sky import (atmosphere_from_cvars, bake_sky_cubemap,
                                              sky_corner_planes)

        with profile("BakeSky"):
            sd = np.asarray(cv.cv_r_sun_dir.get()[:3], np.float32)
            sd = sd / max(np.linalg.norm(sd), 1e-6)
            cube = bake_sky_cubemap(atmosphere_from_cvars(), sd, float(cv.cv_r_sun_lum.get()),
                                    int(cv.cv_r_sun_res.get()), int(cv.cv_r_sun_steps.get()),
                                    device=self.device)
            self.arrays = replace(self.arrays, sky=cube, sky_corners=sky_corner_planes(cube))
        if reset:
            self.reset_accumulation()

    def _lightmap_trace(self) -> None:
        """The progressive SG lightmap bake while lm_gen is on: pack the
        scene once, then each frame one timesliced bake_step a lm_spp pass,
        pass k of frame f with the bake frame f * lm_spp + k (the bake keys
        its RNG by (texel, frame), so each pass draws new rays)."""
        if not cv.cv_lm_gen.get():
            return
        from pim_tpu_torch.geom.entities import flatten
        from pim_tpu_torch.render import lightmap as lm

        if self.lm_pack is None:
            flat = flatten(self.entities)
            t0 = time.perf_counter()
            self.lm_pack = lm.pack_lightmaps(flat.positions, flat.normals,
                                             texels_per_meter=float(cv.cv_lm_density.get()),
                                             device=self.device)
            self._lm_frame = 0
            if self.lm_pack is None:
                return
            con_logf(LogSev.Info, "lm", "packed a %d^2 atlas in %.3f s", self.lm_pack.size,
                     time.perf_counter() - t0)
        with profile("Lightmap_Trace"):
            slices = max(int(cv.cv_lm_timeslice.get()), 1)
            t_total = self.lm_pack.position.shape[1]
            shard = -(-t_total // slices)
            off = (self._lm_frame % slices) * shard
            count = min(shard, t_total - off)
            if count > 0:
                spp = max(int(cv.cv_lm_spp.get()), 1)
                for k in range(spp):
                    self.lm_pack = lm.bake_step(
                        self.meta, self.arrays, self.lights, self.lm_pack,
                        self._lm_frame * spp + k, max_bounces=int(cv.cv_pt_max_bounces.get()),
                        texel_offset=off, texel_count=count)
            self._lm_frame += 1

    def _cubemap_trace(self) -> None:
        """The progressive reflection-probe bake while r_refl_gen is on:
        every registered probe is baked and convolved from its bounds
        center (the camera position is the fallback origin of an unbounded
        probe, frozen at its first bake).  Every probe's sample count
        restarts when r_refl_gen changes."""
        d, v = cv.cv_r_refl_gen.check_dirty(self._refl_version)
        self._refl_version = v
        from pim_tpu_torch.render.cubemap import get_registry

        reg = get_registry()
        if d:
            reg.reset_samples()
        if not cv.cv_r_refl_gen.get():
            return
        if not reg.names():
            reg.add("default", 64, device=self.device)
        with profile("Cubemap_Trace"):
            for name in reg.names():
                reg.bake(name, self.meta, self.arrays, self.lights,
                         fallback_origin=np.asarray(self.camera.position, np.float32),
                         max_bounces=int(cv.cv_pt_max_bounces.get()))

    # --- checkpoint / resume --------------------------------------------------
    # The checkpoint carries the entities, textures, camera, depth of field,
    # the trace buffers, sample count, adaptive light state and exposure, the
    # lightmap pack (with its per-texel sample counts and the bake frame) and
    # the light probes, so a progressive render and bake resume bit for bit.
    # The format is the JAX package's: a crate either package wrote resumes
    # in the other.  The lightmap entry also carries `axii` and `version`
    # (as lightmap.lmpack_to_crate_entry writes them); the JAX package's
    # checkpoint writes neither, and an entry without axii loads with
    # GI_AXII (ROADMAP F11).

    def checkpoint_save(self, path: str) -> None:
        crate = Crate()
        crate.set("entities", self.entities.to_crate_entry())
        crate.set("textures", self.pool.to_crate_entry())
        crate.set("camera", {
            "position": np.asarray(self.camera.position, np.float32),
            "rotation": np.asarray(self.camera.rotation, np.float32),
            "fov_y": float(self.camera.fov_y),
            "z_near": float(self.camera.z_near),
            "z_far": float(self.camera.z_far),
        })
        crate.set("dof", {
            "aperture": float(self.dof.aperture),
            "focal_length": float(self.dof.focal_length),
            "blade_count": int(self.dof.blade_count),
            "blade_rot": float(self.dof.blade_rot),
            "focal_plane_curvature": float(self.dof.focal_plane_curvature),
            "autofocus": bool(self.dof.autofocus),
            "autofocus_speed": float(self.dof.autofocus_speed),
        })
        crate.set("progress", {"width": self.width, "height": self.height,
                               "sample_count": self.sample_count, "lm_frame": self._lm_frame})
        if self.buffers is not None:
            crate.set("buffers", {k: _np(getattr(self.buffers, k))
                                  for k in ("color", "albedo", "normal")})
        if self.lights is not None:
            crate.set("lights", {
                f: (_np(getattr(self.lights, f)).astype(np.uint32) if f in _U32_FIELDS
                    else _np(getattr(self.lights, f))) for f in _LIGHT_FIELDS})
        crate.set("exposure", {"avg_lum": float(self.exp_state.avg_lum),
                               "exposure": float(self.exp_state.exposure)})
        if self.lm_pack is not None:
            from pim_tpu_torch.render.lightmap import lmpack_to_crate_entry

            crate.set("lmpack", lmpack_to_crate_entry(self.lm_pack))
        if self.probes:
            from pim_tpu_torch.render.probes import probe_to_crate_entry

            crate.set("light_probes", {name: probe_to_crate_entry(p)
                                       for name, p in self.probes.items()})
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        crate.save(path)

    def checkpoint_load(self, path: str) -> None:
        crate = Crate.load(path)
        self.entities = Entities.from_crate_entry(crate.get("entities"))
        tex = crate.get("textures")
        self.pool = TexturePool.from_crate_entry(tex) if tex is not None else TexturePool()
        c = crate.get("camera")
        self.camera.position = np.asarray(c["position"], np.float32)
        self.camera.rotation = np.asarray(c["rotation"], np.float32)
        self.camera.fov_y = float(c["fov_y"])
        self.camera.z_near = float(c["z_near"])
        self.camera.z_far = float(c["z_far"])
        for k, v in crate.get("dof").items():
            setattr(self.dof, k, type(getattr(self.dof, k))(v))
        prog = crate.get("progress")
        self.set_resolution(int(prog["width"]), int(prog["height"]))
        # rebuild the derived scene from the restored entities, bake its sky
        # (without restarting the accumulation), then overwrite the adaptive
        # light state with the checkpointed one
        self.scene_modtime = -1
        self._ensure_scene()
        self._bake_sky(reset=False)

        def dev_t(a, dtype):
            return torch.from_numpy(np.array(a)).to(device=self.device, dtype=dtype)

        lt = crate.get("lights")
        if lt is not None:
            self.lights = LightState(**{
                f: dev_t(np.asarray(lt[f]).astype(np.int64), torch.int64) if f in _U32_FIELDS
                else dev_t(lt[f], torch.float32) for f in _LIGHT_FIELDS})
        buf = crate.get("buffers")
        if buf is not None:
            self.buffers = TraceBuffers(*(dev_t(buf[k], torch.float32)
                                          for k in ("color", "albedo", "normal")))
        self.sample_count = int(prog["sample_count"])
        self._lm_frame = int(prog["lm_frame"])
        e = crate.get("exposure")
        self.exp_state = ExposureState(
            avg_lum=torch.tensor(np.float32(e["avg_lum"]), device=self.device),
            exposure=torch.tensor(np.float32(e["exposure"]), device=self.device))
        lp = crate.get("lmpack")
        if lp is not None:
            from pim_tpu_torch.render.lightmap import lmpack_from_crate_entry

            self.lm_pack = lmpack_from_crate_entry(lp, self.device)
        pr = crate.get("light_probes")
        if pr is not None:
            from pim_tpu_torch.render.probes import probe_from_crate_entry

            self.probes = {name: probe_from_crate_entry(e, self.device)
                           for name, e in pr.items()}
        # the restored camera must not restart the accumulation
        self._cam_snapshot = self._camera_snapshot()

    # --- outputs ------------------------------------------------------------

    def image_hdr(self, denoised: Optional[bool] = None) -> torch.Tensor:
        """The accumulated HDR buffer as [H, W, 3]; denoised when pt_denoise
        is on."""
        color = self.buffers.color
        if denoised is None:
            denoised = bool(cv.cv_pt_denoise.get())
        if denoised:
            from pim_tpu_torch.render.denoise import DenoiseType, denoise

            color = denoise(DenoiseType.Image, self.width, self.height, color,
                            albedo=self.buffers.albedo, normal=self.buffers.normal)
        return color.reshape(self.height, self.width, 3)

    def stddev(self) -> float:
        return float(luminance_stddev(self.buffers.color))

    def screenshot(self, name: Optional[str] = None) -> str:
        """A tonemapped PNG under screenshots/.  An unnamed one is named by the
        second; a second unnamed one in the same second (pt_test's denoised
        and raw pair) gets a suffix instead of overwriting the first, so the
        files a script writes do not depend on the clock."""
        if name is None:
            stamp = name = time.strftime("%Y_%m_%d_%H_%M_%S")
            k = 1
            while os.path.exists(os.path.join("screenshots", f"{name}.png")):
                name, k = f"{stamp}_{k}", k + 1
        path = os.path.join("screenshots", f"{name}.png")
        srgb = tonemap_for_display(self.image_hdr(), self.exp_state.exposure)
        write_png(path, quantize_dithered(srgb), flip_vertical=True)
        con_logf(LogSev.Info, "Sc", "Took screenshot '%s'", path)
        return path

    # --- commands -------------------------------------------------------------

    def _register_cmds(self) -> None:
        sys = get_cmd_system()

        def cmd_cornell(argv: List[str]) -> CmdStat:
            prim = argv[1] if len(argv) > 1 else "boxes"
            self.entities, self.pool = build_cornell_box(prim)
            self.camera.reset()
            self.reset_accumulation()
            return CmdStat.OK

        def cmd_teleport(argv: List[str]) -> CmdStat:
            if len(argv) < 4:
                con_logf(LogSev.Error, "cmd", "usage: teleport x y z")
                return CmdStat.ERR
            self.camera.position = np.asarray([float(argv[1]), float(argv[2]),
                                               float(argv[3])], np.float32)
            return CmdStat.OK

        def cmd_lookat(argv: List[str]) -> CmdStat:
            if len(argv) < 4:
                con_logf(LogSev.Error, "cmd", "usage: lookat x y z")
                return CmdStat.ERR
            self.camera.look_at([float(argv[1]), float(argv[2]), float(argv[3])])
            return CmdStat.OK

        def cmd_pt_test(argv: List[str]) -> CmdStat:
            frames = cmd_getopt(argv, "frames")
            frames = max(1, min(int(frames) if frames else 500, 1 << 23))
            q = get_cmd_system()
            for line in ("cornell_box", "teleport -4 0 4", "lookat 0 -1 0", "pt_denoise 0",
                         "exp_manual 1", "exp_evoffset 5", "pt_trace 1", f"wait {frames}",
                         "pt_stddev"):
                q.enqueue(line)
            # the regression gate: the calibrated bands unless bounds or
            # -nogate are passed through; a bare pt_gate fails when no band
            # covers the run
            if not cmd_getopt(argv, "nogate", flag=True):
                fwd = ""
                for opt in ("maxstddev", "meanlo", "meanhi"):
                    val = cmd_getopt(argv, opt)
                    if val is not None:
                        fwd += f" -{opt} {val}"
                q.enqueue("pt_gate" + fwd)
            # a denoised and a raw screenshot
            for line in ("pt_denoise 1", "screenshot", "pt_denoise 0", "screenshot; pt_trace 0",
                         "quit"):
                q.enqueue(line)
            return CmdStat.OK

        def cmd_pt_gate(argv: List[str]) -> CmdStat:
            """The convergence gate: fails (and so fails a batch run) when the
            image's luminance stddev exceeds -maxstddev or its mean leaves
            [-meanlo, -meanhi].  With no bounds given, the band is the port's
            calibrated tier for `-scene` (default cornell) and the sample
            count; no covering tier is a failure."""
            if self.buffers is None:
                con_logf(LogSev.Error, "pt", "pt_gate: nothing rendered")
                return CmdStat.ERR
            max_sd_s = cmd_getopt(argv, "maxstddev")
            mean_lo_s = cmd_getopt(argv, "meanlo")
            mean_hi_s = cmd_getopt(argv, "meanhi")
            if max_sd_s is None and mean_lo_s is None and mean_hi_s is None:
                scene = cmd_getopt(argv, "scene") or "cornell"
                band = load_gate_band(self.sample_count, scene)
                if band is None:
                    con_logf(LogSev.Error, "pt",
                             "pt_gate: no calibrated '%s' band covers %d samples (derive one "
                             "with tools/calibrate_torch_pt_gate.py or pass "
                             "-maxstddev/-meanlo/-meanhi)", scene, self.sample_count)
                    return CmdStat.ERR
                max_sd, mean_lo, mean_hi = band
            else:
                max_sd = float(max_sd_s or "1e30")
                mean_lo = float(mean_lo_s or "0")
                mean_hi = float(mean_hi_s or "1e30")
            sd = self.stddev()
            mean = float(self.buffers.color.mean())
            ok = (sd <= max_sd) and (mean_lo <= mean <= mean_hi)
            con_logf(LogSev.Info if ok else LogSev.Error, "pt",
                     "pt_gate %s: stddev=%f (max %g) mean=%f (band [%g, %g]) @ %d samples",
                     "OK" if ok else "FAIL", sd, max_sd, mean, mean_lo, mean_hi,
                     self.sample_count)
            return CmdStat.OK if ok else CmdStat.ERR

        def cmd_pt_stddev(argv: List[str]) -> CmdStat:
            if self.buffers is None:
                return CmdStat.ERR
            sd = self.stddev()
            con_logf(LogSev.Info, "pt", "StdDev: %f", sd)
            self.screenshot(f"pt_stddev_{sd:f}")
            return CmdStat.OK

        def cmd_screenshot(argv: List[str]) -> CmdStat:
            if self.buffers is None:
                con_logf(LogSev.Error, "Sc", "nothing rendered yet")
                return CmdStat.ERR
            self.screenshot(argv[1] if len(argv) > 1 else None)
            return CmdStat.OK

        def cmd_mapsave(argv: List[str]) -> CmdStat:
            name = argv[1] if len(argv) > 1 else "map"
            crate = Crate()
            crate.set("entities", self.entities.to_crate_entry())
            # textures ride with the map: material records hold atlas ids
            crate.set("textures", self.pool.to_crate_entry())
            os.makedirs("maps", exist_ok=True)
            crate.save(os.path.join("maps", f"{name}.crate"))
            con_logf(LogSev.Info, "map", "saved maps/%s.crate", name)
            return CmdStat.OK

        def cmd_mapload(argv: List[str]) -> CmdStat:
            if len(argv) < 2:
                con_logf(LogSev.Error, "cmd", "usage: mapload <name>")
                return CmdStat.ERR
            name = argv[1]
            path = os.path.join("maps", f"{name}.crate")
            if os.path.exists(path):
                crate = Crate.load(path)
                self.entities = Entities.from_crate_entry(crate.get("entities"))
                tex = crate.get("textures")
                self.pool = TexturePool.from_crate_entry(tex) if tex is not None else TexturePool()
                self.camera.reset()
                self.reset_accumulation()
                return CmdStat.OK
            # the glTF asset: <basedir>/<name>/glTF/<name>.gltf
            from pim_tpu_torch.geom.gltf import load_gltf_scene

            gltf_path = os.path.join(cv.cv_basedir.get(), name, "glTF", f"{name}.gltf")
            try:
                self.entities, self.pool = load_gltf_scene(gltf_path)
            except FileNotFoundError:
                con_logf(LogSev.Error, "map", "no map '%s'", name)
                return CmdStat.ERR
            self.camera.reset()
            self.reset_accumulation()
            return CmdStat.OK

        def cmd_mapgen(argv: List[str]) -> CmdStat:
            """Generate a procedural multi-room map, export it as a glTF asset
            under <basedir>/<name>/glTF/, then load it through the importer."""
            name = argv[1] if len(argv) > 1 else "e1m1"
            rooms_s = cmd_getopt(argv, "rooms")
            seed_s = cmd_getopt(argv, "seed")
            steps_s = cmd_getopt(argv, "steps")
            rooms = tuple(int(v) for v in rooms_s.split("x")) if rooms_s else (3, 3)
            from pim_tpu_torch.geom.maps import export_map

            path = export_map(name, base_dir=cv.cv_basedir.get(), rooms=rooms,
                              seed=int(seed_s) if seed_s else 1,
                              sphere_steps=int(steps_s) if steps_s else 24)
            con_logf(LogSev.Info, "map", "generated %s", path)
            return get_cmd_system().immediate(f"mapload {name}")

        def cmd_ckpt_save(argv: List[str]) -> CmdStat:
            name = argv[1] if len(argv) > 1 else "ckpt"
            path = os.path.join("maps", f"{name}.ckpt.crate")
            self.checkpoint_save(path)
            con_logf(LogSev.Info, "ckpt", "saved %s (sample %d)", path, self.sample_count)
            return CmdStat.OK

        def cmd_ckpt_load(argv: List[str]) -> CmdStat:
            name = argv[1] if len(argv) > 1 else "ckpt"
            path = os.path.join("maps", f"{name}.ckpt.crate")
            if not os.path.exists(path):
                con_logf(LogSev.Error, "ckpt", "no checkpoint '%s'", path)
                return CmdStat.ERR
            self.checkpoint_load(path)
            con_logf(LogSev.Info, "ckpt", "resumed %s at sample %d", path, self.sample_count)
            return CmdStat.OK

        def cmd_loadtest(argv: List[str]) -> CmdStat:
            """Load every map under <basedir>; the scene loaded before is
            restored afterwards, also after a failure."""
            base = cv.cv_basedir.get()
            if not os.path.isdir(base):
                con_logf(LogSev.Error, "map", "no basedir '%s'", base)
                return CmdStat.ERR
            names = sorted(n for n in os.listdir(base)
                           if os.path.isdir(os.path.join(base, n, "glTF")))
            saved = (self.entities, self.pool)
            status = CmdStat.OK
            try:
                for n in names:
                    if get_cmd_system().immediate(f"mapload {n}") != CmdStat.OK:
                        status = CmdStat.ERR
                        break
                    tris = sum(m.length // 3 for m in self.entities.meshes if m is not None)
                    con_logf(LogSev.Info, "map", "loadtest %s: %d tris ok", n, tris)
            finally:
                self.entities, self.pool = saved
                self.scene_modtime = -1  # rebuild: the loop replaced the scene
                self.reset_accumulation()
            if status == CmdStat.OK:
                con_logf(LogSev.Info, "map", "loadtest: %d maps ok", len(names))
            return status

        def cmd_probe_bake(argv: List[str]) -> CmdStat:
            """One progressive pass of an ambient-cube and L1 SH light probe
            at the camera (or at -at x y z); repeat to refine.  A probe moved
            to a new origin starts over."""
            from pim_tpu_torch.render.probes import probe_bake_step, probe_new

            self._ensure_scene()
            if self.meta is None or self.meta.tri_count == 0:
                con_logf(LogSev.Error, "probe", "no scene loaded")
                return CmdStat.ERR
            name = argv[1] if len(argv) > 1 and not argv[1].startswith("-") else "camera"
            samples = int(cmd_getopt(argv, "samples") or 1024)
            if cmd_getopt(argv, "at") is not None:
                i = argv.index("-at") if "-at" in argv else argv.index("--at")
                origin = np.asarray([float(argv[i + 1]), float(argv[i + 2]),
                                     float(argv[i + 3])], np.float32)
            else:
                origin = np.asarray(self.camera.position, np.float32)
            probe = self.probes.get(name)
            if probe is None or not np.allclose(_np(probe.origin), origin):
                probe = probe_new(origin, self.device)
            probe = probe_bake_step(self.meta, self.arrays, self.lights, probe, samples=samples,
                                    max_bounces=int(cv.cv_pt_max_bounces.get()))
            self.probes[name] = probe
            con_logf(LogSev.Info, "probe", "probe '%s' pass %d (%d rays) at (%.2f %.2f %.2f)",
                     name, int(probe.sample_count), samples, *origin.tolist())
            return CmdStat.OK

        def cmd_probe_report(argv: List[str]) -> CmdStat:
            """Log a probe's ambient-cube and SH irradiance along the six
            axes."""
            from pim_tpu_torch.render.probes import probe_irradiance, probe_sh_irradiance

            name = argv[1] if len(argv) > 1 else "camera"
            probe = self.probes.get(name)
            if probe is None:
                con_logf(LogSev.Error, "probe", "no probe '%s'", name)
                return CmdStat.ERR
            axes = np.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                               [0, 0, -1]], np.float32)
            cube = _np(probe_irradiance(probe, axes))
            sh = _np(probe_sh_irradiance(probe, axes))
            for i, tag in enumerate(["+x", "-x", "+y", "-y", "+z", "-z"]):
                con_logf(LogSev.Info, "probe", "%s %s cube(%.4f %.4f %.4f) sh(%.4f %.4f %.4f)",
                         name, tag, *cube[i].tolist(), *sh[i].tolist())
            return CmdStat.OK

        sys.reg("probe_bake", cmd_probe_bake, "bake an ambient-cube/SH light probe")
        sys.reg("probe_report", cmd_probe_report, "log a light probe's irradiance")
        sys.reg("cornell_box", cmd_cornell, "load the cornell box test scene")
        sys.reg("mapgen", cmd_mapgen, "generate + export + load a procedural map")
        sys.reg("loadtest", cmd_loadtest, "load/unload every map in basedir")
        sys.reg("teleport", cmd_teleport, "move the camera")
        sys.reg("lookat", cmd_lookat, "aim the camera at a point")
        sys.reg("pt_test", cmd_pt_test, "run the path tracer convergence test")
        sys.reg("pt_gate", cmd_pt_gate, "assert stddev/mean bounds (regression gate)")
        sys.reg("pt_stddev", cmd_pt_stddev, "print luminance stddev + screenshot")
        sys.reg("screenshot", cmd_screenshot, "write a tonemapped png")
        sys.reg("mapsave", cmd_mapsave, "save entities + textures to a crate")
        sys.reg("mapload", cmd_mapload, "load a map (crate or glTF)")
        sys.reg("ckpt_save", cmd_ckpt_save, "checkpoint the full progressive state")
        sys.reg("ckpt_load", cmd_ckpt_load, "resume from a progressive checkpoint")
