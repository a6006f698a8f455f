"""Camera: position + quaternion orientation, primary-ray generation, DoF.

Counterpart of `pim_tpu.render.camera`.  The camera basis is host numpy
(float32 values); `generate_primary_rays` draws the same RNG words in the
same order as the reference, the depth-of-field draws included.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Tuple

import numpy as np
import torch

from pimbench.reference.frozen.core import rng
from pimbench.reference.frozen.geom.cornell import quat_lookat
from pimbench.reference.frozen.math.sampling import sample_gauss_pixel_filter, sample_ngon, sample_pentagram
from pimbench.reference.frozen.math.vec3 import V3, dot, f32, lerp, normalize


def quat_identity() -> np.ndarray:
    return np.array([0.0, 0.0, 0.0, 1.0], np.float32)  # (x, y, z, w)


def quat_mul_dir(q: np.ndarray, d: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    u = np.array([x, y, z], np.float64)
    d = np.asarray(d, np.float64)
    t = 2.0 * np.cross(u, d)
    out = d + w * t + np.cross(u, t)
    return out.astype(np.float32)


def quat_fwd(q):
    return quat_mul_dir(q, np.array([0.0, 0.0, -1.0]))


def quat_up(q):
    return quat_mul_dir(q, np.array([0.0, 1.0, 0.0]))


def quat_right(q):
    return quat_mul_dir(q, np.array([1.0, 0.0, 0.0]))


@dataclass
class Camera:
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = field(default_factory=quat_identity)
    z_near: float = 0.1
    z_far: float = 500.0
    fov_y: float = 90.0  # degrees

    def reset(self) -> None:
        self.position = np.zeros(3, np.float32)
        self.rotation = quat_identity()

    def basis(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return quat_right(self.rotation), quat_up(self.rotation), quat_fwd(self.rotation)

    def look_at(self, target) -> None:
        rd = np.asarray(target, np.float32) - self.position
        rd = rd / np.linalg.norm(rd)
        self.rotation = quat_lookat(rd, np.array([0.0, 1.0, 0.0]))


@dataclass
class DofInfo:
    """Thin-lens depth of field."""

    aperture: float = 5.0e-3
    focal_length: float = 6.0
    blade_count: int = 5
    blade_rot: float = float(np.pi / 10.0)
    focal_plane_curvature: float = 0.05
    autofocus: bool = True
    autofocus_speed: float = 3.0


def proj_slope(fov_y_radians: float, aspect: float):
    t = float(np.tan(fov_y_radians * 0.5))
    return (aspect * t, t)


class CameraArrays(NamedTuple):
    """The camera basis as float32 values (Python floats holding float32).
    `eye` may instead be a [3] float32 tensor, e.g. one that requires grad
    (the differentiable path's camera position)."""

    eye: Tuple[float, float, float]
    right: Tuple[float, float, float]
    up: Tuple[float, float, float]
    fwd: Tuple[float, float, float]
    slope: Tuple[float, float]
    aperture: float
    focal_length: float
    focal_curvature: float


def camera_arrays(camera: Camera, dof: DofInfo, width: int, height: int,
                  focal_length=None) -> CameraArrays:
    right, up, fwd = camera.basis()
    slope = proj_slope(float(np.radians(camera.fov_y)), width / height)

    def v3(a):
        return tuple(f32(x) for x in np.asarray(a, np.float32))

    return CameraArrays(
        eye=v3(camera.position), right=v3(right), up=v3(up), fwd=v3(fwd),
        slope=(f32(slope[0]), f32(slope[1])),
        aperture=f32(dof.aperture),
        focal_length=f32(dof.focal_length if focal_length is None else focal_length),
        focal_curvature=f32(dof.focal_plane_curvature),
    )


def generate_primary_rays(cam: CameraArrays, width: int, height: int,
                          state: rng.RngState, blade_count: int = 5,
                          blade_rot: float = float(np.pi / 10.0),
                          enable_dof: bool = True, pixel_ids=None):
    """Per-pixel primary rays with gaussian AA jitter + bokeh DoF (SoA),
    one per pixel of the width*height frame (or of `pixel_ids`, a subset of
    its pixel indices), on the state's device.

    Returns (state, ro V3, rd V3)."""
    dev = state.x.device
    i = (torch.arange(width * height, dtype=torch.int64, device=dev) if pixel_ids is None
         else pixel_ids.to(device=dev, dtype=torch.int64))
    cx = (i % width).to(torch.float32)
    cy = (i // width).to(torch.float32)

    state, (au, av) = rng.next_f32x2(state)
    aax, aay = sample_gauss_pixel_filter(au, av, 1.0)
    u = (cx + 0.5 + aax) / f32(width)
    v = (cy + 0.5 + aay) / f32(height)
    sx = (u * 2.0 - 1.0) * cam.slope[0]
    sy = (v * 2.0 - 1.0) * cam.slope[1]

    right = V3(*cam.right)
    up = V3(*cam.up)
    fwd = V3(*cam.fwd)
    if isinstance(cam.eye, torch.Tensor):
        e = cam.eye.to(device=dev, dtype=torch.float32)
        eye = V3(*(e[k].expand(i.shape).contiguous() for k in range(3)))
    else:  # host numbers: filled on the device, so no copy (a host sync) a call
        eye = V3(*(torch.full(i.shape, float(c), dtype=torch.float32, device=dev)
                   for c in np.asarray(cam.eye, np.float32)))

    rd = normalize(V3(fwd.x + right.x * sx + up.x * sy,
                      fwd.y + right.y * sx + up.y * sy,
                      fwd.z + right.z * sx + up.z * sy))
    ro = eye

    if enable_dof:
        state, side = rng.next_u32(state)
        state, (xu, xv) = rng.next_f32x2(state)
        if blade_count == 666:
            offx, offy = sample_pentagram(xu, xv, side)
        else:
            offx, offy = sample_ngon(xu, xv, side, blade_count, f32(blade_rot))
        offx = offx * cam.aperture
        offy = offy * cam.aperture
        t = lerp(
            cam.focal_length / dot(rd, fwd),
            cam.focal_length,
            cam.focal_curvature,
        )
        focus = ro + rd * t
        aperture_pos = V3(ro.x + right.x * offx + up.x * offy,
                          ro.y + right.y * offx + up.y * offy,
                          ro.z + right.z * offx + up.z * offy)
        ro = aperture_pos
        rd = normalize(focus - aperture_pos)

    return state, ro, rd
