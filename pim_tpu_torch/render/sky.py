"""Physically-based sky: the Rayleigh/Mie single-scattering bake and the
cubemap fetch (K6).

Counterpart of `pim_tpu.render.sky`.  The bake marches every texel's view
ray in fixed steps (the reference's masked `lax.scan`, a Python loop here);
the sun march from each view sample is done for all its 96 steps at once,
with its liveness as a running product, so the loop holds only the view
steps.  The step positions are the reference's repeated float32 sums of the
step length, formed on the host.

The cubemap [6, S, S, 3] is fetched through K6 with C = 3 from [12, 6*S*S]
corner planes (`sky_corner_planes`, the reference's slice-shifts, clamped
at each face edge).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from pim_tpu_torch.math.sampling import mie_phase, rayleigh_phase
from pim_tpu_torch.math.vec3 import EPS, V3, f32
from pim_tpu_torch.render.table_gather import gather_bilinear

# fixed trip counts of the masked marches (the reference's)
VIEW_STEPS = 224
SUN_STEPS = 96
_MIN_DENSITY = f32(1e-5)


class SkyMedium(NamedTuple):
    """Atmosphere parameters (float32 constants)."""

    r_crust: float                    # planet radius, m
    r_atmos: float                    # kept for parity; unused by the march
    mu_r: Tuple[float, float, float]  # rayleigh scattering coefficients
    rho_r: float                      # 1 / rayleigh scale height
    mu_m: float                       # mie scattering coefficient
    rho_m: float                      # 1 / mie scale height
    g_m: float                        # mie anisotropy


def earth_atmosphere() -> SkyMedium:
    return SkyMedium(
        r_crust=f32(6360e3),
        r_atmos=f32(60.0),
        mu_r=(f32(1.0 / 192428.0), f32(1.0 / 82354.0), f32(1.0 / 33732.0)),
        rho_r=f32(1.0 / 8500.0),
        mu_m=f32(1.0 / 47619.0),
        rho_m=f32(1.0 / 1200.0),
        g_m=f32(0.758),
    )


def steps_to_trips(steps: int) -> int:
    """View-march trip count for a given r_sun_steps (the reference's)."""
    return min(VIEW_STEPS * max(steps, 1) // 4, 1024)


def _march_positions(mfp: np.float32, n: int) -> np.ndarray:
    """0, mfp, mfp + mfp, ...: the reference's running float32 sums."""
    out = np.zeros(n, np.float32)
    for k in range(1, n):
        out[k] = out[k - 1] + mfp
    return out


def atmosphere(sky: SkyMedium, ro, rd: V3, light_dir, luminance: float, steps: int) -> V3:
    """Single-scatter march.  ro: 3 floats (planet centre at the origin);
    rd: V3 of [D] unit directions; light_dir: 3 floats.  Returns V3 [D]."""
    dev = rd.x.device
    majorant = np.float32(max(sky.mu_m, max(sky.mu_r))) * np.float32(steps)
    mfp = np.float32(-np.log(np.float32(0.5))) / majorant
    mfp_f = float(mfp)
    r_crust = float(sky.r_crust)

    def density(px, py, pz):
        # |p| - r_crust cancels ~7 digits at the crust.  The squared norm is
        # formed as the reference's compiled code forms it, with fused
        # multiply-adds (x*x, then fma(y, y, .), then fma(z, z, .)), done
        # exactly in float64 and rounded once each; separate float32 ops
        # move h by ~0.5 m and the bake by up to 5e-5.
        s = ((px * px).double() + py.double() * py.double()).float()
        s = (s.double() + pz.double() * pz.double()).float()
        h = torch.sqrt(torch.clamp_min(s, EPS)) - r_crust
        dr = torch.exp(torch.clamp_max(-h * sky.rho_r, 0.0))
        dm = torch.exp(torch.clamp_max(-h * sky.rho_m, 0.0))
        return h, dr, dm

    t_sun = torch.from_numpy(_march_positions(mfp, SUN_STEPS)).to(dev)[:, None]  # [96, 1]
    sun_x = t_sun * float(light_dir[0])
    sun_y = t_sun * float(light_dir[1])
    sun_z = t_sun * float(light_dir[2])

    def sun_march(px, py, pz):
        """Optical depth toward the sun from each [D] point, all steps at once."""
        h, dr, dm = density(px[None, :] + sun_x, py[None, :] + sun_y, pz[None, :] + sun_z)
        crust = h < 0.0
        step_live = torch.cumprod((~crust & ((dr + dm) >= _MIN_DENSITY)).to(torch.int32),
                                  dim=0) > 0                                    # [96, D]
        live_before = torch.cat([torch.ones_like(step_live[:1]), step_live[:-1]], dim=0)
        od_r = torch.sum(torch.where(step_live, dr * mfp_f, 0.0), dim=0)
        od_m = torch.sum(torch.where(step_live, dm * mfp_f, 0.0), dim=0)
        hit_crust = torch.any(live_before & crust, dim=0)
        return od_r, od_m, hit_crust

    d = rd.x.shape[0]
    zeros = torch.zeros(d, dtype=torch.float32, device=dev)
    od_r_v, od_m_v = zeros, zeros
    tr_r = [zeros] * 3
    tr_m = [zeros] * 3
    live = torch.ones(d, dtype=torch.bool, device=dev)
    ox, oy, oz = (float(c) for c in ro)
    for t_v in _march_positions(mfp, steps_to_trips(steps)).tolist():
        px, py, pz = ox + rd.x * t_v, oy + rd.y * t_v, oz + rd.z * t_v
        h, dr, dm = density(px, py, pz)
        live = live & (h >= 0.0) & ((dr + dm) >= _MIN_DENSITY)
        od_r_i = dr * mfp_f
        od_m_i = dm * mfp_f
        od_r_v = od_r_v + torch.where(live, od_r_i, 0.0)
        od_m_v = od_m_v + torch.where(live, od_m_i, 0.0)
        od_r_l, od_m_l, hit_crust = sun_march(px, py, pz)
        m = (live & ~hit_crust).to(torch.float32)
        a_r = (od_r_v + od_r_l)
        a_m = (od_m_v + od_m_l)
        for c in range(3):
            tr_i = torch.exp(-(sky.mu_r[c] * a_r + sky.mu_m * a_m))
            tr_r[c] = tr_r[c] + tr_i * (od_r_i * m)
            tr_m[c] = tr_m[c] + tr_i * (od_m_i * m)

    cos_theta = rd.x * float(light_dir[0]) + rd.y * float(light_dir[1]) + rd.z * float(light_dir[2])
    ph_r = rayleigh_phase(cos_theta)
    ph_m = mie_phase(cos_theta, sky.g_m)
    out = [(tr_r[c] * sky.mu_r[c] * ph_r + tr_m[c] * (sky.mu_m * ph_m)) * f32(luminance)
           for c in range(3)]
    return V3(*out)


# face conventions (right and up axes of each cube face)
_FORWARDS = np.array(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32)
_UPS = np.array(
    [[0, 1, 0], [0, 1, 0], [0, 0, -1], [0, 0, -1], [0, 1, 0], [0, 1, 0]], np.float32)
_RIGHTS = np.array(
    [[0, 0, -1], [0, 0, 1], [1, 0, 0], [-1, 0, 0], [1, 0, 0], [-1, 0, 0]], np.float32)


def cubemap_dirs(size: int) -> np.ndarray:
    """Per-texel unit directions [6, size, size, 3] (host numpy)."""
    ts = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    u, v = np.meshgrid(ts, ts, indexing="xy")
    dirs = (_FORWARDS[:, None, None, :] + _RIGHTS[:, None, None, :] * u[None, ..., None]
            + _UPS[:, None, None, :] * v[None, ..., None])
    return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


def bake_sky_cubemap(sky: SkyMedium, sun_dir, sun_lum: float, size: int, steps: int,
                     device="cpu") -> torch.Tensor:
    """[6, size, size, 3] radiance cubemap, baked on `device` (the view
    rays start at the crust, at the north pole)."""
    dirs = torch.from_numpy(np.ascontiguousarray(cubemap_dirs(size).reshape(-1, 3).T)).to(device)
    s = np.asarray(sun_dir, np.float32)
    s = s / np.sqrt(np.maximum(np.sum(s * s), np.float32(1e-12)))
    out = atmosphere(sky, (0.0, float(sky.r_crust), 0.0), V3(dirs[0], dirs[1], dirs[2]),
                     s, sun_lum, steps)
    return out.aos().reshape(6, size, size, 3)


def sky_corner_planes(cube: torch.Tensor) -> torch.Tensor:
    """[6, S, S, 3] cube -> [12, 6*S*S] corner planes (rows corner*3 + ch,
    corners 00, 10, 01, 11; neighbours clamped at each face edge)."""
    right = torch.cat([cube[:, :, 1:], cube[:, :, -1:]], dim=2)
    down = torch.cat([cube[:, 1:], cube[:, -1:]], dim=1)
    diag = torch.cat([down[:, :, 1:], down[:, :, -1:]], dim=2)
    return torch.cat([p.reshape(-1, 3).T for p in (cube, right, down, diag)], dim=0).contiguous()


def sample_sky_cubemap_soa(corners: torch.Tensor, size: int, rd: V3, active=None) -> V3:
    """Bilinear-clamp cubemap fetch of V3 directions through K6.

    corners: `sky_corner_planes` of the cube; active: optional [N] bool of
    the lanes that consume the sample (the others get 0)."""
    ax = torch.abs(rd.x)
    ay = torch.abs(rd.y)
    az = torch.abs(rd.z)
    vmax = torch.maximum(ax, torch.maximum(ay, az))
    ma = 0.5 / torch.clamp_min(vmax, EPS)
    is_x = vmax == ax
    is_y = (~is_x) & (vmax == ay)
    f = torch.where(
        is_x,
        torch.where(rd.x < 0, 1, 0),
        torch.where(is_y, torch.where(rd.y < 0, 3, 2), torch.where(rd.z < 0, 5, 4)),
    )
    # face bases as selects: right = [0,0,-1],[0,0,1],[1,0,0],[-1,0,0],[1,0,0],[-1,0,0]
    # and up = [0,1,0],[0,1,0],[0,0,-1],[0,0,-1],[0,1,0],[0,1,0]
    odd = (f & 1) == 1
    rx = torch.where(f < 2, 0.0, torch.where(odd, -1.0, 1.0))
    rz = torch.where(f == 0, -1.0, torch.where(f == 1, 1.0, 0.0))
    is_y_face = (f == 2) | (f == 3)
    uy = torch.where(is_y_face, 0.0, 1.0)
    uz = torch.where(is_y_face, -1.0, 0.0)
    u = (rx * rd.x + rz * rd.z) * ma + 0.5
    v = (uy * rd.y + uz * rd.z) * ma + 0.5

    fx = torch.clamp(u, 0.0, 1.0) * float(size - 1)
    fy = torch.clamp(v, 0.0, 1.0) * float(size - 1)
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    tx = fx - x0.to(torch.float32)
    ty = fy - y0.to(torch.float32)
    i00 = f.to(torch.int32) * (size * size) + y0 * size + x0
    ok = torch.ones_like(tx, dtype=torch.bool) if active is None else active
    filt = gather_bilinear(corners, i00[None, :], tx[None, :], ty[None, :], ok[None, :], c=3)
    return V3(filt[0, 0], filt[1, 0], filt[2, 0])


def sky_radiance(meta, arrays, rd: V3, active=None) -> V3:
    """The scene's sky radiance along `rd` (0 for a scene without a sky)."""
    if not meta.has_sky:
        z = torch.zeros_like(rd.x)
        return V3(z, z, z)
    return sample_sky_cubemap_soa(arrays.sky_corners, arrays.sky.shape[1], rd, active=active)
