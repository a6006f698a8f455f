"""Physically-based sky: the Rayleigh/Mie single-scattering bake and the
cubemap fetch (K6, or K7 on the differentiable path).

Counterpart of `pim_tpu.render.sky`.  The bake marches every texel's view
ray in fixed steps (the reference's masked `lax.scan`, a Python loop here);
the sun march from each view sample is done for all its 96 steps at once,
with its liveness as a running product, so the loop holds only the view
steps.  The step positions are the reference's repeated float32 sums of the
step length, formed on the host.

The bake is differentiable in the sun's direction and luminance when they
are given as tensors (the differentiable path re-bakes the cube in every
step); each view step's 96-step sun march is then recomputed in the
backward (`torch.utils.checkpoint`) instead of keeping its [96, 6*S*S]
intermediates.  Given as floats, as the serving bake does, the cube is the
same as before, bit for bit.

The cubemap [6, S, S, 3] is fetched through K6 with C = 3 from [12, 6*S*S]
corner planes (`sky_corner_planes`, the reference's slice-shifts, clamped
at each face edge), or, on the differentiable path, by its four corners
through ONE K7 call on the [3, 6*S*S] cube planes and the JAX package's
lerp form.  The reflection probes read their own cubes with
`sample_sky_cubemap`, the reference's AoS fetch as plain torch ops (the
reference runs it as XLA ops too, outside Pallas).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from pim_tpu_torch.math.sampling import mie_phase, rayleigh_phase
from pim_tpu_torch.math.vec3 import EPS, V3, f32
from pim_tpu_torch.render.table_gather import gather_bilinear, gather_texels

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


def atmosphere_from_cvars() -> SkyMedium:
    """The atmosphere of the sky cvars (kilometres there, metres here)."""
    from pim_tpu_torch.core import cvars as cv

    rlh = cv.cv_sky_rlh_mfp.get()
    return SkyMedium(
        r_crust=f32(cv.cv_sky_rad_cr.get() * 1e3),
        r_atmos=f32(cv.cv_sky_rad_at.get()),
        mu_r=tuple(f32(1e-3 / max(v, 1e-3)) for v in rlh[:3]),
        rho_r=f32(1e-3 / cv.cv_sky_rlh_sh.get()),
        mu_m=f32(1e-3 / cv.cv_sky_mie_mfp.get()),
        rho_m=f32(1e-3 / cv.cv_sky_mie_sh.get()),
        g_m=f32(cv.cv_sky_mie_g.get()),
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


def _components(x):
    """3 floats (a float is repeated), or the 3 elements of a [3] tensor."""
    if isinstance(x, torch.Tensor):
        return [x[i] for i in range(3)]
    a = np.asarray(x, np.float32)
    return [float(a)] * 3 if a.ndim == 0 else [float(v) for v in a]


def atmosphere(sky: SkyMedium, ro, rd: V3, light_dir, luminance, steps: int) -> V3:
    """Single-scatter march.  ro: 3 floats (planet centre at the origin);
    rd: V3 of [D] unit directions; light_dir: 3 floats or a [3] tensor;
    luminance: a float, 3 floats or a [3] tensor.  Returns V3 [D],
    differentiable in the tensors given."""
    dev = rd.x.device
    ld = _components(light_dir)
    lum = _components(luminance)
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
    sun_x = t_sun * ld[0]
    sun_y = t_sun * ld[1]
    sun_z = t_sun * ld[2]
    recompute = sun_x.requires_grad and torch.is_grad_enabled()

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
        if recompute:
            od_r_l, od_m_l, hit_crust = checkpoint(sun_march, px, py, pz, use_reentrant=False)
        else:
            od_r_l, od_m_l, hit_crust = sun_march(px, py, pz)
        m = (live & ~hit_crust).to(torch.float32)
        a_r = (od_r_v + od_r_l)
        a_m = (od_m_v + od_m_l)
        for c in range(3):
            tr_i = torch.exp(-(sky.mu_r[c] * a_r + sky.mu_m * a_m))
            tr_r[c] = tr_r[c] + tr_i * (od_r_i * m)
            tr_m[c] = tr_m[c] + tr_i * (od_m_i * m)

    cos_theta = rd.x * ld[0] + rd.y * ld[1] + rd.z * ld[2]
    ph_r = rayleigh_phase(cos_theta)
    ph_m = mie_phase(cos_theta, sky.g_m)
    out = [(tr_r[c] * sky.mu_r[c] * ph_r + tr_m[c] * (sky.mu_m * ph_m)) * lum[c]
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


def bake_sky_cubemap(sky: SkyMedium, sun_dir, sun_lum, size: int, steps: int,
                     device="cpu") -> torch.Tensor:
    """[6, size, size, 3] radiance cubemap, baked on `device` (the view
    rays start at the crust, at the north pole).  sun_dir: 3 floats or a
    [3] tensor (normalized here); sun_lum: a float, 3 floats or a [3]
    tensor.  Differentiable in the tensors given."""
    dirs = torch.from_numpy(np.ascontiguousarray(cubemap_dirs(size).reshape(-1, 3).T)).to(device)
    if isinstance(sun_dir, torch.Tensor):
        s = sun_dir.to(device=device, dtype=torch.float32)
        s = s / torch.sqrt(torch.clamp_min(torch.sum(s * s), 1e-12))
    else:
        s = np.asarray(sun_dir, np.float32)
        s = s / np.sqrt(np.maximum(np.sum(s * s), np.float32(1e-12)))
    if isinstance(sun_lum, torch.Tensor):
        sun_lum = sun_lum.to(device=device, dtype=torch.float32)
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


def _cube_texel(size: int, rd: V3):
    """Face, texel corner and lerp weights of V3 directions:
    (face [N] i64, x0 i32, y0 i32, tx, ty)."""
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
    return f, x0, y0, tx, ty


def sample_sky_cubemap_soa(corners: torch.Tensor, size: int, rd: V3, active=None) -> V3:
    """Bilinear-clamp cubemap fetch of V3 directions through K6.

    corners: `sky_corner_planes` of the cube; active: optional [N] bool of
    the lanes that consume the sample (the others get 0)."""
    f, x0, y0, tx, ty = _cube_texel(size, rd)
    i00 = f.to(torch.int32) * (size * size) + y0 * size + x0
    ok = torch.ones_like(tx, dtype=torch.bool) if active is None else active
    filt = gather_bilinear(corners, i00[None, :], tx[None, :], ty[None, :], ok[None, :], c=3)
    return V3(filt[0, 0], filt[1, 0], filt[2, 0])


def cube_corner_idx(size: int, rd: V3):
    """The four bilinear-clamp corners of V3 directions in a [6*S*S] cube
    (idx [4, N] i32 in the order 00, 10, 01, 11) and the lerp weights."""
    f, x0, y0, tx, ty = _cube_texel(size, rd)
    x1 = torch.clamp_max(x0 + 1, size - 1)
    y1 = torch.clamp_max(y0 + 1, size - 1)
    base = f.to(torch.int32) * (size * size)
    row0 = base + y0 * size
    row1 = base + y1 * size
    return torch.stack([row0 + x0, row0 + x1, row1 + x0, row1 + x1], dim=0), tx, ty


def sample_sky_cubemap_planes(cube: torch.Tensor, rd: V3) -> V3:
    """Bilinear-clamp cubemap fetch of V3 directions, differentiable in the
    cube [6, S, S, 3]: the four corners through ONE K7 call on its [3, 6*S*S]
    planes, then the JAX package's lerp, t00 + (t10 - t00) tx, ..."""
    idx, tx, ty = cube_corner_idx(cube.shape[1], rd)
    tex = gather_texels(cube.reshape(-1, 3).T.contiguous(), idx)  # [3, 4, N]
    out = []
    for ch in range(3):
        t00, t10, t01, t11 = tex[ch]
        top = t00 + (t10 - t00) * tx
        bot = t01 + (t11 - t01) * tx
        out.append(top + (bot - top) * ty)
    return V3(*out)


def sample_sky_cubemap(cube: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear-clamp cubemap fetch: cube [6, S, S, 3], dirs [..., 3] ->
    [..., 3], the reference's AoS formula op for op."""
    size = cube.shape[1]
    absd = torch.abs(dirs)
    vmax = torch.amax(absd, dim=-1)
    ma = 0.5 / torch.clamp_min(vmax, EPS)

    is_x = vmax == absd[..., 0]
    is_y = (~is_x) & (vmax == absd[..., 1])
    face = torch.where(
        is_x,
        torch.where(dirs[..., 0] < 0, 1, 0),
        torch.where(is_y, torch.where(dirs[..., 1] < 0, 3, 2),
                    torch.where(dirs[..., 2] < 0, 5, 4)),
    )
    rights = torch.from_numpy(_RIGHTS).to(dirs.device)[face]
    ups = torch.from_numpy(_UPS).to(dirs.device)[face]
    u = torch.sum(rights * dirs, -1) * ma + 0.5
    v = torch.sum(ups * dirs, -1) * ma + 0.5

    fx = torch.clamp(u, 0.0, 1.0) * float(size - 1)
    fy = torch.clamp(v, 0.0, 1.0) * float(size - 1)
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    x1 = torch.clamp_max(x0 + 1, size - 1)
    y1 = torch.clamp_max(y0 + 1, size - 1)
    tx = (fx - x0.to(torch.float32))[..., None]
    ty = (fy - y0.to(torch.float32))[..., None]
    flat = cube.reshape(-1, 3)
    base = face * (size * size)
    taa = flat[base + y0 * size + x0]
    tba = flat[base + y0 * size + x1]
    tab = flat[base + y1 * size + x0]
    tbb = flat[base + y1 * size + x1]
    top = taa + (tba - taa) * tx
    bot = tab + (tbb - tab) * tx
    return top + (bot - top) * ty


def sky_radiance(meta, arrays, rd: V3, active=None) -> V3:
    """The scene's sky radiance along `rd` (0 for a scene without a sky);
    the differentiable path reads the cube itself through K7."""
    if not meta.has_sky:
        z = torch.zeros_like(rd.x)
        return V3(z, z, z)
    if meta.differentiable:
        return sample_sky_cubemap_planes(arrays.sky, rd)
    return sample_sky_cubemap_soa(arrays.sky_corners, arrays.sky.shape[1], rd, active=active)
