"""Physically-based sky: the Rayleigh/Mie single-scattering bake and the
cubemap fetch (K6, or K7 on the differentiable path).

Counterpart of `pim_tpu.render.sky`.  The bake marches every texel's view
ray in fixed steps (the reference's masked `lax.scan`) with a 96-step sun
march from each view sample.  Two forms compute it, dispatched on the
directions' device.  On a CUDA card, `atmosphere` launches csrc/sky.cu's
`sky_bake` (one block a direction; the march positions formed in the
kernel, the cube's directions cached on the device, so a bake neither
copies nor syncs) and, for the sun's direction and luminance given as
tensors that require grad, its hand-written backward (`sky_bake_bwd`,
forward-mode tangents of each sun march, and `sky_grad_sum`, the
directions summed in a fixed order).  On the CPU it runs
`atmosphere_plain`, PyTorch ops: a Python loop over the view steps, each
step's sun march all at once with its liveness as a running product, the
step positions the reference's repeated float32 sums, formed on the host;
autograd differentiates it, recomputing each view step's sun march in the
backward (`torch.utils.checkpoint`) instead of keeping its [96, 6*S*S]
intermediates.  On the card the two agree bit for bit (the kernels add a
sun march's 96 steps in torch.sum's order, `torch_sum_split`;
tests/test_torch_sky_card.py); `atmosphere_plain_vjp` is the backward's
arithmetic in plain ops, for the CPU tests.

The cubemap [6, S, S, 3] is fetched through K6 with C = 3 from [12, 6*S*S]
corner planes (`sky_corner_planes`, the reference's slice-shifts, clamped
at each face edge), or, on the differentiable path, by its four corners
through ONE K7 call on the [3, 6*S*S] cube planes and the JAX package's
lerp form.  The reflection probes read their own cubes with
`sample_sky_cubemap`, the reference's AoS fetch as plain torch ops (the
reference runs it as XLA ops too, outside Pallas).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from pim_tpu_torch import native
from pim_tpu_torch.core import profiler as prof
from pim_tpu_torch.math.sampling import _RAYLEIGH_K, mie_constants, mie_phase, rayleigh_phase
from pim_tpu_torch.math.vec3 import EPS, EPS_SQ, V3, f32
from pim_tpu_torch.render.table_gather import gather_bilinear, gather_texels

# fixed trip counts of the masked marches (the reference's; SUN_STEPS is
# csrc/sky.cu's kSunSteps too)
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


def _march_step(sky: SkyMedium, steps: int) -> np.float32:
    """The march's step length (the reference's)."""
    majorant = np.float32(max(sky.mu_m, max(sky.mu_r))) * np.float32(steps)
    return np.float32(-np.log(np.float32(0.5))) / majorant


def _components(x):
    """3 floats (a float is repeated), or the 3 elements of a [3] tensor."""
    if isinstance(x, torch.Tensor):
        return [x[i] for i in range(3)]
    a = np.asarray(x, np.float32)
    return [float(a)] * 3 if a.ndim == 0 else [float(v) for v in a]


def _density(sky: SkyMedium, px, py, pz):
    """(squared norm, h, rayleigh density, mie density) at the points."""
    # |p| - r_crust cancels ~7 digits at the crust.  The squared norm is
    # formed as the reference's compiled code forms it, with fused
    # multiply-adds (x*x, then fma(y, y, .), then fma(z, z, .)), done
    # exactly in float64 and rounded once each; separate float32 ops
    # move h by ~0.5 m and the bake by up to 5e-5.
    s = ((px * px).double() + py.double() * py.double()).float()
    s = (s.double() + pz.double() * pz.double()).float()
    h = torch.sqrt(torch.clamp_min(s, EPS)) - float(sky.r_crust)
    dr = torch.exp(torch.clamp_max(-h * sky.rho_r, 0.0))
    dm = torch.exp(torch.clamp_max(-h * sky.rho_m, 0.0))
    return s, h, dr, dm


def atmosphere(sky: SkyMedium, ro, rd: V3, light_dir, luminance, steps: int) -> V3:
    """Single-scatter march.  ro: 3 floats (planet centre at the origin);
    rd: V3 of [D] unit directions; light_dir: 3 floats or a [3] tensor;
    luminance: a float, 3 floats or a [3] tensor.  Returns V3 [D],
    differentiable in the tensors given.

    Directions on a CUDA card take csrc/sky.cu's kernels (one launch, two
    more for the backward), bit for bit the plain form there; directions
    on the CPU the plain form (`atmosphere_plain`)."""
    kernel = rd.x.device.type == "cuda"
    if prof.tracing():
        prof.count("sky.calls", 1)
        prof.count("sky.kernel", int(kernel))
    if not kernel:
        return atmosphere_plain(sky, ro, rd, light_dir, luminance, steps)
    dev = rd.x.device
    out = _Atmosphere.apply(rd.x, rd.y, rd.z, _device3(light_dir, dev),
                            _device3(luminance, dev), sky_consts(sky, ro, steps),
                            steps_to_trips(steps))
    return V3(out[0], out[1], out[2])


def atmosphere_plain(sky: SkyMedium, ro, rd: V3, light_dir, luminance, steps: int) -> V3:
    """`atmosphere` composed of PyTorch ops: the view steps a Python loop,
    each step's sun march all at once, with its liveness as a running
    product; differentiable by autograd."""
    dev = rd.x.device
    ld = _components(light_dir)
    lum = _components(luminance)
    mfp = _march_step(sky, steps)
    mfp_f = float(mfp)
    t_sun = torch.from_numpy(_march_positions(mfp, SUN_STEPS)).to(dev)[:, None]  # [96, 1]
    sun_x = t_sun * ld[0]
    sun_y = t_sun * ld[1]
    sun_z = t_sun * ld[2]
    recompute = sun_x.requires_grad and torch.is_grad_enabled()

    def sun_march(px, py, pz):
        """Optical depth toward the sun from each [D] point, all steps at once."""
        _, h, dr, dm = _density(sky, px[None, :] + sun_x, py[None, :] + sun_y,
                                pz[None, :] + sun_z)
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
        _, h, dr, dm = _density(sky, px, py, pz)
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


def atmosphere_plain_vjp(sky: SkyMedium, ro, rd: V3, light_dir, luminance, steps: int,
                         grad: V3):
    """d <grad, atmosphere(...)> / d (light_dir, luminance): two [3] float64
    tensors, by the arithmetic of csrc/sky.cu's backward in plain PyTorch
    ops: the float32 march as `atmosphere_plain` forms it, and float64
    forward-mode tangents of each sun march in the three components of the
    sun's direction (a clamp passes the gradient where its bound does not
    act, a liveness mask passes none, as autograd of the plain form)."""
    dev = rd.x.device
    ld = [float(v) for v in _components(light_dir)]
    lum = [float(v) for v in _components(luminance)]
    mfp = _march_step(sky, steps)
    mfp_f = float(mfp)
    t_sun = torch.from_numpy(_march_positions(mfp, SUN_STEPS)).to(dev)[:, None]
    g = [c.double() for c in grad]
    d = rd.x.shape[0]
    zeros = torch.zeros(d, dtype=torch.float32, device=dev)
    od_r_v, od_m_v = zeros, zeros
    live = torch.ones(d, dtype=torch.bool, device=dev)

    cos_theta = rd.x * ld[0] + rd.y * ld[1] + rd.z * ld[2]
    ph_r = rayleigh_phase(cos_theta).double()
    ph_m = mie_phase(cos_theta, sky.g_m).double()
    w = [g[c] * lum[c] for c in range(3)]
    pr = [w[c] * sky.mu_r[c] * ph_r for c in range(3)]
    pm = [w[c] * sky.mu_m * ph_m for c in range(3)]
    tr_r = [zeros.double()] * 3
    tr_m = [zeros.double()] * 3
    by_ld = [zeros.double()] * 3  # through the transmittances

    ox, oy, oz = (float(c) for c in ro)
    for t_v in _march_positions(mfp, steps_to_trips(steps)).tolist():
        px, py, pz = ox + rd.x * t_v, oy + rd.y * t_v, oz + rd.z * t_v
        _, h, dr, dm = _density(sky, px, py, pz)
        live = live & (h >= 0.0) & ((dr + dm) >= _MIN_DENSITY)
        od_r_i = dr * mfp_f
        od_m_i = dm * mfp_f
        od_r_v = od_r_v + torch.where(live, od_r_i, 0.0)
        od_m_v = od_m_v + torch.where(live, od_m_i, 0.0)

        q = [px[None, :] + t_sun * ld[0], py[None, :] + t_sun * ld[1], pz[None, :] + t_sun * ld[2]]
        s, hs, drs, dms = _density(sky, *q)
        crust = hs < 0.0
        step_live = torch.cumprod((~crust & ((drs + dms) >= _MIN_DENSITY)).to(torch.int32),
                                  dim=0) > 0
        live_before = torch.cat([torch.ones_like(step_live[:1]), step_live[:-1]], dim=0)
        od_r_l = torch.sum(torch.where(step_live, drs * mfp_f, 0.0), dim=0)
        od_m_l = torch.sum(torch.where(step_live, dms * mfp_f, 0.0), dim=0)
        hit_crust = torch.any(live_before & crust, dim=0)
        # dh / d light_dir[j] = q_j t / |q|, where the norm's clamp passes
        root = torch.sqrt(torch.clamp_min(s, EPS)).double()
        dh = torch.where(s >= EPS, t_sun.double() / root, 0.0) * step_live
        gr = torch.where(-hs * sky.rho_r <= 0.0, -sky.rho_r * drs.double(), 0.0) * mfp_f * dh
        gm = torch.where(-hs * sky.rho_m <= 0.0, -sky.rho_m * dms.double(), 0.0) * mfp_f * dh
        t_r = [torch.sum(gr * qj.double(), dim=0) for qj in q]
        t_m = [torch.sum(gm * qj.double(), dim=0) for qj in q]

        m = (live & ~hit_crust).to(torch.float32)
        a_r = od_r_v + od_r_l
        a_m = od_m_v + od_m_l
        for c in range(3):
            tr_i = torch.exp(-(sky.mu_r[c] * a_r + sky.mu_m * a_m))
            tr_r[c] = tr_r[c] + (tr_i * (od_r_i * m)).double()
            tr_m[c] = tr_m[c] + (tr_i * (od_m_i * m)).double()
            k = -tr_i.double() * (pr[c] * od_r_i.double() + pm[c] * od_m_i.double()) * m.double()
            for j in range(3):
                by_ld[j] = by_ld[j] + k * (sky.mu_r[c] * t_r[j] + sky.mu_m * t_m[j])

    # the phases' derivatives in cos_theta
    cs = cos_theta.double()
    dph_r = _RAYLEIGH_K * 2.0 * cs
    k_mie, a_mie, b_mie = mie_constants(sky.g_m)
    l0 = a_mie - b_mie * cos_theta
    root = torch.sqrt(torch.clamp_min(l0, EPS_SQ))
    l = l0 * root
    lc = torch.clamp_min(l, EPS).double()
    dl = -b_mie * (root.double() + torch.where(l0 >= EPS_SQ, l0.double() / (2.0 * root.double()),
                                               0.0))
    dl = torch.where(l >= EPS, dl, 0.0)
    dph_m = k_mie * (2.0 * cs / lc - (1.0 + cs * cs) / (lc * lc) * dl)
    by_cos = sum(w[c] * (tr_r[c] * sky.mu_r[c] * dph_r + tr_m[c] * sky.mu_m * dph_m)
                 for c in range(3))
    g_ld = torch.stack([torch.sum(by_ld[j] + by_cos * r.double()) for j, r in enumerate(rd)])
    g_lum = torch.stack([torch.sum(g[c] * (tr_r[c] * sky.mu_r[c] * ph_r
                                           + tr_m[c] * sky.mu_m * ph_m)) for c in range(3)])
    return g_ld, g_lum


# ---------------------------------------------------------------------------
# The kernels (csrc/sky.cu)
# ---------------------------------------------------------------------------

# the float32 constants the kernels take, in csrc/sky.cu's Consts order
SKY_CONSTS = ("ox", "oy", "oz", "mfp", "r_crust", "rho_r", "rho_m", "mu_r.x", "mu_r.y", "mu_r.z",
              "mu_m", "k_ray", "k_mie", "a_mie", "b_mie", "eps", "eps_sq", "min_density")
_MAX_DIRECTIONS = 2**31 - 1  # one block a direction


def torch_sum_split(n: int) -> int:
    """How torch.sum over dim 0 of a contiguous float32 [96, n] CUDA tensor
    (the plain sun march's optical depths) splits each output's 96 steps
    over a block's threads (ATen's Reduce.cuh, setReduceConfig): with the
    outputs vectorized by 4 (n a multiple of 4) and at least 32 vectors, a
    block is 32 x 4 threads and the 4 rows share the steps (16 or more
    values each); else one thread sums them all.  The kernels add in the
    same order."""
    return 4 if n % 4 == 0 and n // 4 >= 32 else 1


def sky_consts(sky: SkyMedium, ro, steps: int):
    """SKY_CONSTS of a march from `ro` (3 floats), as the kernels take them."""
    vals = (*(float(c) for c in ro), float(_march_step(sky, steps)), sky.r_crust, sky.rho_r,
            sky.rho_m, *sky.mu_r, sky.mu_m, _RAYLEIGH_K, *mie_constants(sky.g_m), EPS, EPS_SQ,
            _MIN_DENSITY)
    return (ctypes.c_float * len(SKY_CONSTS))(*vals)


def _device3(x, dev: torch.device) -> torch.Tensor:
    """A [3] tensor as given, or 3 floats (a float repeated) copied to `dev`."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(_components(x), dtype=torch.float32, device=dev)


def _kernel_inputs(name: str, rd: V3, ld: torch.Tensor, lum: torch.Tensor, trips: int) -> int:
    """The number of directions; raises unless every input is what the
    kernels take: contiguous float32 [D] directions that carry no gradient
    and [3] sun direction and luminance, all on one CUDA device, and 1 to
    1,024 view steps."""
    dev = rd.x.device
    if rd.x.dim() != 1:
        raise ValueError(f"{name}.rd.x: expected [D], got {tuple(rd.x.shape)}")
    n = rd.x.shape[0]
    for c, t in zip("xyz", rd):
        native.require_cuda(f"{name}.rd.{c}", t, torch.float32, (n,), dev)
        if t.requires_grad:
            raise ValueError(f"{name}.rd.{c}: the kernels give no gradient in the directions")
    native.require_cuda(f"{name}.light_dir", ld, torch.float32, (3,), dev)
    native.require_cuda(f"{name}.luminance", lum, torch.float32, (3,), dev)
    if not 1 <= trips <= 1024:
        raise ValueError(f"{name}: {trips} view steps, expected 1 to 1024")
    if n > _MAX_DIRECTIONS:
        raise ValueError(f"{name}: {n} directions, at most {_MAX_DIRECTIONS}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernels take CUDA tensors, got {dev}")
    return n


def sky_bake(rd: V3, ld: torch.Tensor, lum: torch.Tensor, consts, trips: int) -> torch.Tensor:
    """The forward kernel: [3, D] float32, `atmosphere` of the directions rd
    (V3 of [D]) for the sun direction ld [3] and luminance lum [3]; consts
    from `sky_consts`, trips from `steps_to_trips`."""
    n = _kernel_inputs("sky_bake", rd, ld, lum, trips)
    dev = rd.x.device
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = native.load()
    rc = lib.pim_sky_bake(rd.x.data_ptr(), rd.y.data_ptr(), rd.z.data_ptr(), ld.data_ptr(),
                          lum.data_ptr(), consts, trips, torch_sum_split(n), n, out.data_ptr(),
                          native.stream_ptr(dev))
    native.check(lib, rc, "sky_bake")
    native.launches["sky_bake"] += 1
    return out


def sky_bake_bwd(rd: V3, ld: torch.Tensor, lum: torch.Tensor, consts, trips: int,
                 grad: torch.Tensor) -> torch.Tensor:
    """The backward kernels: [6] float32, d <grad, sky_bake(...)> / d (ld,
    lum) for grad [3, D]; a partial gradient a direction, then their sum in
    a fixed order (no float atomics: two calls give the same bits)."""
    n = _kernel_inputs("sky_bake_bwd", rd, ld, lum, trips)
    dev = rd.x.device
    native.require_cuda("sky_bake_bwd.grad", grad, torch.float32, (3, n), dev)
    if n == 0:
        return torch.zeros(6, dtype=torch.float32, device=dev)
    partial = torch.empty((n, 6), dtype=torch.float64, device=dev)
    out = torch.empty(6, dtype=torch.float32, device=dev)
    lib = native.load()
    stream = native.stream_ptr(dev)
    rc = lib.pim_sky_bake_bwd(rd.x.data_ptr(), rd.y.data_ptr(), rd.z.data_ptr(), ld.data_ptr(),
                              lum.data_ptr(), consts, trips, torch_sum_split(n), n,
                              grad.data_ptr(), partial.data_ptr(), stream)
    native.check(lib, rc, "sky_bake_bwd")
    native.launches["sky_bake_bwd"] += 1
    rc = lib.pim_sky_grad_sum(partial.data_ptr(), n, out.data_ptr(), stream)
    native.check(lib, rc, "sky_grad_sum")
    native.launches["sky_grad_sum"] += 1
    return out


class _Atmosphere(torch.autograd.Function):
    """`sky_bake`, differentiable in the sun direction and luminance by
    `sky_bake_bwd`."""

    @staticmethod
    def forward(ctx, rx, ry, rz, ld, lum, consts, trips):
        ctx.save_for_backward(rx, ry, rz, ld, lum)
        ctx.consts, ctx.trips = consts, trips
        return sky_bake(V3(rx, ry, rz), ld, lum, consts, trips)

    @staticmethod
    def backward(ctx, grad):
        rx, ry, rz, ld, lum = ctx.saved_tensors
        g = sky_bake_bwd(V3(rx, ry, rz), ld, lum, ctx.consts, ctx.trips, grad.contiguous())
        need = ctx.needs_input_grad
        return None, None, None, g[:3] if need[3] else None, g[3:] if need[4] else None, None, None


def earth_sky(ro, rd: V3, light_dir, luminance, steps: int, sky: SkyMedium = None) -> V3:
    """The atmosphere seen from `ro` (3 floats) above the north pole's
    surface: `atmosphere` with the origin moved up by the crust radius.
    The port's frames read the baked cube instead (K6)."""
    if sky is None:
        sky = earth_atmosphere()
    o = np.asarray(_components(ro), np.float32) + np.float32([0.0, 1.0, 0.0]) * np.float32(
        sky.r_crust)
    return atmosphere(sky, [float(c) for c in o], rd, light_dir, luminance, steps)


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


_cube_dirs: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def cube_dirs(size: int, device) -> torch.Tensor:
    """`cubemap_dirs(size)` as [3, 6*size*size] planes on `device`, copied
    there once a (size, device): a bake on the card copies nothing."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    dirs = _cube_dirs.get((size, dev))
    if dirs is None:
        dirs = torch.from_numpy(np.ascontiguousarray(cubemap_dirs(size).reshape(-1, 3).T)).to(dev)
        _cube_dirs[(size, dev)] = dirs
    return dirs


def bake_sky_cubemap(sky: SkyMedium, sun_dir, sun_lum, size: int, steps: int,
                     device="cpu") -> torch.Tensor:
    """[6, size, size, 3] radiance cubemap, baked on `device` (the view
    rays start at the crust, at the north pole).  sun_dir: 3 floats or a
    [3] tensor (normalized here); sun_lum: a float, 3 floats or a [3]
    tensor.  Differentiable in the tensors given."""
    dirs = cube_dirs(size, device)
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
