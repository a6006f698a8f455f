"""Heterogeneous participating media: null scattering and ratio tracking (SoA).

Counterpart of `pim_tpu.render.media`: constant plus fBm-noise-banded
scattering, a dual-lobe Mie phase, free-path sampling against the
majorant and ratio-tracked transmittance.  The reference's fixed-trip
`lax.scan`s are Python loops of MEDIA_STEPS and PHASE_RETRIES here.  Lanes
are masked, never compacted: every lane draws its RNG words at every step,
live or not, so each lane's stream stays the reference's.

Two forms compute the marches.  The plain one (`march_plain`,
`calc_transmittance_plain`) is PyTorch ops; it runs on the CPU, and on the
card wherever an input requires grad.  On CUDA tensors that carry no
gradient, `march` (which `scatter_ray` calls) and `calc_transmittance`
launch the hand-written kernels of `csrc/media.cu` instead
(`media_scatter`: the null-scattering march and the phase sampling;
`media_transmittance`: the ratio tracking), one launch a call, bit for bit
the plain form on the card.  The in-media
NEE that `scatter_ray` calls between them traces one any-hit ray a lane
(K2 or K5) and stays eager, so the intersection kernels and their counters
see it.

While the profiler traces, both forms tally each lane's density
evaluations that count (the steps at which it is still live) and those in
the noise band (where the fBm counts), and the wrappers add them up over
the lanes whose result the caller keeps (`active`): the counters that
pimbench's media_roofline bounds the kernels by.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from pim_tpu_torch import native
from pim_tpu_torch.core import profiler as prof
from pim_tpu_torch.core import rng
from pim_tpu_torch.math.noise import fbm_gradient_noise3
from pim_tpu_torch.math.sampling import (
    mie_constants,
    mie_phase,
    sample_free_path,
    sample_unit_sphere,
)
from pim_tpu_torch.math.vec3 import EPS, V3, dot, f32, lerp, saturate, where3

MEDIA_STEPS = 32       # fixed trip count of the free-path marches
PHASE_RETRIES = 8      # fixed trip count of the phase rejection sampling
MAX_OCTAVES = 16       # the kernels' octave table (csrc/media.cu kMaxOctaves)


class MediaDesc(NamedTuple):
    """The media description; every number a Python float holding a
    float32 value (noise_octaves an int)."""

    constant_mu: Tuple[float, float, float]  # scattering coefficient (constant term)
    noise_mu: Tuple[float, float, float]     # scattering coefficient (noise band term)
    absorption: float
    noise_octaves: int
    noise_gain: float
    noise_lacunarity: float
    noise_freq: float
    noise_scale: float
    noise_height: float
    noise_range: float
    rcp_majorant: float
    phase_dir_a: float
    phase_dir_b: float
    phase_blend: float


def make_media_desc(
    constant_color=(0.5, 0.5, 0.5),
    noise_color=(0.5, 0.5, 0.5),
    constant_mfp: float = 40.0e3,
    noise_mfp: float = 40.0e3,
    absorption: float = 0.1,
    noise_octaves: int = 1,
    noise_gain: float = 0.9,
    noise_lacunarity: float = 2.0666,
    noise_freq: float = 1.0,
    noise_scale: float = 1.0,
    noise_height: float = 20.0,
    phase_dir_a: float = 0.0,
    phase_dir_b: float = 0.0,
    phase_blend: float = 0.5,
) -> MediaDesc:
    """The reference's defaults; the host arithmetic is the reference's
    numpy float32 arithmetic."""
    cc = np.asarray(constant_color, np.float32)
    nc = np.asarray(noise_color, np.float32)
    c_mfp = constant_mfp * (0.5 + 1.5 * cc)  # lerp(0.5x, 2x, color)
    n_mfp = noise_mfp * (0.5 + 1.5 * nc)
    c_mu = 1.0 / c_mfp
    n_mu = 1.0 / n_mfp
    amp = sum(noise_gain**i for i in range(noise_octaves))
    noise_range = amp * noise_scale * 1.5
    a = 1.0 + absorption
    majorant = float(2.0 * a * (c_mu.max() + n_mu.max()))
    return MediaDesc(
        constant_mu=tuple(f32(v) for v in c_mu),
        noise_mu=tuple(f32(v) for v in n_mu),
        absorption=f32(absorption),
        noise_octaves=int(noise_octaves),
        noise_gain=f32(noise_gain),
        noise_lacunarity=f32(noise_lacunarity),
        noise_freq=f32(noise_freq),
        noise_scale=f32(noise_scale),
        noise_height=f32(noise_height),
        noise_range=f32(noise_range),
        rcp_majorant=f32(1.0 / majorant),
        phase_dir_a=f32(np.clip(phase_dir_a, -0.99, 0.99)),
        phase_dir_b=f32(np.clip(phase_dir_b, -0.99, 0.99)),
        phase_blend=f32(np.clip(phase_blend, 0.0, 1.0)),
    )


def in_band(desc: MediaDesc, p: V3):
    """Whether [N] points lie in the noise band, where the density can be
    above 0."""
    return torch.abs(p.y - desc.noise_height) <= desc.noise_range


def band_density(desc: MediaDesc, p: V3):
    """The noise band's density at [N] points before the band's mask: the
    part of `media_sample` that needs the fBm."""
    noise = fbm_gradient_noise3(p * desc.noise_freq, desc.noise_lacunarity, desc.noise_gain,
                                desc.noise_octaves)
    height = desc.noise_height + desc.noise_scale * noise
    dist = torch.abs(p.y - height) / f32(max(desc.noise_scale, EPS))
    return saturate(1.0 - dist)


def media_sample(desc: MediaDesc, p: V3):
    """Scattering and extinction at [N] points: (scattering V3, extinction V3)."""
    band = in_band(desc, p)
    density = band_density(desc, p) * band.to(torch.float32)
    (cx, cy, cz), (nx, ny, nz) = desc.constant_mu, desc.noise_mu
    scattering = V3(cx + nx * density, cy + ny * density, cz + nz * density)
    extinction = scattering * f32(1.0 + desc.absorption)
    return scattering, extinction


def calc_phase(desc: MediaDesc, cos_theta):
    """Dual-lobe Mie phase blend."""
    return lerp(mie_phase(cos_theta, desc.phase_dir_a), mie_phase(cos_theta, desc.phase_dir_b),
                desc.phase_blend)


def _attenuate(atten: V3, ext: V3, rcp_maj: float, m) -> V3:
    """atten * (1 + ((1 - ext / majorant) - 1) * m), per channel."""
    return V3(atten.x * (1.0 + ((1.0 - ext.x * rcp_maj) - 1.0) * m),
              atten.y * (1.0 + ((1.0 - ext.y * rcp_maj) - 1.0) * m),
              atten.z * (1.0 + ((1.0 - ext.z * rcp_maj) - 1.0) * m))


def _tally_step(tally, desc: MediaDesc, live, p: V3) -> None:
    """Adds a march step to `tally` ([2, N] int32, or None): the lanes
    whose density at p counts (live), and those of them in the band."""
    if tally is not None:
        tally[0] += live.to(torch.int32)
        tally[1] += (live & in_band(desc, p)).to(torch.int32)


def calc_transmittance_plain(desc: MediaDesc, state: rng.RngState, ro: V3, rd: V3, ray_len,
                             tally=None):
    """`calc_transmittance` composed of PyTorch ops; `tally` ([2, N] int32)
    adds up each lane's density evaluations that count, and those in the
    band."""
    rcp_maj = desc.rcp_majorant
    n = ro.x.shape[0]
    dev = ro.x.device
    t = torch.zeros((n,), dtype=torch.float32, device=dev)
    atten = V3.ones(n, dev)
    live = torch.ones((n,), dtype=torch.bool, device=dev)
    for _ in range(MEDIA_STEPS):
        state, xi = rng.next_f32(state)
        dt = sample_free_path(xi, rcp_maj)
        live = live & ((t + dt) < ray_len)
        p = ro + rd * t
        _, ext = media_sample(desc, p)
        _tally_step(tally, desc, live, p)
        atten = _attenuate(atten, ext, rcp_maj, live.to(torch.float32))
        t = t + torch.where(live, dt, 0.0)
    return state, atten


class MediaScatter(NamedTuple):
    pos: V3
    dir: V3
    attenuation: V3
    luminance: V3
    pdf: torch.Tensor        # 0 where no in-media scattering happened
    scattered: torch.Tensor  # bool


class March(NamedTuple):
    """What the null-scattering march and the phase sampling give, before
    the in-media NEE: the march's own attenuation, the first scatter point
    (the ray's origin where none), and the continuation's direction,
    attenuation and phase pdf (rd, the march's attenuation and 0 where the
    lane did not scatter)."""
    atten: V3
    pos: V3
    dir: V3
    attenuation: V3
    pdf: torch.Tensor
    scattered: torch.Tensor  # bool


def sample_phase_dir(desc: MediaDesc, state: rng.RngState, rd: V3):
    """Rejection-sample a phase-function direction with PHASE_RETRIES masked
    retries (three RNG words each): (state, dir V3, phase)."""
    n = rd.x.shape[0]
    best = rd
    best_ph = torch.ones((n,), dtype=torch.float32, device=rd.x.device)
    found = torch.zeros((n,), dtype=torch.bool, device=rd.x.device)
    for _ in range(PHASE_RETRIES):
        state, (u, v) = rng.next_f32x2(state)
        state, ur = rng.next_f32(state)
        l = sample_unit_sphere(u, v)
        ph = calc_phase(desc, dot(rd, l))
        accept = ~found & (ur <= ph)
        best = where3(accept, l, best)
        best_ph = torch.where(accept, ph, best_ph)
        found = found | accept
    return state, best, best_ph


def march_plain(desc: MediaDesc, state: rng.RngState, ro: V3, rd: V3, ray_len, tally=None):
    """The null-scattering march along [N] segments, then the phase
    sampling, composed of PyTorch ops: (state, March).  `tally` as
    `calc_transmittance_plain`'s."""
    rcp_maj = desc.rcp_majorant
    n = ro.x.shape[0]
    dev = ro.x.device
    t = torch.zeros((n,), dtype=torch.float32, device=dev)
    atten = V3.ones(n, dev)
    live = torch.ones((n,), dtype=torch.bool, device=dev)
    scattered = torch.zeros((n,), dtype=torch.bool, device=dev)
    spos = ro
    for _ in range(MEDIA_STEPS):
        state, xi = rng.next_f32(state)
        t_new = t + sample_free_path(xi, rcp_maj)
        live = live & (t_new < ray_len)
        p = ro + rd * t_new
        scat, ext = media_sample(desc, p)
        _tally_step(tally, desc, live, p)
        atten = _attenuate(atten, ext, rcp_maj, live.to(torch.float32))
        scatter_prob = torch.maximum(scat.x, torch.maximum(scat.y, scat.z)) * rcp_maj
        state, us = rng.next_f32(state)
        does_scatter = live & (us < scatter_prob)
        spos = where3(does_scatter & ~scattered, p, spos)
        scattered = scattered | does_scatter
        live = live & ~does_scatter
        t = torch.where(live, t_new, t)

    state, new_dir, _ = sample_phase_dir(desc, state, rd)
    ph_out = calc_phase(desc, dot(rd, new_dir))
    return state, March(atten=atten, pos=spos, dir=where3(scattered, new_dir, rd),
                        attenuation=where3(scattered, atten * ph_out, atten),
                        pdf=torch.where(scattered, ph_out, 0.0), scattered=scattered)


# ---------------------------------------------------------------------------
# The kernels (csrc/media.cu) and the dispatch between them and the plain form
# ---------------------------------------------------------------------------

_F32, _I64 = torch.float32, torch.int64
# the [N] inputs of both kernels, in the order of csrc/media.cu's LaneArgs
LANE_FIELDS = (*((f"ro.{c}", _F32) for c in "xyz"), *((f"rd.{c}", _F32) for c in "xyz"),
               ("ray_len", _F32), *((f"state.{c}", _I64) for c in "xyzw"))


def octave_table(desc: MediaDesc):
    """([MAX_OCTAVES] frequencies, [MAX_OCTAVES] amplitudes) of the fBm's
    octaves, each rounded to float32 as `fbm_gradient_noise3`'s loop
    rounds them (unused entries 0)."""
    if not 0 <= desc.noise_octaves <= MAX_OCTAVES:
        raise ValueError(f"noise_octaves {desc.noise_octaves}: the media kernels take 0 to "
                         f"{MAX_OCTAVES}")
    freqs, ampls = [0.0] * MAX_OCTAVES, [0.0] * MAX_OCTAVES
    freq = ampl = 1.0
    for i in range(desc.noise_octaves):
        freqs[i], ampls[i] = freq, ampl
        freq = f32(freq * desc.noise_lacunarity)
        ampl = f32(ampl * desc.noise_gain)
    return freqs, ampls


def kernel_constants(desc: MediaDesc) -> list:
    """The medium's float32 constants in csrc/media.cu's `Medium` order,
    each the value the plain form's op uses (a tensor over a Python
    constant is a product with the constant's float32 reciprocal)."""
    rcp_scale = float(np.float32(1.0) / np.float32(f32(max(desc.noise_scale, EPS))))
    freqs, ampls = octave_table(desc)
    return [*desc.constant_mu, *desc.noise_mu, f32(1.0 + desc.absorption), desc.noise_freq,
            desc.noise_height, desc.noise_range, desc.noise_scale, rcp_scale,
            desc.rcp_majorant, *mie_constants(desc.phase_dir_a),
            *mie_constants(desc.phase_dir_b), desc.phase_blend, *freqs, *ampls]


def lane_fields(ro: V3, rd: V3, ray_len, state: rng.RngState) -> list:
    """The kernels' [N] inputs in LANE_FIELDS' order."""
    return [*ro, *rd, ray_len, *state]


def takes_kernels(fields) -> bool:
    """Whether a march takes the kernels: its tensors lie on the card and
    none requires grad (autograd differentiates the plain form)."""
    return all(t.device.type == "cuda" for t in fields) and not any(
        t.requires_grad for t in fields)


def _launch_args(name: str, desc: MediaDesc, fields):
    """(N, device, the pointer table, the constants) of a kernel call; raises
    unless every field is a contiguous [N] tensor of its dtype on one CUDA
    device."""
    fields = [t.contiguous() for t in fields]
    if fields[0].dim() != 1:
        raise ValueError(f"{name}.ro.x: expected [N], got {tuple(fields[0].shape)}")
    n, dev = fields[0].shape[0], fields[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
    for (field, dtype), t in zip(LANE_FIELDS, fields):
        native.require_cuda(f"{name}.{field}", t, dtype, (n,), dev)
    consts = kernel_constants(desc)
    consts = (ctypes.c_float * len(consts))(*consts)
    return n, dev, (ctypes.c_void_p * len(fields))(*(t.data_ptr() for t in fields)), consts


def _tally_ptr(tally, n: int, dev) -> int:
    """The kernels' tally pointer: 0, or `tally`'s once it is checked."""
    if tally is None:
        return 0
    native.require_cuda("media.tally", tally, torch.int32, (2, n), dev)
    return tally.data_ptr()


def media_scatter(desc: MediaDesc, fields, tally=None):
    """The scatter kernel over LANE_FIELDS' [N] CUDA tensors: (out, scattered,
    words).  out [13, N] f32 holds the march's attenuation, the scatter
    point, the continuation's direction, attenuation and pdf (`March`'s
    order); scattered [N] bool; words [4, N] int64 the new RNG state.
    `tally` ([2, N] int32 or None) is overwritten with what
    `march_plain`'s adds up."""
    n, dev, table, consts = _launch_args("media_scatter", desc, fields)
    out = torch.empty((13, n), dtype=_F32, device=dev)
    scattered = torch.empty((n,), dtype=torch.bool, device=dev)
    words = torch.empty((4, n), dtype=_I64, device=dev)
    if n == 0:
        return out, scattered, words
    lib = native.load()
    rc = lib.pim_media_scatter(table, consts, desc.noise_octaves, n, out.data_ptr(),
                               scattered.data_ptr(), words.data_ptr(),
                               _tally_ptr(tally, n, dev), native.stream_ptr(dev))
    native.check(lib, rc, "media_scatter")
    native.launches["media_scatter"] += 1
    return out, scattered, words


def media_transmittance(desc: MediaDesc, fields, tally=None):
    """The transmittance kernel over LANE_FIELDS' [N] CUDA tensors: (out
    [3, N] f32, the transmittance; words [4, N] int64, the new RNG state).
    `tally` as `media_scatter`'s."""
    n, dev, table, consts = _launch_args("media_transmittance", desc, fields)
    out = torch.empty((3, n), dtype=_F32, device=dev)
    words = torch.empty((4, n), dtype=_I64, device=dev)
    if n == 0:
        return out, words
    lib = native.load()
    rc = lib.pim_media_transmittance(table, consts, desc.noise_octaves, n, out.data_ptr(),
                                     words.data_ptr(), _tally_ptr(tally, n, dev),
                                     native.stream_ptr(dev))
    native.check(lib, rc, "media_transmittance")
    native.launches["media_transmittance"] += 1
    return out, words


def _new_tally(ro: V3, kernel: bool):
    """A [2, N] int32 tally while the profiler traces, else None (zeros for
    the plain form, which adds into it; the kernels overwrite it)."""
    if not prof.tracing():
        return None
    make = torch.empty if kernel else torch.zeros
    return make((2, ro.x.shape[0]), dtype=torch.int32, device=ro.x.device)


def _count(kernel: bool, march_name: str, n: int, tally, active, live_counter: str,
           scattered=None) -> None:
    """The counters of a march of n lanes: `media.calls`, `.kernel`, the
    lanes handed (`media.<march>_lanes`), the lanes whose result is used
    (`active`, every lane where None: `live_counter`) and, from the
    march's `tally`, their density evaluations that count
    (`media.<march>_steps`) and those in the band (`media.<march>_band`);
    with `scattered`, those of the lanes that scattered
    (`media.scattered`).  Their sums launch in the span `pt.media.count`,
    so that `pt.media` and `pt.media.tr` hold the marches' own work."""
    if tally is None:
        return
    prof.count("media.calls", 1)
    prof.count("media.kernel", int(kernel))
    prof.count(f"media.{march_name}_lanes", n)
    with prof.span("pt.media.count"):
        if active is None:
            prof.count(live_counter, n)
            per = tally.sum(1)
        else:
            prof.count(live_counter, active.sum())
            per = (tally * active).sum(1)
        prof.count(f"media.{march_name}_steps", per[0])
        prof.count(f"media.{march_name}_band", per[1])
        if scattered is not None:
            used = scattered if active is None else scattered & active
            prof.count("media.scattered", used.sum())


def calc_transmittance(desc: MediaDesc, state: rng.RngState, ro: V3, rd: V3, ray_len,
                       active=None):
    """Ratio-tracked transmittance along [N] segments: (state, V3).  One
    RNG word a step for every lane.  One `media_transmittance` launch where
    `takes_kernels`, else the plain form.  `active` ([N] bool, None for
    all) marks the lanes whose transmittance the caller uses; it only
    feeds the counters (`media.tr_live`, `media.tr_steps`,
    `media.tr_band`)."""
    fields = lane_fields(ro, rd, ray_len, state)
    kernel = takes_kernels(fields)
    tally = _new_tally(ro, kernel)
    with prof.span("pt.media.tr"):
        if not kernel:
            state, tr = calc_transmittance_plain(desc, state, ro, rd, ray_len, tally)
        else:
            out, words = media_transmittance(desc, fields, tally)
            state, tr = rng.RngState(*words), V3(out[0], out[1], out[2])
        _count(kernel, "tr", ro.x.shape[0], tally, active, "media.tr_live")
    return state, tr


def march(desc: MediaDesc, state: rng.RngState, ro: V3, rd: V3, ray_len, active=None):
    """The null-scattering march along [N] segments and the phase sampling
    at its scatter points: (state, March).  One `media_scatter` launch where
    `takes_kernels`, else `march_plain`.  `active` as
    `calc_transmittance`'s; its lanes are `media.lanes`, those of them
    that scattered `media.scattered`."""
    fields = lane_fields(ro, rd, ray_len, state)
    kernel = takes_kernels(fields)
    tally = _new_tally(ro, kernel)
    if not kernel:
        state, m = march_plain(desc, state, ro, rd, ray_len, tally)
    else:
        out, scattered, words = media_scatter(desc, fields, tally)
        state, m = rng.RngState(*words), March(
            *(V3(out[k], out[k + 1], out[k + 2]) for k in (0, 3, 6, 9)), pdf=out[12],
            scattered=scattered)
    _count(kernel, "march", ro.x.shape[0], tally, active, "media.lanes", m.scattered)
    return state, m


def scatter_ray(desc: MediaDesc, state: rng.RngState, ro: V3, rd: V3, ray_len,
                evaluate_light=None, active=None):
    """Null-scattering march along [N] segments, then phase sampling and the
    in-media NEE at the first scatter point.

    evaluate_light(state, p V3, active) -> (state, lum V3, dir V3, ok)
    supplies the NEE; `active` marks the lanes that scattered (only their
    result is used).  None skips it.  The march and the phase sampling are
    `march` (one kernel launch on the card); `active` as `march`'s.
    Returns (state, MediaScatter)."""
    with prof.span("pt.media"):
        state, m = march(desc, state, ro, rd, ray_len, active)
        lum = V3.zeros(ro.x.shape[0], ro.x.device)
    if evaluate_light is not None:
        state, li, ldir, ok = evaluate_light(state, m.pos, m.scattered)
        with prof.span("pt.media"):
            ph = calc_phase(desc, dot(rd, ldir))
            w = ok.to(torch.float32) * m.scattered.to(torch.float32) * ph
            lum = m.atten * li * w
    return state, MediaScatter(pos=m.pos, dir=m.dir, attenuation=m.attenuation, luminance=lum,
                               pdf=m.pdf, scattered=m.scattered)
