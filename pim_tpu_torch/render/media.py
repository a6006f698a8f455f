"""Heterogeneous participating media: null scattering and ratio tracking (SoA).

Counterpart of `pim_tpu.render.media`: constant plus fBm-noise-banded
scattering, a dual-lobe Mie phase, free-path sampling against the
majorant and ratio-tracked transmittance.  The reference's fixed-trip
`lax.scan`s are Python loops of MEDIA_STEPS and PHASE_RETRIES here.  Lanes
are masked, never compacted: every lane draws its RNG words at every step,
live or not, so each lane's stream stays the reference's.

These marches are torch ops, as they are plain XLA in the reference; no
intersection or gather kernel runs inside them.  The in-media NEE that
`scatter_ray` calls traces one any-hit ray a lane (K2 or K5).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from pim_tpu_torch.core import rng
from pim_tpu_torch.math.noise import fbm_gradient_noise3
from pim_tpu_torch.math.sampling import mie_phase, sample_free_path, sample_unit_sphere
from pim_tpu_torch.math.vec3 import EPS, V3, dot, f32, lerp, saturate, where3

MEDIA_STEPS = 32       # fixed trip count of the free-path marches
PHASE_RETRIES = 8      # fixed trip count of the phase rejection sampling


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


def media_sample(desc: MediaDesc, p: V3):
    """Scattering and extinction at [N] points: (scattering V3, extinction V3)."""
    in_band = torch.abs(p.y - desc.noise_height) <= desc.noise_range
    noise = fbm_gradient_noise3(p * desc.noise_freq, desc.noise_lacunarity, desc.noise_gain,
                                desc.noise_octaves)
    height = desc.noise_height + desc.noise_scale * noise
    dist = torch.abs(p.y - height) / f32(max(desc.noise_scale, EPS))
    density = saturate(1.0 - dist) * in_band.to(torch.float32)
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


def calc_transmittance(desc: MediaDesc, state: rng.RngState, ro: V3, rd: V3, ray_len):
    """Ratio-tracked transmittance along [N] segments: (state, V3).  One
    RNG word a step for every lane."""
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
        _, ext = media_sample(desc, ro + rd * t)
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


def scatter_ray(desc: MediaDesc, state: rng.RngState, ro: V3, rd: V3, ray_len,
                evaluate_light=None):
    """Null-scattering march along [N] segments, then phase sampling and the
    in-media NEE at the first scatter point.

    evaluate_light(state, p V3, active) -> (state, lum V3, dir V3, ok)
    supplies the NEE; `active` marks the lanes that scattered (only their
    result is used).  None skips it.  Returns (state, MediaScatter)."""
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
        atten = _attenuate(atten, ext, rcp_maj, live.to(torch.float32))
        scatter_prob = torch.maximum(scat.x, torch.maximum(scat.y, scat.z)) * rcp_maj
        state, us = rng.next_f32(state)
        does_scatter = live & (us < scatter_prob)
        spos = where3(does_scatter & ~scattered, p, spos)
        scattered = scattered | does_scatter
        live = live & ~does_scatter
        t = torch.where(live, t_new, t)

    state, new_dir, _ = sample_phase_dir(desc, state, rd)
    lum = V3.zeros(n, dev)
    if evaluate_light is not None:
        state, li, ldir, ok = evaluate_light(state, spos, scattered)
        ph = calc_phase(desc, dot(rd, ldir))
        w = ok.to(torch.float32) * scattered.to(torch.float32) * ph
        lum = atten * li * w

    ph_out = calc_phase(desc, dot(rd, new_dir))
    return state, MediaScatter(
        pos=spos,
        dir=where3(scattered, new_dir, rd),
        attenuation=where3(scattered, atten * ph_out, atten),
        luminance=lum,
        pdf=torch.where(scattered, ph_out, 0.0),
        scattered=scattered,
    )
