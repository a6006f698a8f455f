"""Reflection-probe cubemaps: a progressive path-traced bake and the GGX
prefilter.

Counterpart of `pim_tpu.render.cubemap`:
- `bake_step`: a tent-jittered direction a texel, one path-traced sample
  each (one `trace_rays` call over all 6*size*size texels), EMA-blended
  into the mip-0 `color` planes;
- `convolve` / `prefilter_mip`: the split-sum N = V GGX prefilter of the
  mip chain (roughness m / maxMip), a Hammersley half-vector set rotated
  per progressive step, each sample one AoS bilinear read of `color`
  (`sky.sample_sky_cubemap`) for every texel;
- `read_convolved`: a trilinear-clamp read with a fractional mip;
- `CubemapRegistry`: the host-side name -> probe table, one module global
  (`get_registry`) as in the reference.

All of it is torch ops on the probe's device; the path tracing goes
through the scene's kernels.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pim_tpu_torch.core import rng
from pim_tpu_torch.math.sampling import hammersley_2d, sample_ggx_microfacet, tbn_to_world
from pim_tpu_torch.math.vec3 import V3, dot, normalize, reflect
from pim_tpu_torch.render.integrator import trace_rays
from pim_tpu_torch.render.sky import _FORWARDS, _RIGHTS, _UPS, sample_sky_cubemap

BAKE_SEED = 0x0C0B0E00
PREFILTER_SEED = 0x0C0B0E01  # + the mip


def calc_mip_count(size: int) -> int:
    """The log2 chain length."""
    return max(int(size).bit_length(), 1)


def mip_to_roughness(mip, max_mip: float):
    return mip / max_mip


def roughness_to_mip(roughness, max_mip: float):
    return roughness * max_mip


class Cubemap(NamedTuple):
    """A probe: raw radiance and its GGX-prefiltered mip chain."""

    color: torch.Tensor             # [6, S, S, 3] path-traced radiance
    mips: Tuple[torch.Tensor, ...]  # [6, S>>m, S>>m, 3] for each mip m

    @property
    def size(self) -> int:
        return self.color.shape[1]

    @property
    def mip_count(self) -> int:
        return len(self.mips)


def cubemap_new(size: int, device="cuda") -> Cubemap:
    """A zeroed probe with its full mip chain."""
    mips = tuple(
        torch.zeros((6, max(size >> m, 1), max(size >> m, 1), 3), dtype=torch.float32,
                    device=device)
        for m in range(calc_mip_count(size)))
    return Cubemap(color=torch.zeros((6, size, size, 3), dtype=torch.float32, device=device),
                   mips=mips)


def calc_dirs_jittered(size: int, xi: torch.Tensor) -> torch.Tensor:
    """Per-texel outward directions with a [-1, 1] subpixel jitter: xi
    [6*size*size, 2] -> [6*size*size, 3] unit directions."""
    ts = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    u, v = np.meshgrid(ts, ts, indexing="xy")
    uv = np.stack(
        [np.broadcast_to(u, (6, size, size)), np.broadcast_to(v, (6, size, size))],
        axis=-1,
    ).reshape(-1, 2)
    dev = xi.device

    def host(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    uv = host(uv) + xi * (2.0 / size)
    fwd = host(np.repeat(_FORWARDS, size * size, axis=0))
    right = host(np.repeat(_RIGHTS, size * size, axis=0))
    up = host(np.repeat(_UPS, size * size, axis=0))
    dirs = fwd + right * uv[:, :1] + up * uv[:, 1:2]
    return normalize(V3.from_aos(dirs)).aos()


def _tent(x):
    """[0, 1) -> [-1, 1], tent-distributed (sign(0) = 0)."""
    t = 2.0 * x - 1.0
    return torch.sign(t) * (1.0 - torch.sqrt(torch.clamp_min(1.0 - torch.abs(t), 0.0)))


def bake_step(meta, arrays, lights, cm: Cubemap, origin, sample_idx: int, weight: float,
              max_bounces: int = 4) -> Cubemap:
    """One progressive bake pass: path-trace every texel once from `origin`
    and EMA-blend with `weight` (typically 1/sampleCount)."""
    size = cm.size
    n = 6 * size * size
    dev = cm.color.device
    state = rng.make_state(torch.arange(n, device=dev), int(sample_idx) & rng.MASK32,
                           seed=BAKE_SEED)
    state, (x1, x2) = rng.next_f32x2(state)
    xi = torch.stack([_tent(x1), _tent(x2)], dim=-1)
    dirs = calc_dirs_jittered(size, xi)
    o = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    # the ray kernels take dense component rows
    ro = V3(*(o[i].expand(n).contiguous() for i in range(3)))
    rd = V3(*(dirs[:, i].contiguous() for i in range(3)))
    res = trace_rays(meta, arrays, lights, ro, rd, state, max_bounces)
    new = res.color.reshape(6, size, size, 3)
    return cm._replace(color=cm.color + (new - cm.color) * weight)


def prefilter_mip(color: torch.Tensor, mip: int, max_mip: float, sample_count: int,
                  sample_idx: int) -> torch.Tensor:
    """The split-sum N = V GGX prefilter of one mip from the mip-0 `color`
    [6, S, S, 3]: a Hammersley half-vector set with a per-step
    Cranley-Patterson rotation of both strata, each texel's normal
    tent-jittered per step."""
    size = color.shape[1]
    msize = max(size >> mip, 1)
    n = 6 * msize * msize
    dev = color.device
    st = rng.make_state(torch.arange(n, device=dev), int(sample_idx) & rng.MASK32,
                        seed=PREFILTER_SEED + mip)
    st, (jx, jy) = rng.next_f32x2(st)
    xi = torch.stack([_tent(jx), _tent(jy)], dim=-1)
    nrm = V3.from_aos(calc_dirs_jittered(msize, xi))

    roughness = mip_to_roughness(float(mip), max_mip)
    alpha = max(roughness * roughness, 1e-3)

    i = torch.arange(sample_count, dtype=torch.int64, device=dev)
    u, v = hammersley_2d(i, sample_count)
    s_idx = torch.tensor(float(sample_idx), dtype=torch.float32, device=dev)
    u = torch.remainder(u + s_idx * 0.61803398875, 1.0)
    v = torch.remainder(v + s_idx * 0.7548776662466927, 1.0)

    ones = torch.ones_like(nrm.x)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    wacc = torch.zeros((n,), dtype=torch.float32, device=dev)
    for k in range(sample_count):
        h_ts = sample_ggx_microfacet(u[k], v[k], alpha)
        h = tbn_to_world(nrm, V3(h_ts.x * ones, h_ts.y * ones, h_ts.z * ones))
        l = reflect(-nrm, h)  # I = -N (split-sum N = V), L = reflect(I, H)
        nol = dot(l, nrm)
        w = torch.where(nol > 0.0, nol, 0.0)
        acc = acc + sample_sky_cubemap(color, l.aos()) * w[:, None]
        wacc = wacc + w
    out = acc / torch.clamp_min(wacc, 1e-6)[:, None]
    return out.reshape(6, msize, msize, 3)


def convolve(cm: Cubemap, sample_count: int, weight: float, sample_idx: int = 0) -> Cubemap:
    """Prefilter every mip and EMA-blend it into the chain."""
    max_mip = float(max(cm.mip_count - 1, 1))
    mips: List[torch.Tensor] = []
    for m in range(cm.mip_count):
        new = prefilter_mip(cm.color, m, max_mip, sample_count, sample_idx)
        mips.append(cm.mips[m] + (new - cm.mips[m]) * weight)
    return cm._replace(mips=tuple(mips))


def read_convolved(cm: Cubemap, dirs: torch.Tensor, roughness) -> torch.Tensor:
    """Trilinear-clamp fetch with a fractional mip from roughness: dirs
    [..., 3], roughness a float or [...] -> [..., 3]."""
    max_mip = float(max(cm.mip_count - 1, 1))
    r = torch.as_tensor(roughness, dtype=torch.float32, device=dirs.device)
    mip = torch.clamp(roughness_to_mip(r, max_mip), 0.0, cm.mip_count - 1)
    m0 = torch.floor(mip)
    frac = mip - m0
    out = torch.zeros(dirs.shape[:-1] + (3,), dtype=torch.float32, device=dirs.device)
    for m in range(cm.mip_count):
        lo = sample_sky_cubemap(cm.mips[m], dirs)
        w = torch.where(m0 == m, 1.0 - frac, torch.where(m0 == m - 1, frac, 0.0))
        out = out + lo * w[..., None]
    return out


class CubemapRegistry:
    """The host-side named probe table."""

    def __init__(self) -> None:
        self._probes: Dict[str, Cubemap] = {}
        self._bounds: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self._samples: Dict[str, int] = {}
        self._origins: Dict[str, np.ndarray] = {}
        self._baked_from: Dict[str, np.ndarray] = {}

    def add(self, name: str, size: int, lo=None, hi=None, device="cuda") -> Cubemap:
        if name in self._probes:
            raise KeyError(f"cubemap exists: {name}")
        cm = cubemap_new(size, device)
        self._probes[name] = cm
        self._bounds[name] = (
            np.asarray(lo if lo is not None else [-1e9] * 3, np.float32),
            np.asarray(hi if hi is not None else [1e9] * 3, np.float32),
        )
        self._samples[name] = 0
        return cm

    def remove(self, name: str) -> bool:
        if name not in self._probes:
            return False
        del self._probes[name], self._bounds[name], self._samples[name]
        return True

    def find(self, name: str) -> Optional[Cubemap]:
        return self._probes.get(name)

    def names(self):
        return list(self._probes)

    def reset_samples(self, name: Optional[str] = None) -> None:
        """Restart a probe's (or every probe's) progressive average."""
        for n in ([name] if name else list(self._samples)):
            self._samples[n] = 0

    def probe_origin(self, name: str, fallback_origin=None) -> np.ndarray:
        """The bake origin: the probe's bounds center when it is bounded,
        else the fallback origin, frozen at its first use."""
        lo, hi = self._bounds[name]
        if np.all(np.isfinite(lo)) and np.all(np.abs(lo) < 1e8) and np.all(np.abs(hi) < 1e8):
            return ((lo + hi) * 0.5).astype(np.float32)
        if name not in self._origins:
            self._origins[name] = np.asarray(
                fallback_origin if fallback_origin is not None else [0, 0, 0], np.float32)
        return self._origins[name]

    def bake(self, name: str, meta, arrays, lights, fallback_origin=None,
             max_bounces: int = 4, convolve_samples: int = 32) -> Cubemap:
        """One progressive bake and convolve step (weight 1/++sampleCount).
        The origin is fixed per probe; if it changes, the running average
        restarts rather than mixing radiance from two viewpoints."""
        cm = self._probes[name]
        origin = self.probe_origin(name, fallback_origin)
        prev = self._baked_from.get(name)
        if prev is not None and not np.allclose(prev, origin):
            self._samples[name] = 0
        self._baked_from[name] = np.asarray(origin, np.float32).copy()
        self._samples[name] += 1
        w = 1.0 / self._samples[name]
        cm = bake_step(meta, arrays, lights, cm, origin, self._samples[name] - 1, w,
                       max_bounces)
        cm = convolve(cm, convolve_samples, w, self._samples[name] - 1)
        self._probes[name] = cm
        return cm


_registry: Optional[CubemapRegistry] = None


def get_registry() -> CubemapRegistry:
    global _registry
    if _registry is None:
        _registry = CubemapRegistry()
    return _registry
