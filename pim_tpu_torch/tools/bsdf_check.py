"""What the BSDF kernels (csrc/bsdf.cu) are checked on and held against,
shared by chip_smoke.py and the tests.

- Lanes: `random_lanes` (seeded surfaces, incoming and light directions and
  RNG words, a third of them refractive) and `edge_lanes` (a grid over
  incidence, light angle, roughness 0 / 0.5 / 1, metallic 0 / 1, front and
  back faces, refractive or not, tilted shading normals and both normal
  signs: refraction entering and leaving, total internal reflection,
  NoL <= EPS, pdf <= EPS); `recorded_calls` keeps the arguments of the
  main path's first scatter and eval calls.
- References: `scatter_differences` and `eval_differences` run the
  dispatching functions and the plain forms on the same lanes and count,
  per output, the lanes whose bits differ; the scatter's thickness probe is
  `probe_stub`, a deterministic function of the probe's rays that records
  what it was given.
- `refract_finish_plain`: the composed tail of the refractive sample, the
  plain counterpart of `bsdf_refract_finish`; `*_bytes`: each kernel's
  bytes, every input read once and every output written once.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import NamedTuple

import numpy as np
import torch

from pim_tpu_torch.geom.material import MatFlag
from pim_tpu_torch.math.brdf import albedo_to_transmittance
from pim_tpu_torch.math.vec3 import EPS, V3, where3
from pim_tpu_torch.render import bsdf
from pim_tpu_torch.render.surface import Surface

_REFRACTIVE = int(MatFlag.REFRACTIVE)
_OTHER_FLAGS = (0, int(MatFlag.EMISSIVE), int(MatFlag.SKY), int(MatFlag.WATER))


class Lanes(NamedTuple):
    surf: Surface
    i: V3          # incoming direction
    l: V3          # light direction of the eval
    state: tuple   # four int64 RNG words


def _lanes(device, p, m, n, albedo, roughness, metallic, ior, flags, backface, i, l, words):
    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    def v3(a):
        return V3(*(f32(c) for c in a))

    zero = f32(np.zeros(len(roughness)))
    surf = Surface(p=v3(p), m=v3(m), n=v3(n), albedo=v3(albedo), emission=V3(zero, zero, zero),
                   roughness=f32(roughness), occlusion=zero, metallic=f32(metallic),
                   ior=f32(ior), flags=torch.from_numpy(flags.astype(np.int32)).to(device),
                   backface=torch.from_numpy(backface).to(device))
    state = tuple(torch.from_numpy(w.astype(np.int64)).to(device) for w in words)
    return Lanes(surf=surf, i=v3(i), l=v3(l), state=state)


def _unit(rs, n):
    d = rs.normal(size=(3, n))
    return d / np.linalg.norm(d, axis=0)


def random_lanes(n: int, seed: int, device="cpu") -> Lanes:
    """n seeded lanes: macro normals, shading normals off them (some below
    the macro hemisphere), incoming directions mostly against the macro
    normal, a third of the lanes refractive, 5% each of roughness and
    metallic at exactly 0 and at exactly 1."""
    rs = np.random.default_rng(seed)
    m = _unit(rs, n)
    sn = m + 0.35 * _unit(rs, n)
    sn /= np.linalg.norm(sn, axis=0)
    i = _unit(rs, n)
    i = np.where((np.sum(i * m, axis=0) > 0.0) & (rs.random(n) < 0.8), -i, i)

    def unit_interval():
        x = rs.random(n)
        pick = rs.random(n)
        return np.where(pick < 0.05, 0.0, np.where(pick < 0.1, 1.0, x))

    flags = (np.where(rs.random(n) < 0.33, _REFRACTIVE, 0)
             | rs.choice(_OTHER_FLAGS, n)).astype(np.int32)
    words = rs.integers(0, 1 << 32, size=(4, n), dtype=np.int64)
    return _lanes(device, rs.uniform(-2.0, 2.0, (3, n)), m, sn, rs.random((3, n)),
                  unit_interval(), unit_interval(), rs.uniform(0.8, 2.0, n), flags,
                  rs.random(n) < 0.3, i, _unit(rs, n), words)


def _rotate_y(v, deg):
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    return np.array([c * v[0] + s * v[2], v[1], -s * v[0] + c * v[2]])


def edge_lanes(device="cpu", seed: int = 0, draws: int = 4) -> Lanes:
    """A grid of hand-placed lanes, `draws` RNG streams each: incidence 0,
    30, 60, 85, 89.9, 90 and 120 degrees from the normal (past 90 the ray
    comes from below), light directions 0, 45, 89.9999, 90 and 135 degrees
    off it, roughness 0, 0.5 and 1, metallic 0 and 1, front and back faces,
    refractive (ior 1.5) or not, the shading normal on the macro normal or
    tilted 35 degrees from it, and the whole frame upright or upside down
    (normal z = +1 or -1)."""
    rows = []
    z = np.array([0.0, 0.0, 1.0])
    for inc, lit, rough, metal, back, refr, tilt, down in itertools.product(
            (0.0, 30.0, 60.0, 85.0, 89.9, 90.0, 120.0), (0.0, 45.0, 89.9999, 90.0, 135.0),
            (0.0, 0.5, 1.0), (0.0, 1.0), (False, True), (False, True), (0.0, 35.0),
            (False, True)):
        sign = -1.0 if down else 1.0
        sn = _rotate_y(z, tilt)
        i = -_rotate_y(z, inc)
        l = _rotate_y(np.array([0.0, 0.0, 1.0]), -lit)
        rows.append((sign * z, sign * sn, sign * i, sign * l, rough, metal, back, refr))
    k = len(rows) * draws
    rows = rows * draws
    col = lambda j: np.array([r[j] for r in rows])  # noqa: E731
    m, sn, i, l = (col(j).T for j in range(4))
    rs = np.random.default_rng(seed)
    flags = np.where(col(7), _REFRACTIVE, 0).astype(np.int32)
    words = rs.integers(0, 1 << 32, size=(4, k), dtype=np.int64)
    return _lanes(device, rs.uniform(-2.0, 2.0, (3, k)), m, sn, rs.random((3, k)),
                  col(4), col(5), np.where(col(7), 1.5, 1.0), flags, col(6).astype(bool), i, l,
                  words)


def probe_stub(calls: list):
    """A deterministic thickness probe: t = |p.x| + |l.y| + 0.05 on the
    masked lanes, -1 elsewhere; each call appends (p, l, mask) to `calls`."""
    def fn(p: V3, l: V3, mask):
        calls.append((p, l, mask))
        return torch.where(mask, torch.abs(p.x) + torch.abs(l.y) + 0.05, -1.0)
    return fn


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def differing(got, want) -> list:
    """Per pair of tensors, the lanes whose bits differ."""
    return [int((_bits(g) != _bits(w)).sum()) for g, w in zip(got, want)]


def scatter_differences(lut, lanes: Lanes, refract: bool) -> dict:
    """`scatter_principled` (the kernels on CUDA) against
    `scatter_principled_plain` on the same lanes: per output (state words
    x y z w, position, direction, attenuation, pdf; with `refract` also the
    probe's origin, direction and mask) the lanes whose bits differ."""
    got_calls, want_calls = [], []
    got_state, got = bsdf.scatter_principled(lut, lanes.surf, lanes.i, lanes.state,
                                             probe_stub(got_calls) if refract else None)
    want_state, want = bsdf.scatter_principled_plain(lut, lanes.surf, lanes.i, lanes.state,
                                                     probe_stub(want_calls) if refract else None)
    names = ["state.x", "state.y", "state.z", "state.w"] + [
        f"{v}.{c}" for v in ("pos", "dir", "attenuation") for c in "xyz"] + ["pdf"]
    diffs = differing([*got_state, *got.pos, *got.dir, *got.attenuation, got.pdf],
                      [*want_state, *want.pos, *want.dir, *want.attenuation, want.pdf])
    if refract:
        (gp, gl, gm), (wp, wl, wm) = got_calls[0], want_calls[0]
        names += [f"probe.{v}.{c}" for v in ("pos", "dir") for c in "xyz"] + ["probe.mask"]
        diffs += differing([*gp, *gl, gm], [*wp, *wl, wm])
    return dict(zip(names, diffs))


def eval_differences(lut, lanes: Lanes) -> dict:
    """`eval_principled` (the kernel on CUDA) against `eval_principled_plain`:
    per output, the lanes whose bits differ."""
    got_a, got_p = bsdf.eval_principled(lut, lanes.surf, lanes.i, lanes.l)
    want_a, want_p = bsdf.eval_principled_plain(lut, lanes.surf, lanes.i, lanes.l)
    return dict(zip(("attenuation.x", "attenuation.y", "attenuation.z", "pdf"),
                    differing([*got_a, got_p], [*want_a, want_p])))


def refract_finish_plain(out: torch.Tensor, probe: torch.Tensor, t_hit: torch.Tensor,
                         albedo: V3, roughness: torch.Tensor) -> V3:
    """The attenuation that `bsdf_refract_finish` writes, composed of PyTorch
    ops as `_scatter_refractive`'s tail: Beer-Lambert on the probed lanes,
    out's rows 6-8 elsewhere."""
    pdf = out[9]
    thickness = torch.where(t_hit >= 0.0, torch.clamp_min(t_hit, EPS), 1e6)
    tr = albedo_to_transmittance(albedo, roughness, thickness)
    return where3(probe, tr * pdf, V3(out[6], out[7], out[8]))


@contextlib.contextmanager
def recorded_calls():
    """Within it, the main path's scatter and eval calls (the integrator's
    `scatter_principled`, NEE's `eval_principled`) append their arguments
    to the yielded {"scatter": [...], "eval": [...]}: (lut, surf, i, state,
    occluded_fn) and (lut, surf, i, l)."""
    from pim_tpu_torch.render import integrator, lights

    calls = {"scatter": [], "eval": []}
    patched = ((integrator, "scatter_principled", "scatter"), (lights, "eval_principled", "eval"))
    kept = [getattr(module, name) for module, name, _ in patched]

    def recording(kind, fn):
        def wrapper(*args, **kwargs):
            calls[kind].append(args + tuple(kwargs.values()))
            return fn(*args, **kwargs)
        return wrapper

    for (module, name, kind), fn in zip(patched, kept):
        setattr(module, name, recording(kind, fn))
    try:
        yield calls
    finally:
        for (module, name, _), fn in zip(patched, kept):
            setattr(module, name, fn)


def scatter_bytes(n: int, refract: bool, lut_size: int = 16) -> int:
    """bsdf_scatter: the 24 inputs of a lane (18 float32, the flags, the
    backface byte, four int64 words) and the LUT read once; the position,
    direction, attenuation, pdf and words written; with `refract` the
    probe's origin, direction and mask too."""
    per_lane = 18 * 4 + 4 + 1 + 4 * 8 + 10 * 4 + 4 * 8 + ((6 * 4 + 1) if refract else 0)
    return n * per_lane + lut_size * lut_size * 2 * 4


def refract_finish_bytes(n: int, probed: int) -> int:
    """bsdf_refract_finish: every lane's probe flag; a probed lane's hit
    distance, albedo, roughness and pdf read and its attenuation written."""
    return n + probed * (6 * 4 + 3 * 4)


def eval_bytes(n: int, lut_size: int = 16) -> int:
    """bsdf_eval: 14 float32 inputs and the flags of a lane, the LUT once;
    the attenuation and pdf written."""
    return n * (14 * 4 + 4 + 4 * 4) + lut_size * lut_size * 2 * 4
