"""Refraction and auto-exposure against pim_tpu on seeded inputs.

- `_scatter_refractive` (GGX dielectric with Beer-Lambert interior) on the
  same surfaces, incoming directions and RNG words, with the same
  deterministic thickness probe: the RNG words and the probe's mask equal,
  positions, directions, attenuations and pdfs at rtol 1e-5 / atol 1e-6
  (sqrt, exp and log run in different libraries).
- `exposure_pass` on a seeded HDR image: the 256-bin histogram bitwise,
  the adapted luminance and the exposure at rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pim_tpu.core import rng as jrng
from pim_tpu.geom.material import MatFlag
from pim_tpu.math.vec3 import V3 as JV3
from pim_tpu.render import bsdf as jbsdf
from pim_tpu.render import exposure as jexp
from pim_tpu.render.surface import Surface as JSurface
from pim_tpu_torch.core import rng
from pim_tpu_torch.math.vec3 import V3
from pim_tpu_torch.render import bsdf, exposure
from pim_tpu_torch.render.surface import Surface

torch.set_num_threads(2)

N = 4096


def _unit(rs, n=N):
    d = rs.normal(size=(3, n))
    return (d / np.linalg.norm(d, axis=0)).astype(np.float32)


def _surfaces(seed):
    """Seeded refractive surfaces as (numpy fields, incoming direction)."""
    rs = np.random.default_rng(seed)
    m = _unit(rs)
    n = (m + 0.2 * _unit(rs)).astype(np.float32)
    n = (n / np.linalg.norm(n, axis=0)).astype(np.float32)
    f = dict(
        p=(rs.random((3, N)) * 4 - 2).astype(np.float32), m=m, n=n,
        albedo=rs.random((3, N), dtype=np.float32), emission=np.zeros((3, N), np.float32),
        roughness=rs.random(N, dtype=np.float32), occlusion=np.ones(N, np.float32),
        metallic=np.zeros(N, np.float32),
        ior=np.where(rs.random(N) < 0.8, 1.5, 1.33).astype(np.float32),
        flags=np.full(N, int(MatFlag.REFRACTIVE), np.int32),
        backface=rs.random(N) < 0.3,
    )
    i = -_unit(rs)
    return f, i


def _thickness(xp, where):
    """A deterministic probe: a hit at |p.x| + |l.y| + 0.05 on masked lanes."""
    def fn(p, l, mask):
        calls.append(np.asarray(mask))
        return where(mask, xp.abs(p.x) + xp.abs(l.y) + 0.05, -1.0)
    calls = []
    return fn, calls


@pytest.mark.parametrize("seed", [1, 2])
def test_scatter_refractive_matches_reference(seed):
    f, i = _surfaces(seed)
    v3 = ("p", "m", "n", "albedo", "emission")
    jsurf = JSurface(**{k: (JV3(*map(jnp.asarray, v)) if k in v3 else jnp.asarray(v))
                        for k, v in f.items()})
    tsurf = Surface(**{k: (V3(*map(torch.from_numpy, v)) if k in v3 else torch.from_numpy(v))
                       for k, v in f.items()})
    js = jrng.make_state(jnp.arange(N, dtype=jnp.uint32), seed)
    ts = rng.make_state(torch.arange(N), seed)
    mask = np.random.default_rng(seed + 10).random(N) < 0.9
    jfn, jcalls = _thickness(jnp, jnp.where)
    tfn, tcalls = _thickness(torch, torch.where)
    js2, jsc = jbsdf._scatter_refractive(jsurf, JV3(*map(jnp.asarray, i)), js, jfn,
                                         jnp.asarray(mask))
    ts2, tsc = bsdf._scatter_refractive(tsurf, V3(*map(torch.from_numpy, i)), ts, tfn,
                                        torch.from_numpy(mask))
    for a, b in zip(js2, ts2):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())
    np.testing.assert_array_equal(tcalls[0], jcalls[0])
    assert 0.05 < tcalls[0].mean() < 0.95
    for a, b in zip((*jsc.pos, *jsc.dir, *jsc.attenuation, jsc.pdf),
                    (*tsc.pos, *tsc.dir, *tsc.attenuation, tsc.pdf)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


def test_exposure_pass_matches_reference():
    rs = np.random.default_rng(5)
    img = (np.exp2(rs.uniform(-25.0, 12.0, (N, 1))) * rs.random((N, 3))).astype(np.float32)
    img[:64] = 0.0
    jp = jexp.ExposureParams.from_cvars()
    tp = exposure.ExposureParams.from_cvars()
    want_h = np.asarray(jexp.build_histogram(jnp.asarray(img), jp.min_ev, jp.max_ev))
    got_h = exposure.build_histogram(torch.from_numpy(img), tp.min_ev, tp.max_ev)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    assert want_h.sum() == N and (want_h > 0).sum() > 20
    want = jexp.exposure_pass(jnp.asarray(img), jp, jexp.make_exposure_state(),
                              jnp.float32(1 / 60))
    got = exposure.exposure_pass(torch.from_numpy(img), tp, exposure.make_exposure_state(),
                                 1 / 60)
    for a, b in zip(want, got):
        np.testing.assert_allclose(float(b), float(a), rtol=1e-6)
