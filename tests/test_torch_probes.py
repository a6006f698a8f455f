"""pim_tpu_torch.render.probes against pim_tpu.render.probes on the
identical (converted) Cornell scene.

probe_bake_step with 256 rays, 3 bounces, 3 passes from two origins: the
RNG words bit for bit; the ambient-cube faces and SH coefficients at rtol
1e-4 / atol 1e-5 when every ray's radiance agrees at that tolerance
(otherwise a path diverged after an ulp-level compare flip, and the fits
are held to 2% of their largest value); the pass count exactly.  The
evaluations (probe_irradiance, probe_sh_irradiance, probe_radiance) of one
shared probe at rtol 1e-6 / atol 1e-6; the crate entries round-trip both
ways."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import pallas_interpret

from pim_tpu.core import rng as jrng
from pim_tpu.geom.cornell import build_cornell_box as jax_cornell
from pim_tpu.math import sampling as jsamp
from pim_tpu.render import integrator as jint
from pim_tpu.render import probes as jprobes
from pim_tpu.render.scene import build_scene as jax_build_scene
from pim_tpu_torch.core import rng
from pim_tpu_torch.core.crate import Crate
from pim_tpu_torch.render import probes
from pim_tpu_torch.render.integrator import trace_rays
from pim_tpu_torch.render.scene import from_jax_scene

torch.set_num_threads(2)

SAMPLES = 256
BOUNCES = 3
TOL = dict(rtol=1e-6, atol=1e-6)
ORIGINS = ([0.0, -1.0, 0.5], [-3.0, 2.0, -1.0])


@pytest.fixture(scope="module")
def scenes():
    with pallas_interpret():
        jm, ja, jl = jax_build_scene(*jax_cornell("boxes"), backend="pallas")
    port = from_jax_scene(dataclasses.asdict(jm),
                          {k: np.asarray(v) for k, v in ja._asdict().items()},
                          {k: np.asarray(v) for k, v in jl._asdict().items()}, "cpu")
    return (jm, ja, jl), port


def _jax_step(scene):
    jm = scene[0]
    return jax.jit(lambda a, l, p: jprobes.probe_bake_step(jm, a, l, p, samples=SAMPLES,
                                                           max_bounces=BOUNCES))


def _radiance_agrees(scenes, probe, count):
    """Whether every ray of the probe's next pass traces to the same
    radiance (rtol 1e-4, atol 1e-5) in both packages; its RNG words are
    the reference's bit for bit."""
    (jm, ja, jl), (m, a, l) = scenes
    origin = probe.origin.numpy()
    js = jrng.make_state(jnp.arange(SAMPLES, dtype=jnp.uint32), jnp.uint32(count),
                         seed=0x0A3BC0DE)
    ts = rng.make_state(torch.arange(SAMPLES), count, seed=probes.PROBE_SEED)
    for w_j, w_t in zip(js, ts):
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j).astype(np.int64))
    js, (ju, jv) = jrng.next_f32x2(js)
    jrd = jsamp.sample_unit_sphere(ju, jv)
    jro = type(jrd).splat(jnp.asarray(origin, jnp.float32), (SAMPLES,))
    with pallas_interpret():
        jc = np.asarray(jax.block_until_ready(
            jax.jit(lambda a_, l_, ro, rd, s: jint.trace_rays(jm, a_, l_, ro, rd, s, BOUNCES))(
                ja, jl, jro, jrd, js)).color)
    state, ro, rd = probes.probe_rays(probe, SAMPLES)
    tc = trace_rays(m, a, l, ro, rd, state, BOUNCES).color.numpy()
    return bool(np.isclose(tc, jc, rtol=1e-4, atol=1e-5).all())


@pytest.fixture(scope="module")
def baked(scenes):
    """(per pass: (the JAX probe, the port's probe, whether every ray agreed))."""
    (_, ja, jl), (m, a, l) = scenes
    step = _jax_step(scenes[0])
    out = []
    for origin in ORIGINS:
        jp, tp = jprobes.probe_new(origin), probes.probe_new(origin, "cpu")
        for k in range(3 if origin is ORIGINS[0] else 1):
            agree = _radiance_agrees(scenes, tp, k)
            with pallas_interpret():
                jp = jax.block_until_ready(step(ja, jl, jp))
            tp = probes.probe_bake_step(m, a, l, tp, samples=SAMPLES, max_bounces=BOUNCES)
            out.append((jp, tp, agree))
    return out


def test_probe_bake_step_matches(baked):
    for jp, tp, agree in baked:
        assert int(tp.sample_count) == int(jp.sample_count)
        assert tp.sample_count.dtype == torch.int32
        np.testing.assert_array_equal(tp.origin.numpy(), np.asarray(jp.origin))
        for got, want in ((tp.faces, jp.faces), (tp.sh, jp.sh)):
            got, want = got.numpy(), np.asarray(want)
            assert np.isfinite(got).all()
            if agree:
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
            else:
                assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()
    # at least one pass is held at the tight tolerance
    assert any(agree for _, _, agree in baked)
    # the cube sees the lit box: every face positive
    assert (baked[2][1].faces.numpy() > 0).all()


def test_evaluations_match(baked):
    jp, tp, _ = baked[2]
    shared = jp._replace(faces=jnp.asarray(tp.faces.numpy()), sh=jnp.asarray(tp.sh.numpy()))
    d = np.random.default_rng(0).normal(size=(1000, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    for fn in ("probe_irradiance", "probe_sh_irradiance", "probe_radiance"):
        np.testing.assert_allclose(getattr(probes, fn)(tp, d).numpy(),
                                   np.asarray(getattr(jprobes, fn)(shared, d)), **TOL,
                                   err_msg=fn)
        np.testing.assert_allclose(getattr(probes, fn)(tp, torch.from_numpy(d)).numpy(),
                                   getattr(probes, fn)(tp, d).numpy(), rtol=0, atol=0)


def test_crate_entries(baked, tmp_path):
    jp, tp, _ = baked[2]
    entry = probes.probe_to_crate_entry(tp)
    want = jprobes.probe_to_crate_entry(jp)
    assert set(entry) == set(want)
    for k in entry:
        assert entry[k].dtype == want[k].dtype and entry[k].shape == want[k].shape, k
    c = Crate()
    c.set("p", {"camera": entry})
    c.save(str(tmp_path / "p.crate"))
    back = probes.probe_from_crate_entry(Crate.load(str(tmp_path / "p.crate")).get("p")["camera"],
                                         "cpu")
    for f in tp._fields:
        assert torch.equal(getattr(back, f), getattr(tp, f)), f
    # the JAX package's entry loads in the port, and the port's in it
    got = probes.probe_from_crate_entry(want, "cpu")
    np.testing.assert_array_equal(got.sh.numpy(), np.asarray(jp.sh))
    assert int(got.sample_count) == int(jp.sample_count)
    np.testing.assert_array_equal(np.asarray(jprobes.probe_from_crate_entry(entry).faces),
                                  tp.faces.numpy())
