"""The slice as a whole: the port's frame of a small textured map (glass,
normal maps, atlas textures, sky panels, the cluster backend with ray
sorting) against pim_tpu's on the identical (converted) scene and seed.

The scene is `build_map_scene(rooms=(1, 1), spheres_per_room=2,
sphere_steps=8, tex_size=8, seed=2)` with a 16^2, 4-step sky, as
tests/test_parity.py builds it; the JAX side runs its cluster kernels in
interpret mode and its CPU atlas and sky samplers (whose lerp form differs
from the port's K6 form by a few ulp).  Criteria, as test_torch_frame.py:
at least 97% of pixels agree at rtol 1e-4 / atol 1e-5 (the rest are paths
that diverged after an ulp-level compare flip), the image means within 2%
and rays_traced within 1%.  The port's own build of the same map gives the
reference's cell activity bitwise and its light pdf and cdf at rtol 1e-6 /
atol 1e-6 (pdf rows sum to E, so a few entries exceed 1 and move by an ulp).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import pallas_interpret

from pim_tpu.core import rng as jrng
from pim_tpu.geom.maps import build_map_scene
from pim_tpu.render import camera as jcam
from pim_tpu.render import integrator as jint
from pim_tpu.render.scene import build_scene as jax_build_scene
from pim_tpu.render.sky import bake_sky_cubemap, earth_atmosphere
from pim_tpu_torch import native
from pim_tpu_torch.core import rng
from pim_tpu_torch.render import camera, integrator
from pim_tpu_torch.render.scene import build_scene, from_jax_scene

torch.set_num_threads(2)

W = H = 16
BOUNCES = 3
SAMPLE = 3
EYE = (-2.2, 1.7, -2.2)
AT = (1.5, 1.0, 1.5)


def _map():
    ents, pool = build_map_scene(rooms=(1, 1), spheres_per_room=2, sphere_steps=8, tex_size=8,
                                 seed=2)
    sd = np.asarray([0.35, 0.82, 0.45], np.float32)
    sd /= np.linalg.norm(sd)
    sky = np.asarray(bake_sky_cubemap(earth_atmosphere(), sd, 120.0, 16, 4), np.float32)
    return ents, pool, sky


@pytest.fixture(scope="module")
def scenes():
    ents, pool, sky = _map()
    with pallas_interpret():
        jm, ja, jl = jax_build_scene(ents, pool, backend="cluster", sky=sky, sort_rays=True)
    port = from_jax_scene(dataclasses.asdict(jm),
                          {k: np.asarray(v) for k, v in ja._asdict().items()},
                          {k: np.asarray(v) for k, v in jl._asdict().items()}, "cpu")
    return (jm, ja, jl), port


@pytest.fixture(scope="module")
def frames(scenes):
    (jm, ja, jl), (m, a, l) = scenes
    jc = jcam.Camera(position=np.array(EYE, np.float32))
    jc.look_at(list(AT))
    jca = jcam.camera_arrays(jc, jcam.DofInfo(autofocus=False), W, H)
    tc = camera.Camera(position=np.array(EYE, np.float32))
    tc.look_at(list(AT))
    tca = camera.camera_arrays(tc, camera.DofInfo(autofocus=False), W, H)
    js, jro, jrd = jcam.generate_primary_rays(
        jca, W, H, jrng.make_state(jnp.arange(W * H, dtype=jnp.uint32), SAMPLE))
    ts, tro, trd = camera.generate_primary_rays(tca, W, H,
                                                rng.make_state(torch.arange(W * H), SAMPLE))
    # one executable, finished before anything else is dispatched (see
    # pallas_interpret)
    trace = jax.jit(lambda a, l, ro, rd, s: jint.trace_rays(jm, a, l, ro, rd, s, BOUNCES))
    with pallas_interpret():
        jres = jax.block_until_ready(trace(ja, jl, jro, jrd, js))
    before = dict(native.launches)
    tres = integrator.trace_rays(m, a, l, tro, trd, ts, BOUNCES)
    assert native.launches == before
    return jres, tres


def test_map_scene_has_every_slice_2_feature(scenes):
    (jm, _, _), (m, _, _) = scenes
    assert m.backend == "cluster" and m.sort_rays
    assert m.textured and m.has_normal_maps and m.has_sky and m.has_refractive


def test_map_frame_pixels_agree(frames):
    jres, tres = frames
    jc, tc = np.asarray(jres.color), tres.color.numpy()
    assert tc.shape == jc.shape == (W * H, 3) and np.isfinite(tc).all()
    close = np.all(np.isclose(tc, jc, rtol=1e-4, atol=1e-5), axis=-1)
    assert close.mean() >= 0.97, close.mean()


def test_map_frame_mean_and_rays_agree(frames):
    jres, tres = frames
    jmean, tmean = float(np.mean(np.asarray(jres.color))), float(tres.color.mean())
    assert jmean > 0 and abs(tmean - jmean) <= 0.02 * jmean
    jr, tr = float(jres.rays_traced), float(tres.rays_traced)
    assert abs(tr - jr) <= 0.01 * jr


def test_port_build_matches_reference_light_grid(scenes):
    (jm, ja, jl), _ = scenes
    ents, pool, sky = _map()
    m, a, l = build_scene(ents, pool, "cpu", backend="cluster", sky=sky, sort_rays=True)
    assert (m.grid_size, m.emissive_count) == (jm.grid_size, jm.emissive_count)
    np.testing.assert_array_equal(a.cell_active.numpy(), np.asarray(ja.cell_active))
    for name in ("pdf", "cdf"):
        np.testing.assert_allclose(getattr(l, name).numpy(), np.asarray(getattr(jl, name)),
                                   rtol=1e-6, atol=1e-6)
    for name in ("cl_tris", "cl_clb", "cl_scb", "atlas_corners", "tex_rec_t", "sky"):
        np.testing.assert_array_equal(getattr(a, name).numpy(), np.asarray(getattr(ja, name)),
                                      err_msg=name)
