"""The port's jax-free Cornell scene build against pim_tpu's.

The JAX side is built with the dense Pallas backend in interpret mode, so
its light grid is baked through the Pallas kernels.  BW rows, tables, grid
and cell activity must be bitwise equal; the light pdf/cdf at atol 1e-6
and the BRDF LUT at atol 1e-6 (its 5120-sample sums run in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import pallas_interpret

from pim_tpu.geom.cornell import build_cornell_box as jax_cornell
from pim_tpu.geom.entities import flatten
from pim_tpu.math.vec3 import V3 as JV3
from pim_tpu.render import lights as jlights
from pim_tpu.render.scene import build_scene as jax_build_scene
from pim_tpu_torch.geom.cornell import build_cornell_box
from pim_tpu_torch.math.vec3 import V3
from pim_tpu_torch.render import lights
from pim_tpu_torch.render.scene import (
    DENSE_CROSSOVER_TRIS,
    LightState,
    SceneArrays,
    build_scene,
    choose_backend,
    from_jax_scene,
)
from pim_tpu_torch.render.sky import sky_corner_planes

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_scene():
    with pallas_interpret():
        return jax_build_scene(*jax_cornell("boxes"), backend="pallas")


@pytest.fixture(scope="module")
def port_scene():
    return build_scene(*build_cornell_box("boxes"), "cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_dicts(jax_scene):
    jm, ja, jl = jax_scene
    return (dataclasses.asdict(jm), {k: np.asarray(v) for k, v in ja._asdict().items()},
            {k: np.asarray(v) for k, v in jl._asdict().items()})


def test_host_geometry_bitwise():
    jents, jpool = jax_cornell("boxes")
    ents, pool = build_cornell_box("boxes")
    jf, f = flatten(jents), flatten(ents)
    for name in ("positions", "normals", "uvs", "mat_ids"):
        np.testing.assert_array_equal(getattr(f, name), getattr(jf, name))
    assert [dataclasses.asdict(m) for m in f.materials] == \
        [dataclasses.asdict(m) for m in jf.materials]
    for a, b in zip(pool.pack(), jpool.pack()):
        np.testing.assert_array_equal(a, b)


def test_spheres_geometry_bitwise():
    """'spheres': 15 spheres (gen_sphere_mesh, 24 steps) in three rows --
    metallic, plain, refractive at ior 1.5 -- over the six walls and the
    light: the soup, the materials and the texture pool bit for bit."""
    jents, jpool = jax_cornell("spheres")
    ents, pool = build_cornell_box("spheres")
    jf, f = flatten(jents), flatten(ents)
    assert f.mat_ids.shape == (15 * 2208 + 7 * 12,)  # the spheres and the 7 wall and light boxes
    for name in ("positions", "normals", "uvs", "mat_ids"):
        np.testing.assert_array_equal(getattr(f, name), getattr(jf, name))
    assert [dataclasses.asdict(m) for m in f.materials] == \
        [dataclasses.asdict(m) for m in jf.materials]
    assert sum(m.ior == np.float32(1.5) for m in f.materials) == 5
    for a, b in zip(pool.pack(), jpool.pack()):
        np.testing.assert_array_equal(a, b)
    assert choose_backend(f.mat_ids.shape[0]) == "cluster"


@pytest.mark.parametrize("port_field,jax_field", [
    ("positions", "positions"), ("tris12", "tris9"), ("tri_table", "tri_table"),
    ("emissive_table", "emissive_table"), ("tri_to_emit", "tri_to_emit"),
    ("cell_active", "cell_active"), ("cell_active_f", "cell_active_f"),
])
def test_scene_arrays_bitwise(jax_scene, port_scene, port_field, jax_field):
    a = _np(getattr(port_scene[1], port_field))
    b = np.asarray(getattr(jax_scene[1], jax_field))
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_scene_meta_and_grid_match(jax_scene, port_scene):
    jm, ja, _ = jax_scene
    m, a, _ = port_scene
    for name in ("vert_count", "tri_count", "mat_count", "emissive_count", "grid_size",
                 "cells_per_meter", "has_sky", "has_refractive", "media_enabled",
                 "textured", "has_normal_maps"):
        assert getattr(m, name) == getattr(jm, name), name
    np.testing.assert_array_equal(np.asarray(m.grid_lo, np.float32), np.asarray(ja.grid_lo))
    np.testing.assert_array_equal(a.emit_tris.numpy(),
                                  np.asarray(ja.emit_to_tri_f)[0].astype(np.int64))
    assert m.grid_len == 343 and m.emissive_count == 12 and m.tri_count == 108


@pytest.mark.parametrize("name", ["pdf", "cdf", "integral"])
def test_light_state_matches(jax_scene, port_scene, name):
    np.testing.assert_allclose(_np(getattr(port_scene[2], name)),
                               np.asarray(getattr(jax_scene[2], name)), rtol=0, atol=1e-6)


def test_brdf_lut_matches(jax_scene, port_scene):
    np.testing.assert_allclose(port_scene[1].brdf_lut.numpy(), np.asarray(jax_scene[1].brdf_lut),
                               rtol=0, atol=1e-6)


def test_from_jax_scene_round_trips_every_field(jax_scene):
    meta_f, arrays_np, lights_np = _jax_dicts(jax_scene)
    m, a, l = from_jax_scene(meta_f, arrays_np, lights_np, "cpu")
    for f in dataclasses.fields(m):
        if f.name == "grid_lo":
            np.testing.assert_array_equal(np.asarray(m.grid_lo, np.float32), arrays_np["grid_lo"])
        elif f.name == "backend":
            assert (m.backend, meta_f["backend"]) == ("dense", "pallas")
        elif f.name == "differentiable":  # the port's flag for render/diff.py
            assert "differentiable" not in meta_f and not m.differentiable
        elif f.name == "media":  # the port's scene-carried medium (the JAX
            # package passes its MediaDesc to trace_rays)
            assert "media" not in meta_f and m.media is None
        else:
            assert getattr(m, f.name) == meta_f[f.name], f.name
    jax_name = {"tris12": "tris9"}
    for f in dataclasses.fields(SceneArrays):
        got = getattr(a, f.name).numpy()
        if f.name == "emit_tris":
            want = arrays_np["emit_to_tri_f"][0].astype(np.int64)
        elif f.name == "sky_corners":
            want = sky_corner_planes(torch.from_numpy(np.array(arrays_np["sky"]))).numpy()
        else:
            want = arrays_np[jax_name.get(f.name, f.name)]
        assert got.shape == want.shape, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    for f in dataclasses.fields(LightState):
        got = getattr(l, f.name).numpy()
        np.testing.assert_array_equal(got, lights_np[f.name].astype(got.dtype), err_msg=f.name)


def test_dense_only_scenes_are_enforced(jax_scene):
    """The dense kernels serve scenes up to DENSE_CROSSOVER_TRIS triangles,
    the cluster kernels the rest; every JAX backend maps to the port's own
    ('pallas' to 'dense', the others to themselves) with the JAX BVH and
    max_leaf carried, and a name the port lacks is refused."""
    assert choose_backend(DENSE_CROSSOVER_TRIS) == "dense"
    assert choose_backend(DENSE_CROSSOVER_TRIS + 1) == "cluster"
    meta_f, arrays_np, lights_np = _jax_dicts(jax_scene)
    for backend, want in (("pallas", "dense"), ("cluster", "cluster"), ("bvh", "bvh"),
                          ("brute", "brute")):
        m, a, _ = from_jax_scene(dict(meta_f, backend=backend), arrays_np, lights_np, "cpu")
        assert m.backend == want and m.max_leaf == meta_f["max_leaf"]
        for name in ("bvh_lo", "bvh_hi", "bvh_a", "bvh_b", "tri_order"):
            np.testing.assert_array_equal(getattr(a, name).numpy(), arrays_np[name])
    with pytest.raises(NotImplementedError, match="the port has"):
        from_jax_scene(dict(meta_f, backend="embree"), arrays_np, lights_np, "cpu")


def test_light_table_matches_reference(jax_scene):
    """The fused light table, tie order of the top K included, bitwise."""
    _, ja, jl = jax_scene
    _, a, l = from_jax_scene(*_jax_dicts(jax_scene), "cpu")
    want = np.asarray(jlights.make_light_table(jl, ja.cell_active_f))
    np.testing.assert_array_equal(lights.make_light_table(l, a.cell_active_f).numpy(), want)


def test_light_on_hit_matches_reference(jax_scene):
    """The live-histogram update, bitwise, on seeded lanes: inactive lanes,
    non-emissive hits (emit -1) and zero emission add nothing."""
    jm = jax_scene[0]
    g, e, n = jm.grid_len, jm.emissive_count, 4096
    rs = np.random.default_rng(7)
    live0 = rs.integers(0, 1000, (g, e)).astype(np.uint32)
    cell = rs.integers(0, g, n).astype(np.int32)
    emit = rs.integers(-1, e, n).astype(np.int32)
    em = rs.random((3, n), dtype=np.float32) * 2.0
    em[:, rs.random(n) < 0.2] = 0.0
    active = rs.random(n) < 0.7
    want = jlights.light_on_hit(jm, jnp.asarray(live0), jnp.asarray(cell), jnp.asarray(emit),
                                JV3(*map(jnp.asarray, em)), jnp.asarray(active))
    got = lights.light_on_hit(None, torch.from_numpy(live0.astype(np.int64)),
                              torch.from_numpy(cell).long(), torch.from_numpy(emit).long(),
                              V3(*map(torch.from_numpy, em)), torch.from_numpy(active))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert (got.numpy() != live0).any()
