"""The port's texture and sky path against pim_tpu.

- K6: the plain `gather_bilinear` (what the wrapper runs for CPU tensors)
  against the interpret-mode Pallas `gather_bilinear_pallas`.  On the e1m1
  atlas corner planes (C = 4, parts = 1; the texels are bf16 values, so the
  one-term split is exact) the port equals its op-by-op float32 formula
  bit for bit and the Pallas kernel within 2 eps of sum |w q|: XLA:CPU
  contracts the interpret-mode sum into FMAs (ROADMAP F5).  On a sky cube
  (C = 3, parts = 2 keeps 16 mantissa bits) within relative 2^-15.
  Queries include invalid lanes carrying NaN weights and indices at -1 and
  T.
- `_bilinear_setup` bitwise, negative uvs included; the e1m1 atlas, its
  records and corner planes bitwise, the port's glTF loader against the
  reference's.
- The sky: `bake_sky_cubemap` at size 16, 4 steps within rtol 1e-5 of the
  reference's; `sample_sky_cubemap_soa` within rtol 1e-5 of the reference's
  CPU path, which lerps as t00 + (t10 - t00) tx where K6 weights corners.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pim_tpu.geom.gltf import load_gltf_scene as jax_load_gltf
from pim_tpu.math.vec3 import V2 as JV2
from pim_tpu.math.vec3 import V3 as JV3
from pim_tpu.render import sky as jsky
from pim_tpu.render import surface as jsurface
from pim_tpu.render.scene import _build_atlas_corner_planes
from pim_tpu.render.table_gather import gather_bilinear_pallas
from pim_tpu_torch import native
from pim_tpu_torch.geom.gltf import load_gltf_scene
from pim_tpu_torch.math.vec3 import V2, V3
from pim_tpu_torch.render import sky, surface
from pim_tpu_torch.render.scene import build_atlas_corner_planes, texture_records_t
from pim_tpu_torch.render.table_gather import gather_bilinear, gather_bilinear_plain

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E1M1 = os.path.join(ROOT, "data", "e1m1", "glTF", "e1m1.gltf")
N = 2048


@pytest.fixture(scope="module")
def e1m1_pools():
    return jax_load_gltf(E1M1)[1], load_gltf_scene(E1M1)[1]


@pytest.fixture(scope="module")
def atlas(e1m1_pools):
    return e1m1_pools[1].pack()


def _queries(rs, k, n, t):
    idx = rs.integers(0, t, (k, n)).astype(np.int32)
    idx[0, :2] = [-1, t]
    tx = rs.random((k, n), dtype=np.float32)
    ty = rs.random((k, n), dtype=np.float32)
    valid = rs.random((k, n)) < 0.8
    valid[0, :2] = True
    tx[~valid] = np.nan
    return idx, tx, ty, valid


def _both(planes, idx, tx, ty, valid, c, parts):
    ref = np.asarray(gather_bilinear_pallas(jnp.asarray(planes), jnp.asarray(idx),
                                            jnp.asarray(tx), jnp.asarray(ty), jnp.asarray(valid),
                                            c=c, interpret=True, parts=parts))
    out = gather_bilinear(*(torch.from_numpy(np.ascontiguousarray(x))
                            for x in (planes, idx, tx, ty, valid)), c=c)
    return out.numpy(), ref


def _weighted_terms(planes, idx, tx, ty, valid, c):
    """The four products w q of each query, float32 op by op: [4, C, K, N]."""
    i = np.clip(idx, 0, planes.shape[1] - 1)
    one = np.float32(1.0)
    txv, tyv = np.where(valid, tx, 0).astype(np.float32), np.where(valid, ty, 0).astype(np.float32)
    w = [np.where(valid, (one - txv) * (one - tyv), 0).astype(np.float32),
         txv * (one - tyv), (one - txv) * tyv, txv * tyv]
    return np.stack([w[k][None] * planes[k * c : (k + 1) * c][:, i] for k in range(4)])


def test_k6_atlas_matches_pallas(atlas):
    """Bitwise against the kernel's float32 arithmetic; the interpret-mode
    Pallas kernel runs on XLA:CPU, which contracts the weighted sum into
    FMAs (ROADMAP F5), so against it each value stays within 2 eps of
    sum |w q| (the real kernel on the chip rounds each op, as the port)."""
    planes = build_atlas_corner_planes(*atlas)
    idx, tx, ty, valid = _queries(np.random.default_rng(1), 3, N, planes.shape[1])
    out, ref = _both(planes, idx, tx, ty, valid, 4, 1)
    assert out.shape == (4, 3, N) and np.isfinite(out).all()
    terms = _weighted_terms(planes, idx, tx, ty, valid, 4)
    np.testing.assert_array_equal(out, np.where(valid, ((terms[0] + terms[1]) + terms[2])
                                                + terms[3], 0.0))
    bound = 2 * np.finfo(np.float32).eps * np.abs(terms).sum(axis=0)
    assert (np.abs(out - ref) <= bound).all()
    assert (np.abs(out - ref) > 0).mean() < 0.1
    assert (out[:, ~valid] == 0.0).all() and (ref[:, ~valid] == 0.0).all()


def test_k6_sky_within_16_mantissa_bits():
    rs = np.random.default_rng(2)
    cube = rs.uniform(0.01, 40.0, (6, 16, 16, 3)).astype(np.float32)
    planes = sky.sky_corner_planes(torch.from_numpy(cube)).numpy()
    idx, tx, ty, valid = _queries(rs, 1, N, planes.shape[1])
    out, ref = _both(planes, idx, tx, ty, valid, 3, 2)
    np.testing.assert_array_equal(out == 0.0, ref == 0.0)
    live = ref != 0.0
    assert (np.abs(out[live] - ref[live]) <= 2.0**-15 * np.abs(ref[live])).all()


def test_k6_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    rs = np.random.default_rng(3)
    planes = rs.random((12, 100), dtype=np.float32)
    args = [torch.from_numpy(x) for x in (planes, *_queries(rs, 2, 64, 100))]
    before = dict(native.launches)
    np.testing.assert_array_equal(gather_bilinear(*args, c=3).numpy(),
                                  gather_bilinear_plain(*args, c=3).numpy())
    assert native.launches == before


def test_e1m1_atlas_and_corner_planes_bitwise(e1m1_pools):
    jpool, pool = e1m1_pools
    (jatlas, jrec), (atlas_, rec) = jpool.pack(), pool.pack()
    assert atlas_.shape == (128, 256, 4) and rec.shape == (71, 4)
    np.testing.assert_array_equal(atlas_, jatlas)
    np.testing.assert_array_equal(rec, jrec)
    np.testing.assert_array_equal(build_atlas_corner_planes(atlas_, rec),
                                  _build_atlas_corner_planes(jatlas, jrec))


def test_bilinear_setup_bitwise(atlas):
    rec_t = texture_records_t(*atlas)
    rs = np.random.default_rng(4)
    tex = rs.integers(-1, rec_t.shape[1], N).astype(np.int32)
    uv = rs.uniform(-3.0, 3.0, (2, N)).astype(np.float32)
    uv[:, :8] = [[-1.0, -0.0, 0.0, 1.0, -2.5, 2.5, -1e-8, 0.999999]] * 2
    want_idx, want_tx, want_ty = jsurface._bilinear_setup(
        jnp.asarray(rec_t), jnp.asarray(tex), JV2(jnp.asarray(uv[0]), jnp.asarray(uv[1])))
    idx4, tx, ty = surface._bilinear_setup(torch.from_numpy(rec_t), torch.from_numpy(tex),
                                           V2(torch.from_numpy(uv[0]), torch.from_numpy(uv[1])))
    assert idx4.dtype == torch.int32 and idx4.shape == (4, N)
    np.testing.assert_array_equal(idx4.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(want_tx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(want_ty))


def test_sky_bake_matches_reference():
    sd = np.asarray([0.35, 0.82, 0.45], np.float32)
    sd /= np.linalg.norm(sd)
    want = np.asarray(jsky.bake_sky_cubemap(jsky.earth_atmosphere(), sd, 120.0, 16, 4))
    got = sky.bake_sky_cubemap(sky.earth_atmosphere(), sd, 120.0, 16, 4).numpy()
    assert got.shape == (6, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_sky_sampler_matches_reference():
    rs = np.random.default_rng(7)
    cube = rs.uniform(0.1, 4.0, (6, 8, 8, 3)).astype(np.float32)
    cube += np.arange(6, dtype=np.float32)[:, None, None, None] * 10.0
    d = rs.normal(size=(3, N))
    d[:, :6] = np.concatenate([np.eye(3), -np.eye(3)], axis=1)
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    want = jsky.sample_sky_cubemap_soa(jnp.asarray(cube), JV3(*map(jnp.asarray, d)))
    got = sky.sample_sky_cubemap_soa(sky.sky_corner_planes(torch.from_numpy(cube)), 8,
                                     V3(*map(torch.from_numpy, d)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=0)
    active = torch.from_numpy(rs.random(N) < 0.5)
    part = sky.sample_sky_cubemap_soa(sky.sky_corner_planes(torch.from_numpy(cube)), 8,
                                      V3(*map(torch.from_numpy, d)), active=active)
    assert (part.x[~active] == 0.0).all()
    np.testing.assert_array_equal(part.x[active].numpy(), got.x[active].numpy())
