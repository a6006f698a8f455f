"""pim_tpu_torch.render.lightmap against pim_tpu.render.lightmap.

- The packer (host numpy, copied line for line): Cornell at 1 and 4
  texels/m (auto-grown), into a fixed 128^2 atlas and through the terminal
  overflow branch (a 16^2 atlas at 4 texels/m) bit for bit; e1m1 at 4
  texels/m bit for bit against the committed data/e1m1/lmpack.npz (no JAX
  needed; about 20 s here).
- bake_step on the identical (converted) Cornell scene at 1 texel/m
  (64^2 atlas, 1,858 live texels), 3 bounces, 2 passes, whole and in two
  shards: the RNG words bit for bit and the rays at rtol 1e-6; the SG fold
  with a stand-in radiance (the same function of the ray in both packages,
  so no path can diverge) at rtol 1e-5 / atol 1e-6 (exp differs by an ulp
  between XLA:CPU and torch, and the fit divides by running weights); the
  traced bake with the frame rule of test_torch_frame.py (97% of probe
  values within rtol 1e-4 / atol 1e-5: a path may diverge after an
  ulp-level compare flip; the means within 2%), the sample counts bit for
  bit.
- The port's sharded bake equals its whole bake bit for bit.
- lightmap_irradiance at rtol 2e-6; the crate entries round-trip, a JAX
  package entry loads in the port, and an entry without `axii` loads with
  GI_AXII.
- The port's e1m1 bake tool on Cornell; the Cornell lightmap band
  (pim_tpu_torch/render/bake_bands.json) records its CPU derivation, and a
  slow test derives it again (about 4 minutes here)."""

import dataclasses
import importlib.util
import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import pallas_interpret

from pim_tpu.core import rng as jrng
from pim_tpu.geom.cornell import build_cornell_box as jax_cornell
from pim_tpu.geom.entities import flatten as jax_flatten
from pim_tpu.math import sampling as jsamp
from pim_tpu.math.vec3 import V3 as JV3
from pim_tpu.render import lightmap as jlm
from pim_tpu.render.scene import build_scene as jax_build_scene
from pim_tpu_torch.core.crate import Crate
from pim_tpu_torch.geom.cornell import build_cornell_box
from pim_tpu_torch.geom.entities import flatten
from pim_tpu_torch.math.sphgauss import GI_AXII
from pim_tpu_torch.render import lightmap
from pim_tpu_torch.render.scene import from_jax_scene

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNCES = 3
DENSITY = 1.0
FAKE_BOUNCES = 7  # a separate compiled bake_step for the stand-in radiance
FOLD_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def scenes():
    ents, pool = jax_cornell("boxes")
    with pallas_interpret():
        jm, ja, jl = jax_build_scene(ents, pool, backend="pallas")
    port = from_jax_scene(dataclasses.asdict(jm),
                          {k: np.asarray(v) for k, v in ja._asdict().items()},
                          {k: np.asarray(v) for k, v in jl._asdict().items()}, "cpu")
    return (jm, ja, jl), port, jax_flatten(ents).positions


@pytest.fixture(scope="module")
def packs(scenes):
    positions = scenes[2]
    jpack = jlm.pack_lightmaps(positions, positions, texels_per_meter=DENSITY)
    return jpack, lightmap.pack_lightmaps(positions, positions, texels_per_meter=DENSITY,
                                          device="cpu")


def _same_pack(pack, jpack):
    assert pack.size == jpack.size and pack.texels_per_meter == jpack.texels_per_meter
    for f in ("position", "normal", "sample_counts", "probes", "axii"):
        np.testing.assert_array_equal(getattr(pack, f).numpy(), np.asarray(getattr(jpack, f)),
                                      err_msg=f)


@pytest.mark.parametrize("density,atlas_size", [(1.0, None), (4.0, None), (1.0, 128),
                                                (4.0, 16)],
                         ids=["1_per_m", "4_per_m", "fixed_128", "overflow_16"])
def test_pack_cornell_bitwise(scenes, density, atlas_size):
    positions = scenes[2]
    _same_pack(lightmap.pack_lightmaps(positions, positions, density, atlas_size, device="cpu"),
               jlm.pack_lightmaps(positions, positions, density, atlas_size))


def test_port_flatten_gives_the_reference_soup(scenes):
    ents, _ = build_cornell_box("boxes")
    np.testing.assert_array_equal(flatten(ents).positions, scenes[2])


def test_pack_e1m1_equals_the_committed_lmpack():
    from pim_tpu_torch.geom.gltf import load_gltf_scene

    ents, _ = load_gltf_scene(os.path.join(ROOT, "data", "e1m1", "glTF", "e1m1.gltf"))
    flat = flatten(ents)
    pack = lightmap.pack_lightmaps(flat.positions, flat.normals, 4.0, device="cpu")
    want = Crate.load(os.path.join(ROOT, "data", "e1m1", "lmpack.npz")).get("e1m1_lmpack")
    assert pack.size == int(want["size"]) == 1024
    np.testing.assert_array_equal(pack.position.numpy(), want["position"])
    np.testing.assert_array_equal(pack.normal.numpy(), want["normal"])
    np.testing.assert_array_equal(pack.sample_counts.numpy() > 0, want["sample_counts"] > 0)
    assert int((pack.sample_counts > 0).sum()) == 87159


SHARDS = {"whole": [(0, None)], "two_shards": [(0, 1536), (1536, 4096 - 1536)]}


def _jax_rays(jpack, frame, off, count):
    """The reference bake_step's rays, op for op (pim_tpu/render/lightmap.py)."""
    sl = slice(off, off + count)
    pos = JV3(*(jpack.position[i, sl] for i in range(3)))
    nrm = JV3(*(jpack.normal[i, sl] for i in range(3)))
    alive = jpack.sample_counts[sl] > 0.0
    state = jrng.make_state(jnp.arange(count, dtype=jnp.uint32) + off, jnp.uint32(frame),
                            seed=0x1A57)
    safe_n = JV3(jnp.where(alive, nrm.x, 0.0), jnp.where(alive, nrm.y, 0.0),
                 jnp.where(alive, nrm.z, 1.0))
    tan, bit = jsamp.normal_to_tbn(safe_n)
    state, (hu, hv) = jrng.next_f32x2(state)
    l_ts = jsamp.sample_unit_hemisphere(hu, hv)
    rd = tan * l_ts.x + bit * l_ts.y + safe_n * l_ts.z
    mpt = 1.0 / jpack.texels_per_meter
    state, (ju, jv) = jrng.next_f32x2(state)
    ro = pos + safe_n * 1e-3 + tan * ((ju - 0.5) * mpt) + bit * ((jv - 0.5) * mpt)
    return state, ro, rd


@pytest.mark.parametrize("frame,off,count", [(0, 0, 4096), (5, 1536, 2560),
                                             (0xFFFFFFFF, 100, 900)])
def test_bake_rng_words_and_rays(packs, frame, off, count):
    jpack, pack = packs
    js, jro, jrd = _jax_rays(jpack, frame, off, count)
    got = lightmap.bake_rays(pack, frame, off, count)
    for a, b in zip(js, got.state):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(np.int64))
    for a, b in zip(list(jro) + list(jrd), list(got.ro) + list(got.rd)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)


class _Traced(NamedTuple):
    color: object


def _stand_in(xp, ro, rd):
    """A radiance per ray, the same formula in both packages."""
    return _Traced(xp.stack([xp.abs(rd.x) + 0.25, xp.abs(rd.y) * 2.0,
                             xp.abs(rd.z) + xp.abs(ro.x) * 0.1], -1))


def _bake_both(scenes, packs, shards, bounces, passes=2):
    (jm, ja, jl), (m, a, l), _ = scenes
    jpack, pack = packs
    for frame in range(passes):
        for off, count in shards:
            with pallas_interpret():
                jpack = jax.block_until_ready(jlm.bake_step(
                    jm, ja, jl, jpack, frame, max_bounces=bounces, texel_offset=off,
                    texel_count=count))
            pack = lightmap.bake_step(m, a, l, pack, frame, max_bounces=bounces,
                                      texel_offset=off, texel_count=count)
    return jpack, pack


@pytest.mark.parametrize("shards", list(SHARDS))
def test_bake_fold_matches(scenes, packs, shards, monkeypatch):
    monkeypatch.setattr(jlm, "trace_rays",
                        lambda meta, arrays, lights, ro, rd, state, b: _stand_in(jnp, ro, rd))
    monkeypatch.setattr(lightmap, "trace_rays",
                        lambda meta, arrays, lights, ro, rd, state, b: _stand_in(torch, ro, rd))
    jpack, pack = _bake_both(scenes, packs, SHARDS[shards], FAKE_BOUNCES)
    np.testing.assert_array_equal(pack.sample_counts.numpy(), np.asarray(jpack.sample_counts))
    np.testing.assert_allclose(pack.probes.numpy(), np.asarray(jpack.probes), **FOLD_TOL)
    live = pack.sample_counts.numpy() > 0
    assert (pack.probes.numpy()[~live] == 0).all() and pack.probes.numpy()[live].max() > 0


@pytest.fixture(scope="module")
def traced(scenes, packs):
    return _bake_both(scenes, packs, SHARDS["whole"], BOUNCES)


def test_bake_traced_matches(traced, packs):
    jpack, pack = traced
    counts = pack.sample_counts.numpy()
    np.testing.assert_array_equal(counts, np.asarray(jpack.sample_counts))
    live = packs[1].sample_counts.numpy() > 0
    assert (counts[live] == 3).all() and (counts[~live] == 0).all()
    got, want = pack.probes.numpy()[live], np.asarray(jpack.probes)[live]
    assert np.isfinite(got).all() and (got[..., :3] >= 0).all()
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).mean()
    assert close >= 0.97, close
    assert abs(got.mean() - want.mean()) <= 0.02 * abs(want.mean())


def test_sharded_bake_bit_identical(scenes, packs):
    _, (m, a, l), _ = scenes
    whole = sharded = packs[1]
    for frame in range(2):
        whole = lightmap.bake_step(m, a, l, whole, frame, max_bounces=BOUNCES)
        for off, count in SHARDS["two_shards"]:
            sharded = lightmap.bake_step(m, a, l, sharded, frame, max_bounces=BOUNCES,
                                         texel_offset=off, texel_count=count)
    assert torch.equal(whole.probes, sharded.probes)
    assert torch.equal(whole.sample_counts, sharded.sample_counts)


def test_lightmap_irradiance_matches(traced):
    jpack, pack = traced
    nrm = pack.normal.T.contiguous()
    # the same probes in both, so only the evaluation is compared
    jsame = jpack._replace(probes=jnp.asarray(pack.probes.numpy()))
    np.testing.assert_allclose(lightmap.lightmap_irradiance(pack, nrm).numpy(),
                               np.asarray(jlm.lightmap_irradiance(jsame, jnp.asarray(nrm.numpy()))),
                               rtol=2e-6, atol=1e-6)


def test_crate_entries(traced, tmp_path):
    jpack, pack = traced
    entry = lightmap.lmpack_to_crate_entry(pack)
    assert entry["version"] == 2 and set(entry) == set(jlm.lmpack_to_crate_entry(jpack))
    c = Crate()
    c.set("lm", entry)
    c.save(str(tmp_path / "lm.crate"))
    back = lightmap.lmpack_from_crate_entry(Crate.load(str(tmp_path / "lm.crate")).get("lm"),
                                            "cpu")
    for f in ("position", "normal", "probes", "sample_counts", "axii"):
        assert torch.equal(getattr(back, f), getattr(pack, f)), f
    assert (back.size, back.texels_per_meter) == (pack.size, pack.texels_per_meter)
    # the JAX package's entry, and one without axii (as its checkpoint writes)
    jentry = jlm.lmpack_to_crate_entry(jpack)
    for e in (jentry, {k: v for k, v in jentry.items() if k not in ("axii", "version")}):
        got = lightmap.lmpack_from_crate_entry(e, "cpu")
        np.testing.assert_array_equal(got.probes.numpy(), np.asarray(jpack.probes))
        np.testing.assert_array_equal(got.axii.numpy(), GI_AXII)


def test_compacted_tool_on_cornell(tmp_path):
    """pim_tpu_torch/tools/bake_e1m1_lightmap.py's bake on the CPU, on
    Cornell at 1 texel/m (its e1m1 scene needs the card): the crate resume
    is bit-identical, every live texel took 4 passes and dead ones none,
    and the result is the bake of the compacted view keyed by its own
    lane indices (ROADMAP F12) scattered back into the atlas."""
    from pim_tpu_torch.app import build_cornell_scene
    from pim_tpu_torch.render.screenshot import read_png
    from pim_tpu_torch.tools import bake_e1m1_lightmap as tool

    scene = build_cornell_scene("cpu")
    ents, _ = build_cornell_box("boxes")
    flat = flatten(ents)
    pack = lightmap.pack_lightmaps(flat.positions, flat.normals, DENSITY, device="cpu")
    out = tool.bake(scene, pack, 4, str(tmp_path), bounces=2, log=lambda *_: None)
    assert out["resume_bit_identical"] and out["n_live"] == 1858 and out["chunk"] == 4096
    counts = out["pack"].sample_counts.numpy()
    live = pack.sample_counts.numpy() > 0
    assert (counts[live] == 5).all() and (counts[~live] == 0).all()
    view = tool.Compacted.of(pack)
    dense = view.compact(pack)
    for frame in range(4):
        dense = lightmap.bake_step(*scene, dense, frame, max_bounces=2)
    assert torch.equal(view.scatter_back(pack, dense).probes, out["pack"].probes)
    back = lightmap.lmpack_from_crate_entry(Crate.load(out["crate"]).get(tool.CRATE_KEY), "cpu")
    assert torch.equal(back.probes, out["pack"].probes)
    img = read_png(out["preview"])
    assert img.ndim == 3 and img.shape[1] == 64 and img.any()


def _load_band_calibrator():
    """tools/calibrate_torch_bake_band.py, the JAX-side tool that derived
    the band (it is no module of either package)."""
    path = os.path.join(ROOT, "tools", "calibrate_torch_bake_band.py")
    spec = importlib.util.spec_from_file_location("calibrate_torch_bake_band", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


BAND_PATH = os.path.join(ROOT, "pim_tpu_torch", "render", "bake_bands.json")


def test_bake_band_is_cpu_derived_and_pools_its_runs():
    """The band chip_smoke.py holds the card's 64-pass Cornell lightmap to:
    pim_tpu on the CPU, three runs from frames 0, 64 and 128 at the shell's
    defaults (4 texels/m, 10 bounces), pooled as the tool pools them."""
    cal = _load_band_calibrator()
    with open(BAND_PATH) as f:
        rec = json.load(f)["cornell_lightmap"]
    assert (rec["device"], rec["package"]) == ("cpu", "pim_tpu")
    assert [r["start_frame"] for r in rec["runs"]] == list(cal.STARTS) == [0, 64, 128]
    assert (rec["passes"], rec["bounces"], rec["texels_per_meter"]) == (cal.PASSES, cal.BOUNCES,
                                                                         cal.DENSITY)
    # the shell's defaults (core/cvars.py: pt_max_bounces 10, lm_density 4)
    assert (cal.BOUNCES, cal.DENSITY) == (10, 4.0)
    want = cal.pool_band([r["mean"] for r in rec["runs"]])
    assert {k: rec[k] for k in want} == want
    assert rec["half"] >= 0.01 * rec["mean"] and rec["atlas"] == 256 and rec["live_texels"] == 22342


@pytest.mark.slow
def test_rederive_the_bake_band():
    """pim_tpu bakes the three 64-pass runs again on the CPU; each run's
    mean matches the recorded one."""
    cal = _load_band_calibrator()
    with open(BAND_PATH) as f:
        rec = json.load(f)["cornell_lightmap"]
    got = cal.calibrate()["cornell_lightmap"]
    np.testing.assert_allclose([r["mean"] for r in got["runs"]],
                               [r["mean"] for r in rec["runs"]], rtol=1e-5)
