"""The port's measurement tools on the CPU (pim_tpu_torch/tools/):
bench_cluster's inputs against the JAX tool's, its rows and crossover;
ab_sort, overlap_ab, scaling_bench, corr_check and grad_eps_sweep at small
sizes."""

import dataclasses
import importlib
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pim_tpu_torch.app import build_cornell_scene
from pim_tpu_torch.geom.cornell import build_cornell_box
from pim_tpu_torch.render.scene import build_scene
from pim_tpu_torch.tools import (ab_sort, bench_cluster, corr_check, grad_eps_sweep,
                                 overlap_ab, scaling_bench)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOUP_TRIS = (180, 1088, 7056, 30976, 102800, 277056)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cornell_cpu():
    return build_cornell_scene("cpu")


@pytest.mark.parametrize("soup,tris", list(zip(bench_cluster.SOUPS, SOUP_TRIS)))
def test_bench_cluster_inputs_are_the_jax_tools(soup, tris):
    jtool = _jax_tool("bench_cluster")
    pos = bench_cluster.rooms_soup(*soup)
    want = jtool.rooms_soup(*soup)
    assert pos.dtype == want.dtype == np.float32 and pos.shape == (3 * tris, 3)
    np.testing.assert_array_equal(pos.view(np.int32), want.view(np.int32))
    lo, hi = pos.min(0), pos.max(0)
    for coherent in (True, False):
        for got, exp in zip(bench_cluster.make_rays(bench_cluster.N_RAYS, lo, hi, coherent),
                            jtool.make_rays(bench_cluster.N_RAYS, lo, hi, coherent)):
            assert got.dtype == exp.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.int32), exp.view(np.int32))


def test_bench_cluster_rows_on_the_cpu():
    rows = bench_cluster.run(torch.device("cpu"), 64, 1, bench_cluster.SOUPS[:2])
    assert [(r["tris"], r["rays"]) for r in rows] == [
        (180, "coh"), (180, "inc"), (1088, "coh"), (1088, "inc")]
    for r in rows:
        for k in bench_cluster.KERNELS:
            assert r[f"{k}_ms"] > 0.0 and math.isfinite(r[f"{k}_mrays"])
        # the plain K4 and K5 see the rays K1 and K2 see: same closest t, same flag
        assert r["t_equal"] == 1.0 and r["anyhit_equal"] == 1.0
        # the plain walk (Moller-Trumbore) meets the same triangles
        assert r["bvh_tri_equal"] == 1.0 and r["bvh_anyhit_equal"] == 1.0 and r["bvh_off"] == 0
    assert not bench_cluster.disagreements(rows)
    assert "bvh any" in bench_cluster.table(rows)


def test_crossover_is_the_first_soup_won_on_every_ray_set():
    def row(tris, rays, k1, k4):
        return {"tris": tris, "rays": rays, "k1_ms": k1, "k4_ms": k4}

    rows = [row(180, "coh", 1.0, 2.0), row(180, "inc", 1.0, 2.0),
            row(1088, "coh", 2.0, 1.0), row(1088, "inc", 1.0, 2.0),
            row(7056, "coh", 3.0, 1.0), row(7056, "inc", 3.0, 1.0)]
    assert bench_cluster.crossover(rows) == 7056
    assert bench_cluster.crossover(rows[:4]) is None


def test_ab_sort_images_are_bitwise_equal():
    """Cornell on the cluster backend at 16^2: sorting the rays changes no
    bit of the image and no ray count."""
    scene = build_scene(*build_cornell_box("boxes"), "cpu", backend="cluster")
    r = ab_sort.run(scene, torch.device("cpu"), res=16, bounces=3, iters=1, rounds=2,
                    scene_name="cornell")
    assert r["backend"] == "cluster"
    assert r["images_equal"] and r["rays_equal"] and r["pixels_differing"] == 0
    assert r["nosort_rays"] > 16 * 16 and len(r["sort_rounds_ms"]) == 2


def test_overlap_ab_schedules_give_the_same_parameters(tmp_path):
    """Two gloo ranks on the CPU, Cornell 16^2, 2 steps of each schedule:
    the overlapped and serialized reductions leave the same bits."""
    r = overlap_ab.run(ranks=2, res=16, steps=2, device="cpu", workdir=str(tmp_path))
    assert r["ranks"] == 2 and r["backend"] == "gloo"
    assert r["params_equal"] and r["max_abs_param_diff"] == 0.0
    assert r["losses"]["overlapped"] == r["losses"]["serialized"]
    assert len(r["overlapped_steps_ms"]) == len(r["serialized_steps_ms"]) == 2
    assert math.isfinite(r["benefit"])


def test_scaling_bench_worlds_1_and_2(tmp_path, monkeypatch):
    scaling = os.path.join(ROOT, "SCALING.md")
    before = (open(scaling, "rb").read(), os.stat(scaling).st_mtime_ns)
    for name, value in (("PIM_SCALE_W", "8"), ("PIM_SCALE_H", "8"), ("PIM_SCALE_STEPS", "2"),
                        ("PIM_SCALE_BOUNCES", "1"), ("PIM_SCALE_REPEATS", "1")):
        monkeypatch.setenv(name, value)
    monkeypatch.delenv("PIM_SCALE_MODE", raising=False)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "scaling.md"
    rows = scaling_bench.main(["--device", "cpu", "--out", str(out), "1", "2"])
    assert [r["nprocs"] for r in rows] == [1, 2]
    assert [r["pixels"] for r in rows] == [64, 128]
    for r in rows:
        assert r["mpaths_per_s"] > 0.0 and r["efficiency"] > 0.0
    assert rows[0]["efficiency"] == 1.0
    assert "| efficiency |" in out.read_text()
    assert (open(scaling, "rb").read(), os.stat(scaling).st_mtime_ns) == before
    assert sorted(os.listdir(tmp_path)) == ["scaling.md"]


def _jax_images(res, bounces):
    """The JAX script's 16 one-sample Cornell images at res^2."""
    from pim_tpu.core import rng
    from pim_tpu.geom.cornell import build_cornell_box as jax_cornell
    from pim_tpu.render.camera import Camera, DofInfo, camera_arrays, generate_primary_rays
    from pim_tpu.render.integrator import trace_rays
    from pim_tpu.render.scene import build_scene as jax_build_scene

    meta, arrays, lights = jax_build_scene(*jax_cornell("boxes"), backend="brute")
    cam = Camera(position=np.array([-4, 0, 4], np.float32))
    cam.look_at([0, -1, 0])
    ca = camera_arrays(cam, DofInfo(autofocus=False), res, res)

    @jax.jit
    def step(sample):
        state = rng.make_state(jnp.arange(res * res, dtype=jnp.uint32), sample)
        state, ro, rd = generate_primary_rays(ca, res, res, state)
        return trace_rays(meta, arrays, lights, ro, rd, state, max_bounces=bounces).color

    imgs = np.stack([np.asarray(step(jnp.uint32(s))) for s in range(corr_check.SAMPLES)])
    jax.clear_caches()
    return imgs


def test_corr_check_statistics(cornell_cpu):
    """At 8^2, 4 bounces: finite statistics, and those of the JAX package's
    images within 2% (paths may part after an ulp-level flip)."""
    st = corr_check.statistics(corr_check.images(cornell_cpu, 8, 4))
    flat = [st["max_abs_offdiag_corr"], st["mean_offdiag_corr"], st["img_max"], st["p999"]]
    flat += [v for tag in ("raw", "clip5") for v in st[tag].values()]
    assert all(math.isfinite(v) for v in flat)
    want = corr_check.statistics(_jax_images(8, 4))
    for key in ("mean_offdiag_corr", "img_max", "p999"):
        assert st[key] == pytest.approx(want[key], rel=2e-2), key
    for tag in ("raw", "clip5"):
        assert st[tag]["ratio"] == pytest.approx(want[tag]["ratio"], rel=2e-2), tag
    assert "ratio" in corr_check.report(st)


def test_grad_eps_sweep_ad_meets_a_rung(cornell_cpu):
    """At 8^2, 3 bounces, seed 7: the roughness column's AD derivative
    agrees with a rung of the FD ladder within test_grad.py's roughness
    rtol (8e-2, atol 1e-6)."""
    r = grad_eps_sweep.sweep(cornell_cpu, res=8)
    assert [eps for eps, _ in r["fd"]] == list(grad_eps_sweep.LADDER)
    assert abs(r["ad"]) > 1e-8
    assert any(abs(fd - r["ad"]) <= 8e-2 * abs(r["ad"]) + 1e-6 for _, fd in r["fd"]), r


def test_grad_eps_sweep_ad_matches_jax():
    """At 8^2, 3 bounces, seed 7: the tool's AD derivative against the JAX
    script's (`jax.grad` of pim_tpu.render.diff's loss along the same
    roughness column) within test_torch_diff.py's direction tolerance
    (rtol 1e-3).  As there, the port's scene takes the JAX light state, so
    both sides select the same lights."""
    from pim_tpu.geom.cornell import build_cornell_box as jax_cornell
    from pim_tpu.render import diff as jdiff
    from pim_tpu.render.camera import Camera, DofInfo, camera_arrays
    from pim_tpu.render.scene import build_scene as jax_build_scene
    from pim_tpu_torch.render.scene import LightState

    res = 8
    jm, ja, jl = jax_build_scene(*jax_cornell("boxes"), backend="brute")
    cam = Camera(position=np.array([-4, 0, 4], np.float32))
    cam.look_at([0, -1, 0])
    ca = camera_arrays(cam, DofInfo(autofocus=False), res, res)
    params = jdiff.extract_params(jm, ja, ca)
    loss = jax.jit(jdiff.make_loss_fn(jm, res, res, max_bounces=grad_eps_sweep.BOUNCES))
    args = (ja, jl, ca, jnp.zeros((res * res, 3), jnp.float32), jnp.uint32(grad_eps_sweep.SEED))
    g = jax.grad(lambda p: loss(p, *args)[0])(params)
    want = float(np.sum(np.asarray(g.mat_rome, np.float64)[:, 0]))
    jax.clear_caches()

    m, a, _ = build_scene(*build_cornell_box("boxes"), "cpu", backend="dense")
    a = dataclasses.replace(a, cell_active=torch.from_numpy(np.array(ja.cell_active)),
                            cell_active_f=torch.from_numpy(np.array(ja.cell_active_f)))
    lights = LightState(
        pdf=torch.from_numpy(np.array(jl.pdf)), cdf=torch.from_numpy(np.array(jl.cdf)),
        integral=torch.from_numpy(np.array(jl.integral)),
        sum=torch.from_numpy(np.asarray(jl.sum).astype(np.int64)),
        live=torch.from_numpy(np.asarray(jl.live).astype(np.int64)))
    got = grad_eps_sweep.sweep((m, a, lights), res=res, ladder=())["ad"]
    assert math.isfinite(got) and abs(want) > 1e-8, (got, want)
    assert abs(got - want) <= 1e-3 * abs(want), (got, want)


@pytest.mark.parametrize("module,argv", [
    ("pim_tpu_torch.tools.perf_table", []), ("pim_tpu_torch.tools.ab_sort", []),
    ("pim_tpu_torch.tools.bench_cluster", []),
    ("pim_tpu_torch.tools.scaling_bench", ["1"]), ("pim_tpu_torch.tools.overlap_ab", []),
    ("pim_tpu_torch.tools.corr_check", []), ("pim_tpu_torch.tools.grad_eps_sweep", []),
])
def test_entry_point_runs_on_the_card_unless_asked(module, argv, monkeypatch):
    """With no --device, each measurement module asks for the card, and
    with no card it stops before any work instead of falling back to the
    CPU."""
    mod = importlib.import_module(module)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main(argv)
