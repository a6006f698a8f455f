#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`pim_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure raises and
exits non-zero:
  1. require a CUDA device; print the card's name and power limit;
  2. build the kernels from pim_tpu_torch/csrc/ (one nvcc per source, all
     at once, sm_90a);
  3. the Cornell slice: hold K1/K2/K3 against their plain PyTorch versions
     on the card at the frame's shapes (K1/K2: 262,144 rays against the
     Cornell BW rows, about 10% dead lanes and one fully dead 2048-ray run;
     K3: the three real tables and a random [48, 4096] table, indices
     including -1 and T) and time both (median, min and max of 25 runs,
     CUDA events); then its main path: build the Cornell scene on the card
     and render the 512^2, 10-bounce frame at 16 spp per step for 3 steps
     through `pim_tpu_torch.app`, with the launch counts set to 0 just
     before and read just after; the mean must lie in the `cornell512`
     band of pim_tpu/render/bench_gate_bands.json and K1-K3 must have
     launched; a small frame on the card must agree with the CPU's;
  4. the e1m1 slice: its main path (the map built on the card, sky and
     light grid included, then the 512^2, 10-bounce, 1-spp-per-step frame
     for 16 steps with the exposure pass), counted as above; the frame must
     be finite and K3-K6 must have launched during it.  Then K4/K5
     (262,144 rays from the e1m1 camera and one seeded bounce, ~10% dead
     lanes and one fully dead run; the brute-force plain versions on the
     first PLAIN_LANES lanes, timed over PLAIN_RUNS runs) and K6 (atlas:
     K=2 x 262,144 queries, C=4; sky: the [12, 6*32*32] cube, 262,144
     queries, C=3) against their plain versions, bitwise; K3 on the four
     tables the frame fetches from (the [48, 81552] tri table, the [5, 71]
     texture records, the light table over the grid's cells and the
     [24, 600] emissive table), indices including -1 and T, bitwise; the
     build's parts timed; the 128^2, 16-spp frame gated by the CPU-anchored `e1m1_128`
     band of pim_tpu_torch/render/gate_bands.json (the 512^2 mean is printed
     beside the reference's TPU drift band, for information only); a 32^2,
     3-bounce frame on the card against the same frame on the CPU.
Before the last line come a JSON object of per-kernel results (`launches`
summed over the main paths that run the kernel, each path's count in
`launches_by_path`) and the card's nvidia-smi name and power limit; the last line is
`{"ok": true, "device": {...}}`.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH = HEIGHT = 512
BOUNCES = 10
SPP = 16
STEPS = 3
E1M1_STEPS = 16
GATE_RES = 128
N_RAYS = WIDTH * HEIGHT
TIMING_RUNS = 25
PLAIN_LANES = 32768   # lanes on which the brute-force plain K4/K5 are compared
PLAIN_RUNS = 3        # and timed


def _time_ms(fn, runs: int = TIMING_RUNS):
    """(median, min, max) of `runs` CUDA-event timings of `fn`, in ms."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), min(times), max(times)


def _time_pair(label: str, kernel, plain, plain_runs: int = TIMING_RUNS):
    """Times a kernel and its plain version; prints both; returns
    (median, min, max) of each."""
    k = _time_ms(kernel)
    p = _time_ms(plain, plain_runs)
    print(f"{label}: kernel {k[0]:.4f} ms [min {k[1]:.4f}, max {k[2]:.4f}], "
          f"plain {p[0]:.4f} ms [min {p[1]:.4f}, max {p[2]:.4f}] over {plain_runs} runs")
    return k, p


def _row(max_abs_err: float, k, p) -> dict:
    """A kernel's row of the JSON report: its error against the plain
    version and both times, median [min, max] in ms."""
    return dict(max_abs_err=max_abs_err, ms=k[0], ms_min=k[1], ms_max=k[2],
                plain_ms=p[0], plain_ms_min=p[1], plain_ms_max=p[2])


def _bits_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _seeded_rays(dev):
    """262,144 seeded rays inside the box; ~10% dead lanes plus one fully
    dead 2048-ray run."""
    import numpy as np
    import torch

    from pim_tpu_torch.math.vec3 import V3

    rs = np.random.default_rng(1234)
    ro = rs.uniform(-4.9, 4.9, (3, N_RAYS)).astype(np.float32)
    d = rs.normal(size=(3, N_RAYS))
    d = (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)
    t_far = np.where(rs.random(N_RAYS) < 0.1, 0.0, 1e6).astype(np.float32)
    t_far[5 * 2048 : 6 * 2048] = 0.0

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return V3(*(cuda(c) for c in ro)), V3(*(cuda(c) for c in d)), cuda(t_far)


def check_kernels(dev, cpu_scene):
    """K1/K2/K3 against their plain versions on the card."""
    import numpy as np
    import torch

    from pim_tpu_torch.math.vec3 import RCP_EPS
    from pim_tpu_torch.render import dense_kernels as dk
    from pim_tpu_torch.render.lights import make_light_table

    meta, arrays, lights = cpu_scene
    tris12 = arrays.tris12.to(dev)
    ro, rd, t_far = _seeded_rays(dev)
    dead = t_far <= 0.0
    results = {}

    # K1: closest hit
    t_k, tri_k = dk.dense_isect(tris12, ro, rd, 0.0, t_far)
    t_p, tri_p = dk.dense_isect_plain(tris12, ro, rd, 0.0, t_far)
    torch.cuda.synchronize()
    tri_diff = int((tri_k != tri_p).sum())
    t_diff = int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum())
    hits = int((tri_k >= 0).sum())
    print(f"K1 dense_isect: rays={N_RAYS} hits={hits} tri_id_diffs={tri_diff} "
          f"t_bit_diffs={t_diff} dead_lanes={int(dead.sum())} "
          f"dead_misses={int(((tri_k == -1) & dead).sum())}")
    if tri_diff or t_diff:
        raise AssertionError(f"K1 differs from its plain version: {tri_diff} tri ids, "
                             f"{t_diff} t values")
    if not bool(((tri_k == -1) & (t_k == -1.0))[dead].all()):
        raise AssertionError("K1: a dead lane reported a hit")
    # one t_far for all rays, as the primary rays pass it
    t_s, tri_s = dk.dense_isect(tris12, ro, rd, 0.0, RCP_EPS)
    t_sp, tri_sp = dk.dense_isect_plain(tris12, ro, rd, 0.0, RCP_EPS)
    scalar_diff = int((tri_s != tri_sp).sum()
                      + (t_s.view(torch.int32) != t_sp.view(torch.int32)).sum())
    print(f"K1 dense_isect, one t_far for all rays: diffs={scalar_diff}")
    if scalar_diff:
        raise AssertionError(f"K1 with one t_far differs from its plain version: {scalar_diff}")
    times = _time_pair("K1 time", lambda: dk.dense_isect(tris12, ro, rd, 0.0, t_far),
                       lambda: dk.dense_isect_plain(tris12, ro, rd, 0.0, t_far))
    results["dense_isect"] = _row(float((t_k - t_p).abs().max()), *times)

    # K2: any hit (shadow rays to a finite distance)
    t_far2 = torch.where(dead, 0.0, 3.0)
    h_k = dk.dense_anyhit(tris12, ro, rd, 0.0, t_far2)
    h_p = dk.dense_anyhit_plain(tris12, ro, rd, 0.0, t_far2)
    torch.cuda.synchronize()
    flag_diff = int((h_k != h_p).sum())
    print(f"K2 dense_anyhit: blocked={int(h_k.sum())} flag_diffs={flag_diff} "
          f"dead_reporting_1={int(h_k[dead].sum())}/{int(dead.sum())}")
    if flag_diff:
        raise AssertionError(f"K2 differs from its plain version on {flag_diff} rays")
    if not bool((h_k[dead] == 1).all()):
        raise AssertionError("K2: a dead lane did not report 1")
    times = _time_pair("K2 time", lambda: dk.dense_anyhit(tris12, ro, rd, 0.0, t_far2),
                       lambda: dk.dense_anyhit_plain(tris12, ro, rd, 0.0, t_far2))
    results["dense_anyhit"] = _row(float((h_k - h_p).abs().max()), *times)

    # K3: the three real tables and a random one; indices include -1 and T
    rs = np.random.default_rng(99)
    tables = {
        "tri_table": arrays.tri_table,
        "light_table": make_light_table(lights, arrays.cell_active_f),
        "emissive_table": arrays.emissive_table,
        "random_48x4096": torch.from_numpy(
            rs.standard_normal((48, 4096)).astype(np.float32)),
    }
    k3_err, k3_times = check_gather_cols(dev, "cornell", tables, rs)
    results["gather_cols"] = _row(k3_err, *k3_times["tri_table"])
    return results


def check_gather_cols(dev, scene_name: str, tables, rs):
    """K3 against its plain version on each table at N_RAYS seeded indices
    (-1 and T among them), bitwise; returns (max abs error, {table: times})."""
    import numpy as np
    import torch

    from pim_tpu_torch.render import gather_kernel as gk

    err = 0.0
    times = {}
    for name, table in tables.items():
        table = table.to(dev).contiguous()
        t = table.shape[1]
        idx = torch.from_numpy(rs.integers(-1, t + 1, N_RAYS).astype(np.int32)).to(dev)
        idx[:2] = torch.tensor([-1, t], dtype=torch.int32)
        out_k = gk.gather_cols(table, idx)
        out_p = gk.gather_cols_plain(table, idx)
        torch.cuda.synchronize()
        same = _bits_equal(out_k, out_p)
        print(f"K3 gather_cols[{scene_name} {name}] {tuple(table.shape)} x {N_RAYS}: "
              f"bitwise_equal={same}")
        if not same:
            raise AssertionError(f"K3 differs from its plain version on {scene_name} {name}")
        err = max(err, float((out_k - out_p).abs().max()))
        times[name] = _time_pair(f"K3 time[{scene_name} {name}]",
                                 lambda: gk.gather_cols(table, idx),
                                 lambda: gk.gather_cols_plain(table, idx))
    return err, times


CORNELL_KERNELS = ("dense_isect", "dense_anyhit", "gather_cols")
E1M1_KERNELS = ("cluster_isect", "cluster_anyhit", "gather_bilinear")
SOURCES = {
    "dense_isect": ("pim_tpu_torch/csrc/dense_isect.cu", "pim_tpu/render/pallas_kernels.py:149"),
    "dense_anyhit": ("pim_tpu_torch/csrc/dense_isect.cu", "pim_tpu/render/pallas_kernels.py:183"),
    "gather_cols": ("pim_tpu_torch/csrc/gather_cols.cu", "pim_tpu/render/gather_kernel.py:73"),
    "cluster_isect": ("pim_tpu_torch/csrc/cluster_isect.cu", "pim_tpu/render/cluster.py:277"),
    "cluster_anyhit": ("pim_tpu_torch/csrc/cluster_isect.cu", "pim_tpu/render/cluster.py:345"),
    "gather_bilinear": ("pim_tpu_torch/csrc/gather_bilinear.cu",
                        "pim_tpu/render/table_gather.py:171"),
}


def _band(path, name):
    with open(os.path.join(ROOT, path)) as f:
        band = json.load(f)[name]
    return band["mean"] - band["half"], band["mean"] + band["half"]


def _scene_to(scene, dev):
    """A copy of (meta, arrays, lights) with every tensor on `dev`."""
    import dataclasses

    meta, arrays, lights = scene
    return (meta,
            dataclasses.replace(arrays, **{f.name: getattr(arrays, f.name).to(dev)
                                           for f in dataclasses.fields(arrays)}),
            dataclasses.replace(lights, **{f.name: getattr(lights, f.name).to(dev)
                                           for f in dataclasses.fields(lights)}))


def check_small_frame(name: str, card_scene, cpu_scene) -> None:
    """A 32^2, 3-bounce, 1-spp frame on the card against the same frame on
    the CPU (plain versions), from copies of one scene."""
    import numpy as np

    from pim_tpu_torch.app import bench_camera, render_step

    cam = bench_camera(name, 32, 32)
    t0 = time.perf_counter()
    gpu = render_step(card_scene, cam, 32, 32, 3, 1, 0).color.cpu().numpy()
    cpu = render_step(cpu_scene, cam, 32, 32, 3, 1, 0).color.numpy()
    close = np.all(np.isclose(gpu, cpu, rtol=1e-4, atol=1e-5), axis=-1).mean()
    rel = abs(gpu.mean() - cpu.mean()) / cpu.mean()
    print(f"{name} small frame 32^2 card vs cpu: pixels_close={close:.4f} "
          f"mean_rel_diff={rel:.6f} ({time.perf_counter() - t0:.1f} s)")
    if not np.isfinite(gpu).all() or close < 0.97 or rel > 0.02:
        raise AssertionError(f"the card's small {name} frame disagrees with the CPU frame")


def _frame_line(label, fr) -> str:
    exp = "" if fr.exposure is None else f" exposure={fr.exposure:.6g}"
    return (f"{label}: mean={fr.mean:.6f} stddev={fr.stddev:.6f}{exp} rays={fr.rays:.0f} "
            f"ms/step={fr.ms_per_step:.3f} Mrays/s={fr.mrays_per_s:.4f} "
            f"step_s={[round(s, 4) for s in fr.step_seconds]}")


def _check_frame(fr, n_pixels: int, kernels) -> None:
    import torch

    if not bool(torch.isfinite(fr.buffers.color).all()):
        raise AssertionError("the frame holds non-finite values")
    if tuple(fr.buffers.color.shape) != (n_pixels, 3):
        raise AssertionError(f"frame shape {tuple(fr.buffers.color.shape)}")
    for name in kernels:
        if fr.launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched during the frame")


def run_cornell(dev):
    """Phase 3; returns (kernel rows, launches of the main path)."""
    import torch

    from pim_tpu_torch import native
    from pim_tpu_torch.app import build_cornell_scene, render_frame

    cpu_scene = build_cornell_scene("cpu")
    kernels = check_kernels(dev, cpu_scene)

    native.reset_launches()
    t0 = time.perf_counter()
    scene = build_cornell_scene(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = dict(native.launches)
    fr = render_frame(scene, "cornell", WIDTH, HEIGHT, BOUNCES, SPP, STEPS)
    launches = dict(native.launches)
    lo, hi = _band("pim_tpu/render/bench_gate_bands.json", "cornell512")
    print(f"cornell scene build on card: {build_s:.3f} s, launches {build_launches}")
    print(_frame_line(f"cornell frame {WIDTH}x{HEIGHT} bounces={BOUNCES} spp/step={SPP} "
                      f"steps={STEPS} band=[{lo:.6f}, {hi:.6f}]", fr))
    print(f"cornell launches during build+frame: {launches}")
    _check_frame(fr, WIDTH * HEIGHT, CORNELL_KERNELS)
    if not lo <= fr.mean <= hi:
        raise AssertionError(f"frame mean {fr.mean} outside the cornell512 band [{lo}, {hi}]")
    check_small_frame("cornell", _scene_to(cpu_scene, dev), cpu_scene)
    return kernels, launches


def _e1m1_rays(dev, scene):
    """262,144 rays of one seeded bounce off the e1m1 primary hits, ~10%
    dead lanes and one fully dead 2048-ray run: (ro, rd, t_far for closest
    hits, t_far for shadow-like any hits)."""
    import numpy as np
    import torch

    from pim_tpu_torch.app import bench_camera
    from pim_tpu_torch.core import rng
    from pim_tpu_torch.math.vec3 import RCP_EPS, V3, normalize, where3
    from pim_tpu_torch.render.camera import generate_primary_rays
    from pim_tpu_torch.render.scene import intersect_raw

    meta, arrays, _ = scene
    state = rng.make_state(torch.arange(N_RAYS, device=dev), 0)
    _, ro, rd = generate_primary_rays(bench_camera("e1m1", WIDTH, HEIGHT), WIDTH, HEIGHT, state)
    t, tri = intersect_raw(meta, arrays, ro, rd, 0.0, RCP_EPS)
    origin = where3(tri >= 0, ro + rd * (t * 0.999), ro)
    rs = np.random.default_rng(4321)

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    d = rs.normal(size=(3, N_RAYS))
    rd2 = normalize(V3(*(cuda(c) for c in d)))
    dead = rs.random(N_RAYS) < 0.1
    dead[5 * 2048 : 6 * 2048] = True
    t_far = cuda(np.where(dead, 0.0, 1e6))
    t_far_short = cuda(np.where(dead, 0.0, rs.uniform(0.5, 10.0, N_RAYS)))
    return (V3(*(c.contiguous() for c in origin)), V3(*(c.contiguous() for c in rd2)),
            t_far, t_far_short)


def check_e1m1_kernels(dev, scene):
    """K4/K5/K6 against their plain versions at the e1m1 shapes."""
    import numpy as np
    import torch

    from pim_tpu_torch.math.vec3 import V3
    from pim_tpu_torch.render import cluster as CL
    from pim_tpu_torch.render import table_gather as tg
    from pim_tpu_torch.render.lights import make_light_table
    from pim_tpu_torch.render.raysort import sorted_rays

    meta, arrays, lights = scene
    cl = CL.ClusterArrays(tris=arrays.cl_tris, clb=arrays.cl_clb, scb=arrays.cl_scb)
    ro, rd, t_far, t_short = _e1m1_rays(dev, scene)
    dead = t_far <= 0.0
    sub = slice(0, PLAIN_LANES)
    ro_s, rd_s = V3(*(c[sub] for c in ro)), V3(*(c[sub] for c in rd))
    print(f"e1m1 hierarchy: tris {tuple(cl.tris.shape)} clb {tuple(cl.clb.shape)} "
          f"scb {tuple(cl.scb.shape)}; rays {N_RAYS}, dead {int(dead.sum())}, "
          f"plain compared on lanes [0, {PLAIN_LANES})")
    results = {}

    t_k, tri_k = CL.cluster_isect(cl, ro, rd, 0.0, t_far)
    t_p, tri_p = CL.cluster_isect_plain(cl, ro_s, rd_s, 0.0, t_far[sub])
    torch.cuda.synchronize()
    tri_diff = int((tri_k[sub] != tri_p).sum())
    t_diff = int((t_k[sub].view(torch.int32) != t_p.view(torch.int32)).sum())
    print(f"K4 cluster_isect: hits={int((tri_k >= 0).sum())} tri_id_diffs={tri_diff} "
          f"t_bit_diffs={t_diff} (on {PLAIN_LANES} lanes) dead_misses="
          f"{int(((tri_k == -1) & dead).sum())}/{int(dead.sum())}")
    if tri_diff or t_diff:
        raise AssertionError(f"K4 differs from its plain version: {tri_diff} ids, {t_diff} t")
    if not bool(((tri_k == -1) & (t_k == -1.0))[dead].all()):
        raise AssertionError("K4: a dead lane reported a hit")
    times = _time_pair("K4 time", lambda: CL.cluster_isect(cl, ro, rd, 0.0, t_far),
                       lambda: CL.cluster_isect_plain(cl, ro_s, rd_s, 0.0, t_far[sub]),
                       PLAIN_RUNS)
    results["cluster_isect"] = _row(float((t_k[sub] - t_p).abs().max()), *times)
    sro, srd, stf, _ = sorted_rays(meta.grid_spec(), ro, rd, t_far)
    k_sorted = _time_ms(lambda: CL.cluster_isect(cl, sro, srd, 0.0, stf))
    print(f"K4 time on the same rays sorted by raysort: {k_sorted[0]:.4f} ms "
          f"[min {k_sorted[1]:.4f}, max {k_sorted[2]:.4f}]")

    h_k = CL.cluster_anyhit(cl, ro, rd, 0.0, t_short)
    h_p = CL.cluster_anyhit_plain(cl, ro_s, rd_s, 0.0, t_short[sub])
    torch.cuda.synchronize()
    flag_diff = int((h_k[sub] != h_p).sum())
    print(f"K5 cluster_anyhit: blocked={int(h_k.sum())} flag_diffs={flag_diff} (on "
          f"{PLAIN_LANES} lanes) dead_reporting_1={int(h_k[dead].sum())}/{int(dead.sum())}")
    if flag_diff:
        raise AssertionError(f"K5 differs from its plain version on {flag_diff} rays")
    if bool(h_k[dead].any()):
        raise AssertionError("K5: a dead lane reported a hit")
    times = _time_pair("K5 time", lambda: CL.cluster_anyhit(cl, ro, rd, 0.0, t_short),
                       lambda: CL.cluster_anyhit_plain(cl, ro_s, rd_s, 0.0, t_short[sub]),
                       PLAIN_RUNS)
    results["cluster_anyhit"] = _row(float((h_k[sub] - h_p).abs().max()), *times)

    rs = np.random.default_rng(77)
    k6_err = 0.0
    k6_times = {}
    for label, planes, c, k in (("atlas", arrays.atlas_corners, 4, 2),
                                ("sky", arrays.sky_corners, 3, 1)):
        t = planes.shape[1]
        idx = rs.integers(0, t, (k, N_RAYS)).astype(np.int32)
        idx[0, :2] = [-1, t]
        tx = rs.random((k, N_RAYS), dtype=np.float32)
        ty = rs.random((k, N_RAYS), dtype=np.float32)
        valid = rs.random((k, N_RAYS)) < 0.8
        tx[~valid] = np.nan
        args = [torch.from_numpy(x).to(dev) for x in (idx, tx, ty, valid)]
        out_k = tg.gather_bilinear(planes, *args, c=c)
        out_p = tg.gather_bilinear_plain(planes, *args, c=c)
        torch.cuda.synchronize()
        same = _bits_equal(out_k, out_p)
        print(f"K6 gather_bilinear[{label}] planes {tuple(planes.shape)} x [{k}, {N_RAYS}] "
              f"C={c}: bitwise_equal={same} finite={bool(torch.isfinite(out_k).all())}")
        if not same:
            raise AssertionError(f"K6 differs from its plain version on the {label}")
        k6_err = max(k6_err, float((out_k - out_p).abs().max()))
        k6_times[label] = _time_pair(f"K6 time[{label}]",
                                     lambda: tg.gather_bilinear(planes, *args, c=c),
                                     lambda: tg.gather_bilinear_plain(planes, *args, c=c))
    results["gather_bilinear"] = _row(k6_err, *k6_times["atlas"])

    # K3 on the four tables the e1m1 frame fetches from
    tables = {
        "tri_table": arrays.tri_table,
        "tex_rec_t": arrays.tex_rec_t,
        "light_table": make_light_table(lights, arrays.cell_active_f),
        "emissive_table": arrays.emissive_table,
    }
    k3_err, k3_times = check_gather_cols(dev, "e1m1", tables, rs)
    results["gather_cols"] = _row(k3_err, *k3_times["tri_table"])
    return results


def time_e1m1_build(dev, scene) -> None:
    """The parts of the e1m1 build, each timed once more on its own."""
    import torch

    from pim_tpu_torch.app import E1M1_GLTF, SKY_SIZE, SKY_STEPS, SUN_DIR, SUN_LUM
    from pim_tpu_torch.geom.gltf import load_gltf_scene
    from pim_tpu_torch.render import cluster as CL
    from pim_tpu_torch.render.scene import bake_light_grid
    from pim_tpu_torch.render.sky import bake_sky_cubemap, earth_atmosphere

    meta, arrays, _ = scene
    t0 = time.perf_counter()
    load_gltf_scene(E1M1_GLTF)
    t1 = time.perf_counter()
    CL.build_clusters(arrays.positions.cpu().numpy())
    t2 = time.perf_counter()
    bake_sky_cubemap(earth_atmosphere(), SUN_DIR, SUN_LUM, SKY_SIZE, SKY_STEPS, device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    bake_light_grid(meta, arrays)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    print(f"e1m1 build parts: glTF load {t1 - t0:.3f} s, cluster build (host) {t2 - t1:.3f} s, "
          f"sky bake {t3 - t2:.3f} s, light grid {t4 - t3:.3f} s "
          f"({meta.grid_len} cells x {meta.emissive_count} emissives x 16 shadow rays)")


def run_e1m1(dev):
    """Phase 4; returns (kernel rows, launches of the main path)."""
    import torch

    from pim_tpu_torch import native
    from pim_tpu_torch.app import build_e1m1_scene, render_frame

    native.reset_launches()
    t0 = time.perf_counter()
    scene = build_e1m1_scene(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = dict(native.launches)
    fr = render_frame(scene, "e1m1", WIDTH, HEIGHT, BOUNCES, 1, E1M1_STEPS)
    launches = dict(native.launches)
    meta = scene[0]
    print(f"e1m1 scene build on card: {build_s:.3f} s ({meta.tri_count} tris, backend "
          f"{meta.backend}, sort_rays {meta.sort_rays}), launches {build_launches}")
    lo, hi = _band("pim_tpu/render/bench_gate_bands.json", "e1m1_512")
    print(_frame_line(f"e1m1 frame {WIDTH}x{HEIGHT} bounces={BOUNCES} spp/step=1 "
                      f"steps={E1M1_STEPS} (TPU drift band [{lo:.4f}, {hi:.4f}], "
                      "for information only)", fr))
    print(f"e1m1 launches during the frame: {fr.launches}")
    print(f"e1m1 launches during build+frame: {launches}")
    _check_frame(fr, WIDTH * HEIGHT, ("gather_cols",) + E1M1_KERNELS)

    kernels = check_e1m1_kernels(dev, scene)
    time_e1m1_build(dev, scene)

    lo, hi = _band("pim_tpu_torch/render/gate_bands.json", "e1m1_128")
    gate = render_frame(scene, "e1m1", GATE_RES, GATE_RES, BOUNCES, 1, 16)
    print(_frame_line(f"e1m1 gate frame {GATE_RES}x{GATE_RES} bounces={BOUNCES} spp=16 "
                      f"band=[{lo:.6f}, {hi:.6f}] (CPU anchor)", gate))
    _check_frame(gate, GATE_RES * GATE_RES, ())
    if not lo <= gate.mean <= hi:
        raise AssertionError(f"e1m1 {GATE_RES}^2 mean {gate.mean} outside the e1m1_128 band "
                             f"[{lo}, {hi}]")
    check_small_frame("e1m1", scene, _scene_to(scene, "cpu"))
    return kernels, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from pim_tpu_torch import native

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    info = native.build_info()
    ptxas = [ln.strip() for ln in info.log.splitlines() if "registers" in ln or "Compiling" in ln]
    print(f"build: {info.path} nvcc {info.seconds:.2f} s (total {time.perf_counter() - t0:.2f} s)")
    for ln in ptxas:
        print(f"  ptxas: {ln}")

    t0 = time.perf_counter()
    kernels, cornell_launches = run_cornell(dev)
    print(f"cornell phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    e1m1_kernels, e1m1_launches = run_e1m1(dev)
    print(f"e1m1 phases: {time.perf_counter() - t0:.1f} s")
    # K3 runs on both paths: its row keeps the Cornell times and adds the
    # e1m1 tri table's; its error is the larger of the two checks
    e1m1_k3 = e1m1_kernels.pop("gather_cols")
    kernels.update(e1m1_kernels)
    k3 = kernels["gather_cols"]
    k3["max_abs_err"] = max(k3["max_abs_err"], e1m1_k3.pop("max_abs_err"))
    k3.update({f"e1m1_{key}": v for key, v in e1m1_k3.items()})
    by_path = {"cornell": cornell_launches, "e1m1": e1m1_launches}
    paths = {name: ("cornell",) for name in CORNELL_KERNELS}
    paths.update({name: ("e1m1",) for name in E1M1_KERNELS})
    paths["gather_cols"] = ("cornell", "e1m1")
    launches = {name: {p: by_path[p][name] for p in ps} for name, ps in paths.items()}
    for name, counts in launches.items():
        for p, count in counts.items():
            if count <= 0:
                raise AssertionError(f"kernel {name} was not launched on the {p} main path")

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": sum(launches[name].values()),
         "launches_by_path": launches[name], **kernels[name]}
        for name in CORNELL_KERNELS + E1M1_KERNELS]}
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
