#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`pim_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure raises and
exits non-zero:
  1. require a CUDA device; print the card's name and power limit;
  2. build the kernels from pim_tpu_torch/csrc/ (nvcc, sm_90a);
  3. hold each kernel against its plain PyTorch version on the card at the
     frame's shapes (K1/K2: 262,144 rays against the Cornell BW rows, about
     10% dead lanes and one fully dead 2048-ray run; K3: the three real
     tables and a random [48, 4096] table, indices including -1 and T) and
     time both (median, min and max of 25 runs, CUDA events);
  4. build the Cornell scene on the card (light grid baked through the
     kernels) and render the 512^2, 10-bounce frame at 16 spp per step for
     3 steps through `pim_tpu_torch.app`; the image mean must lie in the
     `cornell512` band of pim_tpu/render/bench_gate_bands.json, and every
     kernel must have launched during the build and the frame; then a small
     frame on the card must agree with the same frame on the CPU.
Before the last line come a JSON object of per-kernel results and the
card's nvidia-smi name and power limit; the last line is
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
N_RAYS = WIDTH * HEIGHT
TIMING_RUNS = 25


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


def _time_pair(label: str, kernel, plain):
    """Times a kernel and its plain version; prints both; returns the
    medians."""
    k = _time_ms(kernel)
    p = _time_ms(plain)
    print(f"{label}: kernel {k[0]:.4f} ms [min {k[1]:.4f}, max {k[2]:.4f}], "
          f"plain {p[0]:.4f} ms [min {p[1]:.4f}, max {p[2]:.4f}]")
    return k[0], p[0]


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
    """Phase 3: K1/K2/K3 against their plain versions on the card."""
    import numpy as np
    import torch

    from pim_tpu_torch.math.vec3 import RCP_EPS
    from pim_tpu_torch.render import dense_kernels as dk
    from pim_tpu_torch.render import gather_kernel as gk
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
    ms, plain_ms = _time_pair("K1 time", lambda: dk.dense_isect(tris12, ro, rd, 0.0, t_far),
                              lambda: dk.dense_isect_plain(tris12, ro, rd, 0.0, t_far))
    results["dense_isect"] = dict(max_abs_err=float((t_k - t_p).abs().max()), ms=ms,
                                  plain_ms=plain_ms)

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
    ms, plain_ms = _time_pair("K2 time", lambda: dk.dense_anyhit(tris12, ro, rd, 0.0, t_far2),
                              lambda: dk.dense_anyhit_plain(tris12, ro, rd, 0.0, t_far2))
    results["dense_anyhit"] = dict(max_abs_err=float((h_k - h_p).abs().max()), ms=ms,
                                   plain_ms=plain_ms)

    # K3: the three real tables and a random one; indices include -1 and T
    rs = np.random.default_rng(99)
    tables = {
        "tri_table": arrays.tri_table,
        "light_table": make_light_table(lights, arrays.cell_active_f),
        "emissive_table": arrays.emissive_table,
        "random_48x4096": torch.from_numpy(
            rs.standard_normal((48, 4096)).astype(np.float32)),
    }
    k3_err = 0.0
    k3_times = {}
    for name, table in tables.items():
        table = table.to(dev).contiguous()
        t = table.shape[1]
        idx = torch.from_numpy(rs.integers(-1, t + 1, N_RAYS).astype(np.int32)).to(dev)
        idx[:2] = torch.tensor([-1, t], dtype=torch.int32)
        out_k = gk.gather_cols(table, idx)
        out_p = gk.gather_cols_plain(table, idx)
        torch.cuda.synchronize()
        same = _bits_equal(out_k, out_p)
        print(f"K3 gather_cols[{name}] {tuple(table.shape)} x {N_RAYS}: bitwise_equal={same}")
        if not same:
            raise AssertionError(f"K3 differs from its plain version on {name}")
        k3_err = max(k3_err, float((out_k - out_p).abs().max()))
        k3_times[name] = _time_pair(f"K3 time[{name}]", lambda: gk.gather_cols(table, idx),
                                    lambda: gk.gather_cols_plain(table, idx))
    ms, plain_ms = k3_times["tri_table"]
    results["gather_cols"] = dict(max_abs_err=k3_err, ms=ms, plain_ms=plain_ms)
    return results


def _band():
    path = os.path.join(ROOT, "pim_tpu", "render", "bench_gate_bands.json")
    with open(path) as f:
        band = json.load(f)["cornell512"]
    return band["mean"] - band["half"], band["mean"] + band["half"]


def check_small_frame(dev, cpu_scene) -> None:
    """A 32^2, 3-bounce, 1-spp frame on the card against the same frame on
    the CPU (plain versions), both from the CPU-built scene."""
    import dataclasses

    import numpy as np

    from pim_tpu_torch.app import bench_camera, render_step

    meta, arrays, lights = cpu_scene
    arrays_d = dataclasses.replace(
        arrays, **{f.name: getattr(arrays, f.name).to(dev) for f in dataclasses.fields(arrays)})
    lights_d = dataclasses.replace(
        lights, **{f.name: getattr(lights, f.name).to(dev) for f in dataclasses.fields(lights)})
    cam = bench_camera(32, 32)
    gpu = render_step((meta, arrays_d, lights_d), cam, 32, 32, 3, 1, 0).color.cpu().numpy()
    cpu = render_step(cpu_scene, cam, 32, 32, 3, 1, 0).color.numpy()
    close = np.all(np.isclose(gpu, cpu, rtol=1e-4, atol=1e-5), axis=-1).mean()
    rel = abs(gpu.mean() - cpu.mean()) / cpu.mean()
    print(f"small frame 32^2 card vs cpu: pixels_close={close:.4f} mean_rel_diff={rel:.6f}")
    if not np.isfinite(gpu).all() or close < 0.97 or rel > 0.02:
        raise AssertionError("the card's small frame disagrees with the CPU frame")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from pim_tpu_torch import native
    from pim_tpu_torch.app import build_cornell_scene, render_frame

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

    cpu_scene = build_cornell_scene("cpu")
    kernels = check_kernels(dev, cpu_scene)

    # the main path: scene build on the card + the 512^2 frame
    native.reset_launches()
    t0 = time.perf_counter()
    scene = build_cornell_scene(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = dict(native.launches)
    fr = render_frame(scene, WIDTH, HEIGHT, BOUNCES, SPP, STEPS)
    launches = dict(native.launches)
    lo, hi = _band()
    print(f"scene build on card: {build_s:.3f} s, launches {build_launches}")
    print(f"frame {WIDTH}x{HEIGHT} bounces={BOUNCES} spp/step={SPP} steps={STEPS}: "
          f"mean={fr.mean:.6f} band=[{lo:.6f}, {hi:.6f}] stddev={fr.stddev:.6f} "
          f"rays={fr.rays:.0f} ms/step={fr.ms_per_step:.3f} Mrays/s={fr.mrays_per_s:.4f} "
          f"step_s={[round(s, 4) for s in fr.step_seconds]}")
    print(f"launches during build+frame: {launches}")
    if not bool(torch.isfinite(fr.buffers.color).all()):
        raise AssertionError("the frame holds non-finite values")
    if tuple(fr.buffers.color.shape) != (N_RAYS, 3):
        raise AssertionError(f"frame shape {tuple(fr.buffers.color.shape)}")
    if not lo <= fr.mean <= hi:
        raise AssertionError(f"frame mean {fr.mean} outside the cornell512 band [{lo}, {hi}]")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
        if fr.launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched during the frame")

    check_small_frame(dev, cpu_scene)

    sources = {"dense_isect": ("pim_tpu_torch/csrc/dense_isect.cu",
                               "pim_tpu/render/pallas_kernels.py:149"),
               "dense_anyhit": ("pim_tpu_torch/csrc/dense_isect.cu",
                                "pim_tpu/render/pallas_kernels.py:183"),
               "gather_cols": ("pim_tpu_torch/csrc/gather_cols.cu",
                               "pim_tpu/render/gather_kernel.py:73")}
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name], **kernels[name]}
        for name in ("dense_isect", "dense_anyhit", "gather_cols")]}
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
