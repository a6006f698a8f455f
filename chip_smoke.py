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
     Cornell BW rows, about 10% dead lanes and one fully dead 2048-ray run,
     also with one t_far for all rays, on N - 100 of them and on three
     copies of them; K2 also in both of its forms, forced through the C
     interface, and its dead lanes must report 1;
     K3: the three real tables and a random [48, 4096] table, indices
     including -1 and T; on the tri table also int64 indices and N - 1
     indices from an aligned and a misaligned pointer) and time both (see
     Timing below); then its main path: build the Cornell scene on the card
     and render the 512^2, 10-bounce frame at 16 spp per step for 3 steps
     through `pim_tpu_torch.app`, with the launch counts set to 0 just
     before and read just after; the mean must lie in the `cornell512`
     band of pim_tpu_torch/render/gate_bands.json and K1-K3 must have
     launched; one more step, queued under torch's sync debug mode, must
     report no host sync; a small frame on the card must agree with the
     CPU's; then
     K1 and K2 on the main path's own rays (the calls of sample 0 of one
     512^2, 10-bounce step: K1's primary rays and one call a bounce, K2's
     one NEE shadow-ray call a bounce, recorded by tools/dense_check.py;
     each timed beside its bound, K1's primary, bounce-1 and last and K2's
     first, second and last beside the plain version) and on a tie scene
     (coincident triangles in shuffled rows over two chunks of rows);
     K2 also on the light-grid bake's call of a Cornell build on the card
     and on a table of 8,192 distinct rows whose rays meet their first
     blocker in any chunk of rows; all bitwise against the plain version,
     K2 in both forms;
  4. the e1m1 slice: its main path (the map built on the card, sky and
     light grid included, then the 512^2, 10-bounce, 1-spp-per-step frame
     for 16 steps with the exposure pass), counted as above; the frame must
     be finite and K3-K6 must have launched during it, and one more step
     with its exposure pass, queued as above, must report no host sync.
     Then K4/K5 on
     three sets of rays: 262,144 from the e1m1 camera and one seeded
     bounce (~10% dead lanes and one fully dead run; the brute-force plain
     versions timed over PLAIN_RUNS runs on the first PLAIN_LANES lanes);
     the main path's own, the bounce-1 (K4) and NEE shadow (K5) rays of a
     512^2 1-spp step as the wrappers receive them, in raysort's order; and
     a tie scene (duplicated triangles, so equal t, and an all-padding
     supercluster; 32-lane groups all dead and all blocked at once).  On
     each, bitwise against the plain version (on the first PLAIN_LANES
     lanes), against both of the kernel's ways of testing a cluster and
     against the walk replay of tools/cluster_check.py on every lane,
     which also counts per ray the clusters and slot tests a traversal
     needs (the bound: the real slots of each needed cluster, one test for
     a blocked shadow ray) and the slot tests a warp-union walk
     (every lane runs all 128 slots of each cluster any lane of its warp
     enters) and this kernel issue; K6 (atlas: K=2 x 262,144
     queries, C=4; sky: the [12, 6*32*32] cube, 262,144 queries, C=3; and
     every atlas and sky call of one 512^2, 10-bounce serving step as the
     wrapper receives it, recorded by tools/fetch_check.py) against its
     plain version, bitwise, and timed beside one `embedding_bag` of the
     corner rows (on the main path, its first atlas and sky calls); K3 on the four
     tables the frame fetches from (the [48, 81552] tri table, the [5, 71]
     texture records, the light table over the grid's cells and the
     [24, 600] emissive table; the tri table the wrapper reads from its
     row-major copy), indices including -1 and T, bitwise; the tri table
     also on the main path's indices (K4's tri ids for the same rays in
     raysort's order, clamped as surface.py passes them); every variant of
     K3 and K7 with 64-bit offsets, launched through the library's C
     interface at the main path's tables, and one K3 call of 2^28 lanes
     whose output passes 2^31 floats, through the wrapper, bitwise; the
     build's parts timed; the BSDF kernels (bsdf_scatter, bsdf_refract_finish,
     bsdf_eval) bitwise against the plain form on 262,144 seeded lanes and
     on tools/bsdf_check.py's edge lanes, with and without the glass path,
     and on the first scatter and eval calls of one e1m1 512^2, 10-bounce
     step, each timed there beside its byte bound and the plain form's
     wall (the plain form's thickness probe a stub: its hits given);
     the sky kernels (sky_bake, and sky_bake_bwd with sky_grad_sum) against
     the plain form on e1m1's cube as the serving bake and the training
     step take it, on an earth_sky fan and on a 4^2 cube (the values whose
     bits differ, none where the 96-step sums follow torch.sum's order, and
     the largest relative gap, at most 1e-6), the backward against autograd
     of the plain form (rtol 1e-4) and twice to the same bits, each timed
     on the training cube beside its operation bound and the plain form's
     wall;
     the RNG kernels (rng_seed, rng_draw) behind make_state and every draw
     helper bitwise against the plain int64 form at a render step's
     262,144 and the bake's 1,048,576 lanes (tools/rng_check.py's edge ids,
     the sample id a Python int and a device scalar), each kernel timed at
     both beside its byte bound and the plain form's wall;
     the media kernels (media_scatter, media_transmittance) bitwise against
     the plain form on 262,144 seeded lanes (tools/media_check.py) through
     a dense medium, the cornell-media cell's and a random one, and on the
     first 3 calls of each in a Cornell 512^2, 10-bounce step through the
     cell's medium, each timed beside its bound (bytes, and the plain
     form's operations) and the plain form's wall;
     the 128^2, 16-spp frame gated by the CPU-anchored `e1m1_128`
     band of pim_tpu_torch/render/gate_bands.json (the 512^2 mean is printed
     beside the reference's TPU drift band, for information only); a 32^2,
     3-bounce frame on the card against the same frame on the CPU;
  5. the differentiable path (pim_tpu_torch.render.diff): K7 (12 x 262,144
     indices into the e1m1 atlas planes; 4 x 262,144 into the sky
     planes; 3 x 262,143 from an aligned and a misaligned pointer; the main
     path's atlas and sky corner indices at the hits of phase 4) against
     its plain version, bitwise; K7's and K3's backward kernels
     (K3-bwd on the [48, 81552] tri table at 262,144 lanes and on the
     [4, 208] material graft at 81,552) against their plain versions summed
     in float64, within gamma(adds - 1) * sum |g| per output, the bound of
     any summation order (float atomics reorder the adds), and the same on
     every call one e1m1 512^2, 3-bounce training step hands them (recorded
     by tools/fetch_check.py; each timed beside one `index_add_`, and each
     K3-bwd call's lanes at column 0 and with a zero gradient printed);
     every form of K3-bwd and K7-bwd with 64-bit offsets, through the C interface,
     within the same bound; then its main
     paths, counted as above: TRAIN_STEPS Adam steps of the e1m1 512^2,
     3-bounce, 1-spp render with all six groups trainable against a target
     rendered with perturbed parameters (finite loss, finite nonzero
     gradients in every group, K3-bwd, K7 and K7-bwd launched; ms per step
     and peak memory printed) and tests/test_grad.py's Cornell inverse
     rendering at 512^2 (the last of INVERSE_STEPS losses below 0.2x the
     first); per-group directional derivatives on the card against the CPU
     at GRAD_RES^2 (within GRAD_RTOL) and against central differences at
     FD_RES^2 (tests/test_grad.py's eps ladder);
  6. the engine shell (`pim_tpu_torch.app.Engine` in process, on the card,
     one device sync a frame to time it; each path's launches counted as
     above): `pt_test -frames 64` at 512^2, 10 bounces (its pt_gate on the
     port's Cornell tier, pim_tpu_torch/render/pt_gate_bands.json; both
     screenshots must decode); 16 frames of Cornell with `pt_media 1` at
     512^2, gated by the 16-sample Cornell tier (the default medium is near
     vacuum; its marches launch the media kernels); the unchanged scripts/pt_test_e1m1.cmd at 128^2 by `exec`,
     gated by the port's e1m1 tier; a dense medium (tests/test_media.py's)
     at 32^2, 3 bounces, on the card against the CPU on Cornell (K2's
     in-media NEE) and e1m1 (K5's); a checkpoint on the card (ckpt_save
     after 2 frames, ckpt_load into a fresh render system, 2 more frames:
     bit for bit the 4 frames of an uninterrupted run); and the autofocus
     probe's one-ray K1 call, bit for bit against its plain version.  The
     shell's screenshots and checkpoint go to build/shell/;
  7. the bakes (outputs under build/bakes/; each path's launches counted
     around its bake calls: the lightmap passes, the reflection-probe
     passes, the probe_bake command, the tool's run): `mapload e1m1` with
     `lm_gen 1` and `r_refl_gen 1` through the shell at the release density
     for E1M1_BAKE_FRAMES frames, 10 bounces (the 1024^2 atlas, all
     1,048,576 texels traced a pass; ms a pass and peak memory printed),
     the pack bit for bit against data/e1m1/lmpack.npz (position, normal,
     live mask), every live texel's count 1 + frames, dead texels untouched,
     probes finite and rgb >= 0; `probe_bake -samples 1024` and
     `probe_report`; K4 and K5 on the bake's own calls (its hemisphere and
     bounce-1 rays, its first two NEE shadow-ray calls): the wrapper on
     all 1,048,576 lanes of each, its outputs at PLAIN_LANES live lanes
     spread evenly over the call bitwise against the plain version on
     those lanes, and every
     dead lane a miss (K4 t = -1 and tri = -1, K5 0);
     an e1m1 shard of SHARD_LIVE live texels at 3 bounces, card against
     CPU; pim_tpu_torch/tools/bake_e1m1_lightmap.py at TOOL_FRAMES frames
     (its crate resume bit for bit, Mtexel-samples/s printed).  Cornell:
     the full-width lightmap pass, a 16^2 reflection probe baked and
     convolved, and a light probe's 1,024 rays (and its fit within 2%),
     each card against CPU at 3 bounces by the small frames' rule;
     CORNELL_BAKE_PASSES passes of `lm_gen 1` through the shell, whose mean
     irradiance over live texels must lie in the CPU-derived band of
     pim_tpu_torch/render/bake_bands.json; K1 and K2 on that bake's own
     rays, bitwise (K2 in both forms); a checkpoint after 2 frames of
     `lm_gen 1` + `r_refl_gen 1` and a probe_bake, resumed in a fresh
     render system for 2 frames: the frame, the lightmap and the light
     probe bit for bit those of 4 uninterrupted frames;
  8. the scale-out layer (pim_tpu_torch/parallel/; outputs under
     build/parallel/): the main process traces sample PAR_SAMPLE of the
     e1m1 512^2, 10-bounce frame unsharded, takes one one-rank SGD step of
     the e1m1 512^2, 3-bounce training (all six groups, against a target
     rendered with perturbed parameters) and bakes PAR_BAKE_FRAMES passes
     of the e1m1 lightmap from data/e1m1/lmpack.npz (1,048,576 texels);
     then a spawned two-rank gloo world, both ranks on cuda:0 (NCCL
     refuses two ranks on one card), each building e1m1 on the card (its
     tables and light state by sha256 equal to the main process's): the
     sharded render of the same sample, gathered, bit for bit the
     unsharded trace on every lane (color, albedo, normal) and `live`
     equal; PAR_TRAIN_STEPS sharded SGD steps (finite losses, every group
     moved, both ranks the same parameters, the first update within
     PAR_UPDATE_RTOL of the one-rank update, K3-bwd, K7 and K7-bwd
     launched); the texel-sharded bake (524,288 texels a rank), gathered,
     bit for bit the whole bake; then a one-rank NCCL world:
     dryrun_multichip(1) and the sharded Cornell 512^2 frame (SPP samples,
     10 bounces) inside `cornell512`; and `cornell_box spheres` through the
     shell at 128^2 (the cluster backend with glass: finite, nonzero, K4/K5
     launched).  Each path's wall a step per rank beside the one-rank wall,
     the launches per rank and the peak memory per rank are printed;
  9. the measurement tools, each path's launches counted (the numbers
     are pimbench's): tools/perf_table.py on one traced Cornell and one
     e1m1 512^2, 10-bounce sample (the subsystem rows sum to the profiler's
     device time within 1%, the busy and "other" shares printed, every port
     kernel in intersect, table-gather or surface-fetch); tools/ab_sort.py
     on e1m1 at SORT_RES^2 (sorted and unsorted images and ray counts bit
     for bit equal); tools/bench_cluster.py at CLUSTER_RAYS rays (the
     table and the measured crossover printed; K4's t equal to K1's and
     K5's flag to K2's on every ray of all six soups, the bvh walk's hit
     and flag on all but 1e-4 of them).  Each part prints its seconds
     beside the card's name and power limit;
 10. the Moller-Trumbore backends (csrc/mt_isect.cu; not TPU kernels: the
     JAX package runs them in XLA), each path's launches counted: both BVH
     builders on the Cornell, spheres and e1m1 soups (seconds, nodes, each
     tree's validate_bvh depth against the walk's 48-entry stack); Cornell
     built with `brute` on the card and its 512^2 frame (SPP spp, STEPS
     steps) gated by `cornell512`, brute_isect / brute_anyhit on its
     262,144 camera rays and one seeded bounce (~10% dead lanes), bitwise
     against the plain versions and timed beside their bounds (the tests
     each live ray needs: every triangle, or those up to its first
     blocker); e1m1 built with `bvh` and its 128^2 16-step render gated by
     `e1m1_128`, a 512^2 1-spp step through bvh beside the same step
     through cluster (printed, no gate), bvh_isect / bvh_anyhit on the
     main path's camera, bounce-1 and NEE rays and a seeded bounce against
     the plain lockstep walk on every lane (its counts of nodes, entries
     and leaf tests are the bound; K4/K5 timed on the same rays),
     brute_isect / brute_anyhit on MT_BRUTE_LANES e1m1 rays; both families
     on a tie soup (coincident triangles in different chunks and leaves);
     a 32^2, 3-bounce frame of each scene against the CPU; one shell frame
     each after `pt_backend brute` (Cornell) and `pt_backend bvh` (e1m1).
Timing: every kernel, its plain version and its library call get `ms`, the
device time per call: a GPU sleep holds the stream while the host queues
DEVICE_RUNS back-to-back calls behind it between two CUDA events, and the
device then runs them without waiting on the host (`_device_ms`;
torch.profiler, tried first, lost device activity in about one trace in a
hundred on the H100 machine, and in streaks); and `call_ms`, the wall of
ONE call from an idle device (CUDA events around it after a synchronise;
median, min, max of TIMING_RUNS), which holds the host's work in the call.
K3 and K7 (kernel and library call) are timed DEVICE_BATCHES times, and
also L2-cold (`cold_ms`: each call after a 96 MB read, the reads' own time
taken off); K4/K5 L2-cold on the main path's rays.  The brute-force
K4/K5 plain versions wait on the device themselves, so their `plain_ms`
holds their host time too, and so do the plain MT versions (the lockstep
walk waits on the device every trip).
Before the last line come a JSON object of per-kernel results (`launches`
summed over the main paths that run the kernel, each path's count in
`launches_by_path`; `ms`, `call_ms`, `plain_ms`, `plain_call_ms`,
`library_ms`, `library_call_ms`; `bound_ms`, the least time the card could
take, from this run's inputs; `library_ms` is one PyTorch call computing
the same function, or null; K3 and K7 also carry their other shapes and
the main-path indices under prefixed keys, K4 and K5 the main path's rays
and the walk's counts per ray) and the card's nvidia-smi name
and power limit; the last line is `{"ok": true, "device": {...}}`.  Imports
only the port (its check and measurement tools, `app.gate_band` for the
frame gates), nothing of JAX or of `pimbench`.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH = HEIGHT = 512
BOUNCES = 10
SPP = 16
STEPS = 3
E1M1_STEPS = 4        # 1-spp steps of the e1m1 512^2 frame (its band is for information)
GATE_RES = 128
N_RAYS = WIDTH * HEIGHT
TIMING_RUNS = 25      # walls of one call (call_ms)
DEVICE_RUNS = 25      # back-to-back calls traced for a device time (ms)
DEVICE_BATCHES = 3    # traces of the redesigned K3 and K7, for their spread
FLUSH_BYTES = 96 << 20  # read before each L2-cold call (the card's L2: 50 MB)
QUEUE_CYCLES = 40_000_000  # GPU sleep ahead of the queued calls of a device timing
PLAIN_LANES = 32768   # lanes on which the brute-force plain K4/K5 are compared
PLAIN_RUNS = 3        # and timed
# the differentiable path
TRAIN_BOUNCES = 3     # make_render_fn's default
TRAIN_STEPS = 3       # Adam steps of the e1m1 training run
INVERSE_STEPS = 20    # Adam steps of the Cornell inverse-rendering run
TRAIN_SEED = 7
GRAD_RES = 32         # card vs CPU gradients
GRAD_RTOL = 1e-3      # card vs CPU directional derivatives (atomics reorder sums)
GRAD_SKY_STEPS = 1    # sky re-bake of the card-vs-CPU check (224 view steps a texel)
FD_RES = 64           # AD vs finite differences on the card
FD_LADDER = (3e-3, 1e-3, 3e-4, 1e-4, 3e-5, 1e-5)  # tests/test_grad.py's
# the bound of a kernel call: one H100 SXM's published peaks (NVIDIA data
# sheet): HBM3 bytes per second and float32 operations per second outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BW_TEST_FLOPS = 31    # float operations of one Baldwin-Weber ray-triangle test


def _call_ms_list(fn, runs: int) -> list:
    """`runs` walls in ms of ONE call of `fn` from an idle device: CUDA
    events around the call after a synchronise, so the host's work in the
    call (checks, allocation, the launch) is in it."""
    import torch

    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _call_ms(fn, runs: int = TIMING_RUNS):
    """(median, min, max) of `_call_ms_list` after a warm-up."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    times = _call_ms_list(fn, runs)
    return statistics.median(times), min(times), max(times)


@functools.lru_cache(maxsize=None)
def _l2_flush():
    """flush(): reads FLUSH_BYTES of device memory (a row max of float64),
    more than the card's 50 MB L2, so that a call after it finds its inputs
    in HBM and no dirty lines of another call in L2."""
    import torch

    buf = torch.ones((4096, FLUSH_BYTES // 8 // 4096), dtype=torch.float64, device="cuda")
    return lambda: torch.amax(buf, dim=1)


def _queued_ms(step, calls: int):
    """Device ms of `calls` back-to-back calls of step(): a GPU sleep
    (QUEUE_CYCLES) holds the stream while the host queues them between two
    CUDA events, so the device then runs them without waiting on the host.
    None if the device reached them before the host had queued the last
    (the host blocks once about a thousand launches wait in the queue)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(calls):
        step()
    end.record()
    ahead = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) if ahead else None


def _device_ms(fn, runs: int = DEVICE_RUNS, cold: bool = False, queued: bool = True) -> float:
    """Device time of one call of `fn` in ms, after a warm-up: `runs`
    back-to-back calls queued ahead of the device (`_queued_ms`, fewer
    behind each sleep where the host cannot queue them all in time), their
    time over `runs`.  With `cold`, an L2 flush precedes each call, and the
    flushes' own time, queued alone, is taken off.  `queued=False` is for a
    function that waits on the device itself (the brute-force K4/K5 plain
    versions): each call is timed alone with CUDA events, its host time
    inside."""
    import torch

    flush = _l2_flush() if cold else None
    fn()  # warm-up
    torch.cuda.synchronize()
    if not queued:
        return statistics.mean(_call_ms_list(fn, runs))

    def flushed():
        flush()
        fn()

    group, done, total = runs, 0, 0.0
    while done < runs:
        calls = min(group, runs - done)
        ms = _queued_ms(fn if flush is None else flushed, calls)
        if ms is not None and flush is not None:
            flush_ms = _queued_ms(flush, calls)
            ms = None if flush_ms is None else ms - flush_ms
        if ms is not None:
            total += ms
            done += calls
        elif group > 1:
            group = max(1, group // 2)
        else:
            raise RuntimeError("the host could not queue one call ahead of the device")
    return total / runs


def _timing(fn, runs: int = DEVICE_RUNS, batches: int = 1, cold: bool = False,
            queued: bool = True) -> dict:
    """{"ms": device ms per call, the median over `batches` timings of
    `runs` calls, "ms_range": (min, max) over them, "call": the (median,
    min, max) wall of one call from an idle device}; with `cold` also
    "cold_ms" and "cold_range", the same with the L2 flushed before each
    call."""
    dev = sorted(_device_ms(fn, runs, queued=queued) for _ in range(batches))
    out = dict(ms=statistics.median(dev), ms_range=(dev[0], dev[-1]),
               call=_call_ms(fn, min(runs, TIMING_RUNS)))
    if cold:
        dev = sorted(_device_ms(fn, runs, cold=True) for _ in range(batches))
        out.update(cold_ms=statistics.median(dev), cold_range=(dev[0], dev[-1]))
    return out


def _fmt(t: dict) -> str:
    def spread(lo, hi):
        return f" [min {lo:.4f}, max {hi:.4f}]" if hi > lo else ""

    c = t["call"]
    cold = ("" if "cold_ms" not in t else
            f", L2 cold {t['cold_ms']:.4f} ms device{spread(*t['cold_range'])}")
    return (f"{t['ms']:.4f} ms device{spread(*t['ms_range'])}{cold}, "
            f"call {c[0]:.4f} ms [min {c[1]:.4f}, max {c[2]:.4f}]")


def _time_pair(label: str, kernel, plain, plain_runs: int = DEVICE_RUNS, batches: int = 1,
               cold: bool = False, plain_queued: bool = True):
    """Times a kernel (`batches` times, also L2-cold with `cold`) and its
    plain version; prints both; returns their `_timing` dicts."""
    k = _timing(kernel, batches=batches, cold=cold)
    p = _timing(plain, plain_runs, queued=plain_queued)
    print(f"{label}: kernel {_fmt(k)}; plain {_fmt(p)} ({plain_runs} runs)")
    return k, p


def _copy_rate(dev) -> float:
    """Bytes per second that a 256 MiB device-to-device copy moves (read
    plus write): what this machine's device memory gives a plain stream."""
    import torch

    src = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    return 2 * src.numel() / (_device_ms(lambda: dst.copy_(src), 10) * 1e-3)


def _bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the HBM
    rate and its float operations over the float32 peak."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / FP32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(b_ms, f_ms), bound_by="bytes" if b_ms >= f_ms else "operations",
                bound_bytes=float(n_bytes), bound_flops=float(flops))


def _ray_bytes(n: int, t_far) -> int:
    """Bytes of rays a ray kernel must read: every ray's t_far where it is
    an [n] tensor (a scalar t_far is an argument), and the origin and
    direction of the live rays only (t_far > 0): a dead ray needs neither."""
    import torch

    if not torch.is_tensor(t_far):
        return n * 6 * 4 if t_far > 0.0 else 0
    live = int((t_far.expand(n) > 0.0).sum())
    return n * 4 + live * 6 * 4


def _row(max_abs_err: float, k, p, bound: dict, library=None) -> dict:
    """A kernel's row of the JSON report: its error against the plain
    version; the device ms per call of the kernel, its plain version and
    the one PyTorch call computing the same function (None where there is
    none), each with the wall of one call (`call_ms`); the bound."""
    row = dict(max_abs_err=max_abs_err, ms=k["ms"], ms_min=k["ms_range"][0],
               ms_max=k["ms_range"][1], call_ms=k["call"][0],
               call_ms_min=k["call"][1], call_ms_max=k["call"][2],
               plain_ms=p["ms"], plain_call_ms=p["call"][0], **bound,
               library_ms=None if library is None else library["ms"],
               library_call_ms=None if library is None else library["call"][0])
    if "cold_ms" in k:
        row.update(cold_ms=k["cold_ms"], cold_ms_min=k["cold_range"][0],
                   cold_ms_max=k["cold_range"][1])
    if library is not None and "cold_ms" in library:
        row["library_cold_ms"] = library["cold_ms"]
    return row


def _bits_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def check_kernels(dev, cpu_scene):
    """K1/K2/K3 against their plain versions on the card."""
    import numpy as np
    import torch

    from pim_tpu_torch.math.vec3 import RCP_EPS, V3
    from pim_tpu_torch.render import dense_kernels as dk
    from pim_tpu_torch.render.lights import make_light_table
    from pim_tpu_torch.tools.dense_check import anyhit_tests, random_rays

    meta, arrays, lights = cpu_scene
    tris12 = arrays.tris12.to(dev)
    ro, rd, t_far = random_rays(dev)
    dead = t_far <= 0.0
    live = int((~dead).sum())
    n_tri = meta.tri_count
    rows_bytes = n_tri * 12 * 4
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
    # a ragged last tile, and more tiles than blocks stay resident (each
    # block then walks several tiles with its rows staged once)
    _check_k1("seeded rays, N - 100", tris12, V3(*(c[:-100] for c in ro)),
              V3(*(c[:-100] for c in rd)), 0.0, t_far[:-100])
    _check_k1("seeded rays x 3", tris12, V3(*(c.repeat(3) for c in ro)),
              V3(*(c.repeat(3) for c in rd)), 0.0, t_far.repeat(3))
    times = _time_pair("K1 time", lambda: dk.dense_isect(tris12, ro, rd, 0.0, t_far),
                       lambda: dk.dense_isect_plain(tris12, ro, rd, 0.0, t_far))
    # every live ray tests every triangle; t and tri are written
    results["dense_isect"] = _row(
        float((t_k - t_p).abs().max()), *times,
        _bound(_ray_bytes(N_RAYS, t_far) + rows_bytes + N_RAYS * 8, live * n_tri * BW_TEST_FLOPS))

    # K2: any hit (shadow rays to a finite distance), in the wrapper's form
    # and both forced forms; also one t_far for all rays, a ragged last
    # tile and more tiles than blocks stay resident
    t_far2 = torch.where(dead, 0.0, 3.0)
    k2_err = _check_k2("seeded rays", tris12, ro, rd, 0.0, t_far2)["max_abs_err"]
    _check_k2("seeded rays, one t_far for all rays", tris12, ro, rd, 0.0, 3.0)
    _check_k2("seeded rays, N - 100", tris12, V3(*(c[:-100] for c in ro)),
              V3(*(c[:-100] for c in rd)), 0.0, t_far2[:-100])
    _check_k2("seeded rays x 3", tris12, V3(*(c.repeat(3) for c in ro)),
              V3(*(c.repeat(3) for c in rd)), 0.0, t_far2.repeat(3))
    times = _time_pair("K2 time", lambda: dk.dense_anyhit(tris12, ro, rd, 0.0, t_far2),
                       lambda: dk.dense_anyhit_plain(tris12, ro, rd, 0.0, t_far2))
    # a live ray needs the tests up to its first blocker in index order
    need = int(anyhit_tests(tris12[:n_tri], ro, rd, 0.0, t_far2).sum())
    results["dense_anyhit"] = _row(k2_err, *times,
                                   _bound(_ray_bytes(N_RAYS, t_far2) + rows_bytes + N_RAYS * 4,
                                          need * BW_TEST_FLOPS))

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


def _touched_bytes(cols, row_bytes: int) -> int:
    """Bytes of the distinct table columns (texels) that in-range indices
    `cols` read: a gather needs those, not the whole table."""
    import torch

    return int(torch.unique(cols).numel()) * row_bytes


def check_k3(label: str, table, idx, time_it: bool = True):
    """K3 against its plain version on (table, idx), bitwise; with `time_it`
    also timed beside its plain version and `torch.index_select` on the
    indices clipped into range (it raises on the others).  Returns (max abs
    error, (kernel, plain, bound, library) or None)."""
    import torch

    from pim_tpu_torch.render import gather_kernel as gk

    f, t = table.shape
    n = idx.shape[0]
    out_k = gk.gather_cols(table, idx)
    out_p = gk.gather_cols_plain(table, idx)
    torch.cuda.synchronize()
    same = _bits_equal(out_k, out_p)
    print(f"K3 gather_cols[{label}] {tuple(table.shape)} x {n} {str(idx.dtype)[6:]}: "
          f"bitwise_equal={same}")
    if not same:
        raise AssertionError(f"K3 differs from its plain version on {label}")
    err = float((out_k - out_p).abs().max())
    if not time_it:
        return err, None
    k, p = _time_pair(f"K3 time[{label}]", lambda: gk.gather_cols(table, idx),
                      lambda: gk.gather_cols_plain(table, idx), batches=DEVICE_BATCHES,
                      cold=True)
    idx_in = idx.clamp(0, t - 1).to(torch.int64)
    lib = _timing(lambda: torch.index_select(table, 1, idx_in), batches=DEVICE_BATCHES,
                  cold=True)
    # indices read, the columns they reach, the [F, N] output written
    bound = _bound(n * idx.element_size() + _touched_bytes(idx[(idx >= 0) & (idx < t)], f * 4)
                   + f * n * 4, 0.0)
    print(f"K3 library index_select[{label}]: {_fmt(lib)}; bound {bound['bound_ms']:.4f} ms")
    return err, (k, p, bound, lib)


def check_gather_cols(dev, scene_name: str, tables, rs):
    """K3 on each table at N_RAYS seeded indices (-1 and T among them),
    timed; on the tri table also at int64 indices and at N_RAYS - 1
    indices (the scalar path), from an aligned and a misaligned pointer.
    Returns (max abs error, {table: (kernel, plain, bound, library)})."""
    import numpy as np
    import torch

    err = 0.0
    times = {}
    for name, table in tables.items():
        table = table.to(dev).contiguous()
        t = table.shape[1]
        idx = torch.from_numpy(rs.integers(-1, t + 1, N_RAYS).astype(np.int32)).to(dev)
        idx[:2] = torch.tensor([-1, t], dtype=torch.int32)
        e, times[name] = check_k3(f"{scene_name} {name}", table, idx)
        err = max(err, e)
        if name == "tri_table":
            for sub, what in ((idx.to(torch.int64), "int64"), (idx[:-1], "N-1"),
                              (idx[1:], "N-1 misaligned")):
                err = max(err, check_k3(f"{scene_name} {name} {what}", table, sub, False)[0])
    return err, times


CORNELL_KERNELS = ("dense_isect", "dense_anyhit", "gather_cols")
E1M1_KERNELS = ("cluster_isect", "cluster_anyhit", "gather_bilinear")
TRAIN_KERNELS = ("gather_cols_bwd", "gather_texels", "gather_texels_bwd")
BSDF_KERNELS = ("bsdf_scatter", "bsdf_refract_finish", "bsdf_eval")
SKY_KERNELS = ("sky_bake", "sky_bake_bwd")
RNG_KERNELS = ("rng_seed", "rng_draw")
MEDIA_KERNELS = ("media_scatter", "media_transmittance")
# the main paths that run each kernel
CORNELL_BAKES = ("cornell_lightmap", "cornell_refl", "cornell_light_probe")
E1M1_BAKES = ("e1m1_lightmap", "e1m1_lightmap_compacted", "e1m1_refl", "e1m1_light_probe")
PATHS = {
    "dense_isect": ("cornell", "cornell_train", "cornell_shell", "cornell_media_shell")
    + CORNELL_BAKES,
    "dense_anyhit": ("cornell", "cornell_train", "cornell_shell", "cornell_media_shell")
    + CORNELL_BAKES,
    "gather_cols": ("cornell", "e1m1", "e1m1_train", "cornell_train", "cornell_shell",
                    "cornell_media_shell", "e1m1_shell") + CORNELL_BAKES + E1M1_BAKES,
    "cluster_isect": ("e1m1", "e1m1_train", "e1m1_shell") + E1M1_BAKES,
    "cluster_anyhit": ("e1m1", "e1m1_train", "e1m1_shell") + E1M1_BAKES,
    "gather_bilinear": ("e1m1", "e1m1_shell") + E1M1_BAKES,
    "gather_cols_bwd": ("e1m1_train", "cornell_train"),
    "gather_texels": ("e1m1_train",),
    "gather_texels_bwd": ("e1m1_train",),
    "brute_isect": (),
    "brute_anyhit": (),
    "bvh_isect": (),
    "bvh_anyhit": (),
    # the training paths' inputs require grad: they keep the plain form
    "bsdf_scatter": ("cornell", "e1m1", "cornell_shell", "e1m1_shell"),
    "bsdf_refract_finish": ("e1m1", "e1m1_shell"),
    "bsdf_eval": ("cornell", "e1m1", "cornell_shell", "e1m1_shell"),
    # the e1m1 build bakes the sky; the training step re-bakes it
    "sky_bake": ("e1m1", "e1m1_train", "e1m1_shell"),
    "sky_bake_bwd": ("e1m1_train",),
    "sky_grad_sum": ("e1m1_train",),
    # every path that traces on the card seeds and draws its streams there
    **{name: ("cornell", "e1m1", "e1m1_train", "cornell_train", "cornell_shell",
              "cornell_media_shell", "e1m1_shell") + CORNELL_BAKES + E1M1_BAKES
       for name in RNG_KERNELS},
    # the media marches run where media are on
    **{name: ("cornell_media_shell",) for name in MEDIA_KERNELS},
}
# phase 8's paths and the kernels each must launch (added to PATHS)
PAR_KERNELS = {
    "e1m1_sharded_render": ("gather_cols",) + E1M1_KERNELS + RNG_KERNELS,
    "e1m1_sharded_train": ("gather_cols", "cluster_isect", "cluster_anyhit") + TRAIN_KERNELS
    + RNG_KERNELS,
    "e1m1_sharded_bake": ("gather_cols",) + E1M1_KERNELS + RNG_KERNELS,
    "cornell_nccl_dryrun": ("dense_isect", "dense_anyhit", "gather_cols", "gather_cols_bwd")
    + RNG_KERNELS,
    "cornell_nccl_render": CORNELL_KERNELS + RNG_KERNELS,
    "cornell_spheres_shell": ("gather_cols", "cluster_isect", "cluster_anyhit") + RNG_KERNELS,
}
# phase 9's paths (the measurement modules) and the kernels each must launch
MEASURE_KERNELS = {
    "perf_table_cornell": CORNELL_KERNELS + RNG_KERNELS,
    "perf_table_e1m1": ("gather_cols",) + E1M1_KERNELS + RNG_KERNELS,
    "ab_sort": ("gather_cols",) + E1M1_KERNELS + RNG_KERNELS,
    "bench_cluster": ("dense_isect", "dense_anyhit", "cluster_isect", "cluster_anyhit",
                      "bvh_isect", "bvh_anyhit"),
}
# phase 10's paths (the Moller-Trumbore backends) and the kernels each must launch
MT_PATH_KERNELS = {
    "cornell_brute": ("brute_isect", "brute_anyhit", "gather_cols") + RNG_KERNELS,
    "e1m1_bvh": ("bvh_isect", "bvh_anyhit", "gather_cols", "gather_bilinear") + RNG_KERNELS,
    "cornell_brute_shell": ("brute_isect", "brute_anyhit", "gather_cols") + RNG_KERNELS,
    "e1m1_bvh_shell": ("bvh_isect", "bvh_anyhit", "gather_cols", "gather_bilinear")
    + RNG_KERNELS,
}
PATH_KERNELS = {**PAR_KERNELS, **MEASURE_KERNELS, **MT_PATH_KERNELS}
PATHS = {name: paths + tuple(p for p, names in PATH_KERNELS.items() if name in names)
         for name, paths in PATHS.items()}
SOURCES = {
    "dense_isect": ("pim_tpu_torch/csrc/dense_isect.cu", "pim_tpu/render/pallas_kernels.py:149"),
    "dense_anyhit": ("pim_tpu_torch/csrc/dense_isect.cu", "pim_tpu/render/pallas_kernels.py:183"),
    "gather_cols": ("pim_tpu_torch/csrc/gather_cols.cu", "pim_tpu/render/gather_kernel.py:73"),
    "cluster_isect": ("pim_tpu_torch/csrc/cluster_isect.cu", "pim_tpu/render/cluster.py:277"),
    "cluster_anyhit": ("pim_tpu_torch/csrc/cluster_isect.cu", "pim_tpu/render/cluster.py:345"),
    "gather_bilinear": ("pim_tpu_torch/csrc/gather_bilinear.cu",
                        "pim_tpu/render/table_gather.py:171"),
    # K3's custom VJP backward, a column scatter-add
    "gather_cols_bwd": ("pim_tpu_torch/csrc/gather_cols.cu", "pim_tpu/render/fetch.py:52"),
    "gather_texels": ("pim_tpu_torch/csrc/gather_texels.cu", "pim_tpu/render/table_gather.py:43"),
    # the transpose of K7's gather (JAX differentiates the clipped take)
    "gather_texels_bwd": ("pim_tpu_torch/csrc/gather_cols.cu",
                          "pim_tpu/render/table_gather.py:377"),
    # not TPU kernels: the JAX package runs these in XLA (a scan, a while_loop)
    "brute_isect": ("pim_tpu_torch/csrc/mt_isect.cu", "pim_tpu/render/intersect.py:75"),
    "brute_anyhit": ("pim_tpu_torch/csrc/mt_isect.cu", "pim_tpu/render/intersect.py:75"),
    "bvh_isect": ("pim_tpu_torch/csrc/mt_isect.cu", "pim_tpu/render/intersect.py:189"),
    "bvh_anyhit": ("pim_tpu_torch/csrc/mt_isect.cu", "pim_tpu/render/intersect.py:189"),
    # not TPU kernels: the JAX package leaves the BSDF to XLA
    "bsdf_scatter": ("pim_tpu_torch/csrc/bsdf.cu", "pim_tpu/render/bsdf.py:126"),
    "bsdf_refract_finish": ("pim_tpu_torch/csrc/bsdf.cu", "pim_tpu/render/bsdf.py:173"),
    "bsdf_eval": ("pim_tpu_torch/csrc/bsdf.cu", "pim_tpu/render/bsdf.py:107"),
    # not TPU kernels: the JAX package's march is a lax.scan
    "sky_bake": ("pim_tpu_torch/csrc/sky.cu", "pim_tpu/render/sky.py:70"),
    "sky_bake_bwd": ("pim_tpu_torch/csrc/sky.cu", "pim_tpu/render/sky.py:70"),
    # not TPU kernels: XLA fuses the JAX package's RNG into the ops around it
    "rng_seed": ("pim_tpu_torch/csrc/rng.cu", "pim_tpu/core/rng.py:76"),
    "rng_draw": ("pim_tpu_torch/csrc/rng.cu", "pim_tpu/core/rng.py:86"),
    # not TPU kernels: the JAX package's marches are lax.scans
    "media_scatter": ("pim_tpu_torch/csrc/media.cu", "pim_tpu/render/media.py:189"),
    "media_transmittance": ("pim_tpu_torch/csrc/media.cu", "pim_tpu/render/media.py:127"),
}


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
            f"warmup_s={fr.warmup_seconds:.4f} timed_s={fr.seconds:.4f}")


def _check_frame(fr, n_pixels: int, kernels) -> None:
    import torch

    if not bool(torch.isfinite(fr.buffers.color).all()):
        raise AssertionError("the frame holds non-finite values")
    if tuple(fr.buffers.color.shape) != (n_pixels, 3):
        raise AssertionError(f"frame shape {tuple(fr.buffers.color.shape)}")
    for name in kernels:
        if fr.launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched during the frame")


DENSE_TIE_DISTINCT = 40  # distinct triangles of K1's and K2's tie scene
DENSE_TIE_COPIES = 10    # copies of each: 400 rows, padded to 512 (two chunks of rows)
K1_NAMED = {0: "primary", 1: "bounce1", BOUNCES: "last"}  # main-path calls timed with plain
K2_NAMED = {0: "first", 1: "second", BOUNCES - 1: "last"}  # main-path calls timed with plain
K2_WIDE_ROWS = 8192      # DENSE_CROSSOVER_TRIS: the top of the dense backend's range


def _check_k1(label: str, tris12, ro, rd, t_near, t_far) -> dict:
    """K1 against its plain version on one call, bit for bit."""
    import torch

    from pim_tpu_torch.render import dense_kernels as dk

    t_k, tri_k = dk.dense_isect(tris12, ro, rd, t_near, t_far)
    t_p, tri_p = dk.dense_isect_plain(tris12, ro, rd, t_near, t_far)
    torch.cuda.synchronize()
    n = ro.x.shape[0]
    live = int((torch.as_tensor(t_far, device=ro.x.device).expand(n) > 0.0).sum())
    same = _bits_equal(t_k, t_p) and bool(torch.equal(tri_k, tri_p))
    print(f"K1 dense_isect[{label}]: {n} rays, {live} live, hits {int((tri_k >= 0).sum())}; "
          f"bitwise equal to plain {same}")
    if not same:
        raise AssertionError(f"K1 [{label}] differs from its plain version")
    return dict(live=live, max_abs_err=float((t_k - t_p).abs().max()))


def check_k1_main_path(scene, calls) -> dict:
    """K1 on the Cornell main path's own rays: `calls`, the K1 calls of
    sample 0 of one WIDTH^2, BOUNCES-bounce step
    (`dense_check.main_path_calls`: the primary rays, then one call a
    bounce, dead lanes at t_far = 0), each
    checked by `_check_k1` and timed, the K1_NAMED ones beside their plain
    version (given t_far as a tensor, which it can queue without a host
    sync); and a tie scene (coincident triangles in shuffled rows over two
    chunks of rows, a dead warp, a warp of one ray).  Returns the K1 row's
    main-path keys."""
    import numpy as np
    import torch

    from pim_tpu_torch.math.vec3 import V3
    from pim_tpu_torch.render import dense_kernels as dk
    from pim_tpu_torch.tools import dense_check as dc

    meta, arrays, _ = scene
    n_tri = meta.tri_count
    out = dict(main_calls=[], main_ms_sum=0.0, main_bound_ms_sum=0.0, max_abs_err=0.0)
    for i, (tris12, ro, rd, t_near, t_far) in enumerate(calls):
        chk = _check_k1(f"main path {i}", tris12, ro, rd, t_near, t_far)
        n = ro.x.shape[0]
        bound = _bound(_ray_bytes(n, t_far) + n_tri * 12 * 4 + n * 8,
                       chk["live"] * n_tri * BW_TEST_FLOPS)

        def kernel(tris12=tris12, ro=ro, rd=rd, t_near=t_near, t_far=t_far):
            return dk.dense_isect(tris12, ro, rd, t_near, t_far)

        k = _timing(kernel)
        call = dict(call=i, live=chk["live"], ms=k["ms"], call_ms=k["call"][0],
                    bound_ms=bound["bound_ms"])
        if i in K1_NAMED:
            tf = torch.as_tensor(t_far, dtype=torch.float32, device=ro.x.device).expand(n)
            p = _timing(lambda: dk.dense_isect_plain(tris12, ro, rd, t_near, tf.contiguous()))
            call["plain_ms"] = p["ms"]
            out.update({f"main_{K1_NAMED[i]}_{key}": call[key]
                        for key in ("ms", "call_ms", "plain_ms", "bound_ms", "live")})
        print(f"K1 time[main path {i}]: kernel {_fmt(k)}"
              + (f"; plain {call['plain_ms']:.4f} ms" if "plain_ms" in call else "")
              + f"; bound {bound['bound_ms']:.4f} ms")
        out["main_calls"].append(call)
        out["main_ms_sum"] += k["ms"]
        out["main_bound_ms_sum"] += bound["bound_ms"]
        out["max_abs_err"] = max(out["max_abs_err"], chk["max_abs_err"])
    print(f"K1 all {len(calls)} main-path calls of sample 0: {out['main_ms_sum']:.4f} ms device "
          f"(bound {out['main_bound_ms_sum']:.4f} ms)")

    rows, ro, rd, t_far = dc.tie_scene(DENSE_TIE_DISTINCT, DENSE_TIE_COPIES, TIE_LANES, seed=21)

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(arrays.tris12.device)

    _check_k1(f"tie scene, rows {rows.shape}", cuda(rows), V3(*(cuda(c) for c in ro)),
              V3(*(cuda(c) for c in rd)), 0.0, cuda(t_far))
    return out


def _check_k2(label: str, tris12, ro, rd, t_near, t_far) -> dict:
    """K2 against its plain version on one call, bit for bit, through the
    wrapper and in both forms forced through the C interface
    (`dense_check.K2_FORMS`); dead lanes must report 1."""
    import torch

    from pim_tpu_torch.render import dense_kernels as dk
    from pim_tpu_torch.tools.dense_check import K2_FORMS

    got = dk.dense_anyhit(tris12, ro, rd, t_near, t_far)
    plain = dk.dense_anyhit_plain(tris12, ro, rd, t_near, t_far)
    forms = {name: dk.anyhit_launch(tris12, ro, rd, t_near, t_far, wb)
             for name, wb in K2_FORMS.items()}
    torch.cuda.synchronize()
    n = ro.x.shape[0]
    dead = torch.as_tensor(t_far, device=ro.x.device).expand(n) <= 0.0
    equal = {"wrapper": bool(torch.equal(got, plain)),
             **{name: bool(torch.equal(h, plain)) for name, h in forms.items()}}
    dead_ones = bool((got[dead] == 1).all())
    print(f"K2 dense_anyhit[{label}]: {n} rays, {n - int(dead.sum())} live, blocked "
          f"{int(got.sum())}; bitwise equal to plain {equal}; dead lanes report 1 {dead_ones}")
    if not all(equal.values()):
        raise AssertionError(f"K2 [{label}] differs from its plain version: {equal}")
    if not dead_ones:
        raise AssertionError(f"K2 [{label}]: a dead lane did not report 1")
    return dict(live=n - int(dead.sum()), max_abs_err=float((got - plain).abs().max()))


def check_k2_main_path(scene, calls, dev) -> dict:
    """K2 on the Cornell main path's own rays: `calls`, the K2 calls of
    sample 0 of one WIDTH^2, BOUNCES-bounce step (one NEE shadow-ray call a
    bounce, dead lanes at t_far = 0), each checked by `_check_k2` and timed
    beside its bound (the tests each live ray needs up to its first blocker,
    `dense_check.anyhit_tests`), the K2_NAMED ones beside their plain
    version; the light-grid bake's call of a Cornell build on the card; a
    tie scene (coincident triangles in shuffled rows over two chunks of
    rows, a dead warp, a warp of one ray, a half-dead warp); and a table of
    K2_WIDE_ROWS distinct triangles whose rays meet their first blocker in
    any chunk of rows.  Returns the K2 row's main-path and bake keys."""
    import numpy as np
    import torch

    from pim_tpu_torch.math.vec3 import V3
    from pim_tpu_torch.render import dense_kernels as dk
    from pim_tpu_torch.tools import dense_check as dc

    meta, arrays, _ = scene
    n_tri = meta.tri_count
    rows_bytes = n_tri * 12 * 4
    out = dict(main_calls=[], main_ms_sum=0.0, main_bound_ms_sum=0.0, max_abs_err=0.0)

    def timed(label, tris12, ro, rd, t_near, t_far, with_plain):
        chk = _check_k2(label, tris12, ro, rd, t_near, t_far)
        n = ro.x.shape[0]
        need = int(dc.anyhit_tests(tris12[:n_tri], ro, rd, t_near, t_far).sum())
        bound = _bound(_ray_bytes(n, t_far) + rows_bytes + n * 4, need * BW_TEST_FLOPS)
        k = _timing(lambda: dk.dense_anyhit(tris12, ro, rd, t_near, t_far))
        row = dict(n=n, live=chk["live"], tests=need, ms=k["ms"], call_ms=k["call"][0],
                   bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
        if with_plain:
            tf = torch.as_tensor(t_far, dtype=torch.float32, device=ro.x.device).expand(n)
            p = _timing(lambda: dk.dense_anyhit_plain(tris12, ro, rd, t_near, tf.contiguous()))
            row["plain_ms"] = p["ms"]
        print(f"K2 time[{label}]: kernel {_fmt(k)}"
              + (f"; plain {row['plain_ms']:.4f} ms" if with_plain else "")
              + f"; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}, {need} tests)")
        out["max_abs_err"] = max(out["max_abs_err"], chk["max_abs_err"])
        return row

    for i, call in enumerate(calls):
        row = timed(f"main path {i}", *call, i in K2_NAMED)
        if i in K2_NAMED:
            out.update({f"main_{K2_NAMED[i]}_{key}": row[key]
                        for key in ("ms", "call_ms", "plain_ms", "bound_ms", "live")})
        out["main_calls"].append(dict(call=i, **row))
        out["main_ms_sum"] += row["ms"]
        out["main_bound_ms_sum"] += row["bound_ms"]
    print(f"K2 all {len(calls)} main-path calls of sample 0: {out['main_ms_sum']:.4f} ms device "
          f"(bound {out['main_bound_ms_sum']:.4f} ms)")
    bake = dc.bake_calls(dev)
    for i, call in enumerate(bake):
        row = timed(f"light-grid bake {i}", *call, False)
        out.update({f"bake_{key}": row[key] for key in ("n", "ms", "call_ms", "bound_ms")})

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    for label, (rows, ro, rd, t_far) in (
            ("tie scene", dc.tie_scene(DENSE_TIE_DISTINCT, DENSE_TIE_COPIES, TIE_LANES, seed=21)),
            (f"{K2_WIDE_ROWS} distinct rows", dc.wide_scene(K2_WIDE_ROWS, TIE_LANES, seed=31))):
        _check_k2(f"{label}, rows {rows.shape}", cuda(rows), V3(*(cuda(c) for c in ro)),
                  V3(*(cuda(c) for c in rd)), 0.0, cuda(t_far))
    return out


def run_cornell(dev):
    """Phase 3; returns (kernel rows, launches of the main path)."""
    import torch

    from pim_tpu_torch import native
    from pim_tpu_torch.app import build_cornell_scene, gate_band, render_frame
    from pim_tpu_torch.tools import dense_check as dc

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
    lo, hi = gate_band("cornell512")
    print(f"cornell scene build on card: {build_s:.3f} s, launches {build_launches}")
    print(_frame_line(f"cornell frame {WIDTH}x{HEIGHT} bounces={BOUNCES} spp/step={SPP} "
                      f"steps={STEPS} band=[{lo:.6f}, {hi:.6f}]", fr))
    print(f"cornell launches during build+frame: {launches}")
    _check_frame(fr, WIDTH * HEIGHT, CORNELL_KERNELS)
    if not lo <= fr.mean <= hi:
        raise AssertionError(f"frame mean {fr.mean} outside the cornell512 band [{lo}, {hi}]")
    _check_no_syncs("cornell frame", scene, "cornell", WIDTH, SPP)
    check_small_frame("cornell", _scene_to(cpu_scene, dev), cpu_scene)
    calls = dc.main_path_calls(scene, WIDTH, HEIGHT, BOUNCES)
    torch.cuda.synchronize()
    for name, main in (("dense_isect", check_k1_main_path(scene, calls["isect"])),
                       ("dense_anyhit", check_k2_main_path(scene, calls["anyhit"], dev))):
        row = kernels[name]
        row["max_abs_err"] = max(row["max_abs_err"], main.pop("max_abs_err"))
        row.update(main)
    return kernels, launches, cpu_scene


def _bounce_rays(dev, scene, scene_name: str = "e1m1"):
    """262,144 rays of one seeded bounce off the primary hits of the scene's
    bench camera, ~10% dead lanes and one fully dead 2048-ray run: (ro, rd,
    t_far for closest hits, t_far for shadow-like any hits)."""
    import numpy as np
    import torch

    from pim_tpu_torch.math.vec3 import RCP_EPS, V3, normalize, where3
    from pim_tpu_torch.render.scene import intersect_raw

    meta, arrays, _ = scene
    ro, rd = _camera_rays(dev, scene_name)
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


def check_k6(label: str, planes, idx, tx, ty, valid, c: int, time_it: bool = True):
    """K6 against its plain version on one call's arguments, bitwise; with
    `time_it` also timed beside its plain version and one `embedding_bag`
    (`fetch_check.embedding_bag_call`).  Returns (max abs error, kernel,
    plain, bound, library) or (max abs error,)."""
    import torch

    from pim_tpu_torch.render import table_gather as tg
    from pim_tpu_torch.tools.fetch_check import embedding_bag_call

    k, n = idx.shape
    out_k = tg.gather_bilinear(planes, idx, tx, ty, valid, c=c)
    out_p = tg.gather_bilinear_plain(planes, idx, tx, ty, valid, c=c)
    torch.cuda.synchronize()
    same = _bits_equal(out_k, out_p)
    if time_it or not same:
        print(f"K6 gather_bilinear[{label}] planes {tuple(planes.shape)} x [{k}, {n}] C={c}: "
              f"bitwise_equal={same} finite={bool(torch.isfinite(out_k).all())} "
              f"valid={int(valid.sum())}")
    if not same:
        raise AssertionError(f"K6 differs from its plain version on the {label}")
    err = float((out_k - out_p).abs().max())
    if not time_it:
        return (err,)
    times = _time_pair(f"K6 time[{label}]", lambda: tg.gather_bilinear(planes, idx, tx, ty, valid,
                                                                        c=c),
                       lambda: tg.gather_bilinear_plain(planes, idx, tx, ty, valid, c=c))
    bag = embedding_bag_call(planes, idx, tx, ty, valid, c)
    lib = _timing(bag)
    lib_diff = float((bag().T.reshape(c, k, n) - out_k).abs().max())
    # a query reads its flag and writes C values; a valid one also reads
    # its index and two weights, and the texels the valid queries reach
    # are read once; a valid query makes 6 weight operations and 7 per
    # channel
    ok = valid.reshape(-1)
    n_valid = int(ok.sum())
    texels = idx.reshape(-1)[ok].clamp(0, planes.shape[1] - 1)
    bound = _bound(k * n * (1 + 4 * c) + n_valid * 12 + _touched_bytes(texels, 4 * c * 4),
                   n_valid * (6 + 7 * c))
    print(f"K6 library embedding_bag[{label}]: {_fmt(lib)}; largest difference from K6 "
          f"{lib_diff:.3e}; bound {bound['bound_ms']:.4f} ms")
    return (err, *times, bound, lib)


def check_e1m1_kernels(dev, scene):
    """K4/K5/K6 against their plain versions at the e1m1 shapes."""
    import numpy as np
    import torch

    from pim_tpu_torch.render import cluster as CL
    from pim_tpu_torch.render import table_gather as tg
    from pim_tpu_torch.render.lights import make_light_table
    from pim_tpu_torch.render.raysort import sorted_rays
    from pim_tpu_torch.tools.cluster_check import main_path_wavefronts
    from pim_tpu_torch.tools.fetch_check import serving_step_calls

    meta, arrays, lights = scene
    cl = CL.ClusterArrays(tris=arrays.cl_tris, clb=arrays.cl_clb, scb=arrays.cl_scb)
    ro, rd, t_far, t_short = _bounce_rays(dev, scene)
    waves = main_path_wavefronts(scene)
    print(f"e1m1 hierarchy: tris {tuple(cl.tris.shape)} clb {tuple(cl.clb.shape)} "
          f"scb {tuple(cl.scb.shape)}, {int((cl.tris[12] >= 0).sum())} real slots; random rays "
          f"{N_RAYS}, dead {int((t_far <= 0.0).sum())}; main path: the bounce-1 and NEE shadow "
          f"rays of a {WIDTH}^2 1-spp step, sorted; plain compared on lanes [0, {PLAIN_LANES})")
    results = {"cluster_isect": check_cluster_pair(cl, False, (ro, rd, 0.0, t_far),
                                                   waves["bounce"]),
               "cluster_anyhit": check_cluster_pair(cl, True, (ro, rd, 0.0, t_short),
                                                    waves["shadow"])}
    check_tie_scene(dev)
    sro, srd, stf, _ = sorted_rays(meta.grid_spec(), ro, rd, t_far)

    rs = np.random.default_rng(77)
    k6 = {}
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
        k6[label] = check_k6(label, planes, *args, c)
    # the wrapper's texel-interleaved copy, made on the planes' first K6 call
    copy = _timing(lambda: arrays.atlas_corners.T.contiguous())
    print(f"K6 texel-interleaved copy of the atlas corner planes (made once, on their first K6 "
          f"call): {_fmt(copy)}")
    served = serving_step_calls(scene, WIDTH, HEIGHT, BOUNCES)
    for label in ("atlas", "sky"):
        calls = served[f"k6_{label}"]
        for i, (planes, idx, tx, ty, valid, c) in enumerate(calls):
            got = check_k6(f"{label} main-path {i}", planes, idx, tx, ty, valid, c, time_it=i == 0)
            if i == 0:
                k6[f"main_{label}"] = got
        print(f"K6 main path: the {len(calls)} {label} calls of one {WIDTH}^2, {BOUNCES}-bounce "
              f"serving step, bitwise_equal=True")
    row = _row(max(v[0] for v in k6.values()), *k6["atlas"][1:])
    row["rows_copy_ms"] = copy["ms"]
    for key in ("sky", "main_atlas", "main_sky"):
        row.update({f"{key}_{name}": v for name, v in _row(0.0, *k6[key][1:]).items()
                    if name != "max_abs_err"})
    results["gather_bilinear"] = row

    # K3 on the four tables the e1m1 frame fetches from
    tables = {
        "tri_table": arrays.tri_table,
        "tex_rec_t": arrays.tex_rec_t,
        "light_table": make_light_table(lights, arrays.cell_active_f),
        "emissive_table": arrays.emissive_table,
    }
    k3_err, k3_times = check_gather_cols(dev, "e1m1", tables, rs)
    mp = main_path_indices(scene, sro, srd, stf)
    tt = arrays.tri_table
    e, k3_times["main"] = check_k3("e1m1 tri_table main-path", tt, mp["tri"])
    # the wrapper's copy of the tri table, made on the table's first call
    copy = _timing(lambda: tt.T.contiguous())
    print(f"K3 row-major copy of the e1m1 tri table (made on the table's first K3 call: after "
          f"the build and once per training step): {_fmt(copy)}")
    check_wide_offsets(dev, {"staged": arrays.emissive_table, "direct": tables["light_table"],
                             "rows": tt},
                       {"staged": arrays.sky.reshape(-1, 3).T.contiguous(),
                        "direct": arrays.atlas_planes}, rs)
    row = _row(max(k3_err, e), *k3_times["tri_table"])
    row["rows_copy_ms"] = copy["ms"]
    row.update({f"main_{k}": v for k, v in _row(0.0, *k3_times["main"]).items()
                if k != "max_abs_err"})
    results["gather_cols"] = row
    return results, mp


WIDE_LANES = 1 << 28  # the large K3 call: 8 rows x 2^28 lanes = 2^31 output floats
WIDE_CHUNK = 1 << 24  # lanes compared with the plain version at a time


def check_wide_offsets(dev, k3_tables, k7_planes, rs):
    """The 64-bit-offset variants, which the main paths do not reach: each
    form of K3 (int32 and int64 indices) and K7 at the main path's tables,
    on the vector and the scalar path, launched through the library's C
    interface with 64-bit offsets forced, bitwise against the plain
    version; each form of K3-bwd the same way at the graft's and the tri
    table's shapes, and of K7-bwd at the sky's and the atlas's, within the
    atomics' bound of a float64 plain sum; then
    one K3 call through the wrapper whose [8, WIDE_LANES] output passes
    2^31 floats, so that the wrapper itself picks 64-bit offsets, bitwise."""
    import numpy as np
    import torch

    from pim_tpu_torch import native
    from pim_tpu_torch.render import gather_kernel as gk
    from pim_tpu_torch.render import table_gather as tg
    from pim_tpu_torch.tools.fetch_check import scatter_error
    from pim_tpu_torch.tools.fetch_variants import bwd_launcher
    from pim_tpu_torch.tools.gather_variants import launcher

    lib = native.load()
    checked = 0
    for kind, tables in (("k3", k3_tables), ("k7", k7_planes)):
        for form, table in tables.items():
            t = table.shape[1]
            shape = (N_RAYS,) if kind == "k3" else (4, N_RAYS)
            base = torch.from_numpy(rs.integers(-1, t + 1, shape).astype(np.int32)).to(dev)
            for dtype in ((torch.int32, torch.int64) if kind == "k3" else (torch.int32,)):
                for vec in (True, False):
                    idx = base.to(dtype) if vec else base.to(dtype).reshape(-1)[1:]
                    if kind == "k7" and not vec:
                        idx = idx[: 3 * (N_RAYS - 1)].view(3, N_RAYS - 1)
                    plain = (gk.gather_cols_plain(table, idx) if kind == "k3"
                             else tg.gather_texels_plain(table, idx))
                    out = torch.empty_like(plain)
                    launcher(lib, kind, form, table, idx, out, wide=True, vec=vec)()
                    torch.cuda.synchronize()
                    if not _bits_equal(out, plain):
                        raise AssertionError(f"{kind.upper()} {form}, 64-bit offsets, "
                                             f"{str(dtype)[6:]}, vec={vec}: differs from plain")
                    checked += 1
    print(f"64-bit offsets: {checked} forced launches of K3 (staged, direct, row-major copy; "
          f"int32, int64) and K7 (staged, direct), vector and scalar paths: bitwise_equal=True")
    checked = 0
    for form, (f, t) in (("staged", (4, 208)), ("direct", (48, 81552)), ("rows", (48, 81552))):
        base = torch.from_numpy(rs.integers(-1, t + 1, N_RAYS).astype(np.int32)).to(dev)
        g_base = torch.from_numpy(rs.standard_normal((f, N_RAYS)).astype(np.float32)).to(dev)
        for dtype in (torch.int32, torch.int64):
            for vec in (True, False):
                idx = base.to(dtype) if vec else base.to(dtype)[1:]
                g = g_base if vec else g_base[:, 1:].contiguous()
                run, grad = bwd_launcher(g, idx, t, form, vec, wide=1)
                run()
                torch.cuda.synchronize()
                if not scatter_error(grad(), gk.gather_cols_bwd_plain, g, idx, t)[0]:
                    raise AssertionError(f"K3-bwd {form}, 64-bit offsets, {str(dtype)[6:]}, "
                                         f"vec={vec}: leaves the atomics' bound")
                checked += 1
    print(f"64-bit offsets: {checked} forced launches of K3-bwd (staged [4, 208]; direct and "
          f"row-major [48, 81552]; int32, int64; vector and scalar paths): within "
          f"gamma(adds-1)*sum|g|")
    checked = 0
    for form, (c, t) in (("staged", (3, 6144)), ("direct", (4, 32768)), ("rows", (4, 32768))):
        base = torch.from_numpy(rs.integers(-2, t + 2, 4 * N_RAYS).astype(np.int32)).to(dev)
        g_base = torch.from_numpy(
            rs.standard_normal((c, 4 * N_RAYS)).astype(np.float32)).to(dev)
        for vec in (True, False):
            idx = base if vec else base[1:]
            g = g_base if vec else g_base[:, 1:].contiguous()
            run, grad = bwd_launcher(g, idx, t, form, vec, wide=1, clip=True)
            run()
            torch.cuda.synchronize()
            if not scatter_error(grad(), tg.gather_texels_bwd_plain, g, idx, t)[0]:
                raise AssertionError(f"K7-bwd {form}, 64-bit offsets, vec={vec}: leaves the "
                                     f"atomics' bound")
            checked += 1
    print(f"64-bit offsets: {checked} forced launches of K7-bwd (staged [3, 6144]; direct and "
          f"texel-interleaved [4, 32768]; 4 x 262,144 lanes clipped into range; vector and "
          f"scalar paths): within gamma(adds-1)*sum|g|")
    table = torch.from_numpy(rs.standard_normal((8, 1000)).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    idx = torch.randint(-1, 1001, (WIDE_LANES,), generator=gen, device=dev, dtype=torch.int32)
    v = gk.gather_variant(table.numel(), 8 * WIDE_LANES, WIDE_LANES, idx.data_ptr())
    if not v.wide:
        raise AssertionError(f"the wrapper did not pick 64-bit offsets: {v}")
    out = gk.gather_cols(table, idx)
    same = all(_bits_equal(out[:, s : s + WIDE_CHUNK],
                           gk.gather_cols_plain(table, idx[s : s + WIDE_CHUNK]))
               for s in range(0, WIDE_LANES, WIDE_CHUNK))
    print(f"K3 gather_cols (8, 1000) x {WIDE_LANES} int32 ({8 * WIDE_LANES} output floats, "
          f"variant {tuple(v)}): bitwise_equal={same}")
    if not same:
        raise AssertionError("K3 with 64-bit offsets differs from its plain version")
    del out, idx


def check_cluster(label: str, cl, args, anyhit: bool, plain_lanes: int = PLAIN_LANES):
    """K4 (K5 with `anyhit`) on rays `args` (ro, rd, t_near, t_far): the
    wrapper bit for bit against the plain version on the first
    `plain_lanes` lanes, and on every lane against both of the kernel's ways
    of testing a cluster (lane_loop_min 1: every lane its own ray; 33: ray
    by ray), launched through the C interface, and against the walk replay
    (`walk_counts`); dead lanes report a miss.  Prints the walk's counts per
    ray; returns (those counts, the largest difference from the plain
    version)."""
    import torch

    from pim_tpu_torch.render import cluster as CL
    from pim_tpu_torch.tools import cluster_check as cc

    ro, rd, t_near, t_far = args
    n = ro.x.shape[0]
    tf = CL._per_ray_t_far(t_far, n, ro.x.device)
    got, plain_same, err = cc.against_plain(cl, args, anyhit, plain_lanes)
    ways = {k: cc.launcher(anyhit, cl, *args, k)() for k in (1, 33)}
    walk = cc.walk_counts(cl, ro, rd, t_near, t_far, anyhit, CL.LANE_LOOP_MIN)
    replay = (walk["hit"],) if anyhit else (walk["t"], walk["tri"])
    torch.cuda.synchronize()
    same = {f"plain on {min(plain_lanes, n)} lanes": plain_same,
            "lane_loop_min 1": cc.same_bits(got, ways[1]),
            "lane_loop_min 33": cc.same_bits(got, ways[33]),
            "walk replay": cc.same_bits(got, replay)}
    dead = tf <= 0.0
    if anyhit:
        dead_ok = not bool(got[0][dead].any())
        what = f"blocked={int(got[0].sum())}"
    else:
        dead_ok = bool(((got[1] == -1) & (got[0] == -1.0))[dead].all())
        what = f"hits={int((got[1] >= 0).sum())}"
    per = {k: walk[k] / n for k in ("needed_clusters", "needed_tests", "union_tests",
                                    "kernel_tests", "slab_tests")}
    print(f"{label}: {n} rays, {int(dead.sum())} dead, {what}; bitwise equal: "
          + ", ".join(f"{k} {v}" for k, v in same.items()) + f"; dead lanes miss: {dead_ok}")
    print(f"{label} per ray: needed clusters {per['needed_clusters']:.3f}, needed "
          f"tests {per['needed_tests']:.2f}; slot tests issued: a warp-union walk "
          f"{per['union_tests']:.1f}, this kernel {per['kernel_tests']:.1f}; slab tests, both "
          f"walks, {per['slab_tests']:.1f} (lanes entering a "
          f"cluster a warp enters: {walk['entering_lanes'] / max(walk['warp_clusters'], 1):.2f} "
          f"of 32; warp-clusters per warp {32 * walk['warp_clusters'] / n:.2f})")
    if not all(same.values()):
        raise AssertionError(f"{label} differs: {same}")
    if not dead_ok:
        raise AssertionError(f"{label}: a dead lane reported a hit")
    return {k: v for k, v in walk.items() if not torch.is_tensor(v)}, err


def check_cluster_pair(cl, anyhit: bool, random_args, main_args) -> dict:
    """K4 (K5 with `anyhit`) checked (`check_cluster`) and timed on the
    seeded random rays, beside its plain version on PLAIN_LANES lanes, and
    on the main path's wavefront (L2-cold too).  The bound counts the real
    slots of every (ray, cluster) pair a traversal needs, but one test for a
    ray that K5 finds blocked, 31 operations a test (`walk_counts`).
    Returns the JSON row (the main path's numbers prefixed main_)."""
    import torch

    from pim_tpu_torch.math.vec3 import V3
    from pim_tpu_torch.render import cluster as CL

    name = "K5 cluster_anyhit" if anyhit else "K4 cluster_isect"
    wrap, plain = ((CL.cluster_anyhit, CL.cluster_anyhit_plain) if anyhit
                   else (CL.cluster_isect, CL.cluster_isect_plain))
    cl_bytes = sum(x.numel() * 4 for x in (cl.tris, cl.clb, cl.scb))
    row = {}
    for which, args in (("random", random_args), ("main", main_args)):
        ro, rd, t_near, t_far = args
        n = ro.x.shape[0]
        counts, err = check_cluster(f"{name} [{which}]", cl, args, anyhit)
        k = _timing(lambda: wrap(cl, ro, rd, t_near, t_far), cold=True)
        out_bytes = n * (4 if anyhit else 8)
        bound = _bound(_ray_bytes(n, t_far) + cl_bytes + out_bytes,
                       counts["needed_tests"] * BW_TEST_FLOPS)
        if which == "random":
            sub = slice(0, PLAIN_LANES)
            pargs = (V3(*(c[sub] for c in ro)), V3(*(c[sub] for c in rd)), t_near, t_far[sub])
            p = _timing(lambda: plain(cl, *pargs), PLAIN_RUNS, queued=False)
            print(f"{name} time [random]: kernel {_fmt(k)}; plain {_fmt(p)} ({PLAIN_RUNS} runs "
                  f"on {PLAIN_LANES} lanes); bound {bound['bound_ms']:.4f} ms")
            row.update(_row(err, k, p, bound))
        else:
            print(f"{name} time [main path]: {_fmt(k)}; bound {bound['bound_ms']:.4f} ms")
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row.update({f"main_{key}": v for key, v in _row(err, k, k, bound).items()
                        if not key.startswith(("plain", "library"))})
        prefix = "" if which == "random" else "main_"
        row.update({f"{prefix}{key}_per_ray": v / n for key, v in counts.items()})
    return row


TIE_COPIES = 200      # copies of each triangle of the tie scene
TIE_DISTINCT = 40     # distinct triangles of the tie scene
TIE_LANES = 32768     # rays of the tie scene, all compared with the plain versions


def check_tie_scene(dev) -> None:
    """K4 and K5 on a scene where equal t occurs: TIE_DISTINCT triangles,
    each TIE_COPIES times in shuffled slots of different clusters, with one
    supercluster of padding slots only (its boxes the whole scene's)
    inserted after the first; TIE_LANES rays aimed at the triangles, with
    ~10% dead lanes, a 32-lane group all dead, one of 32 equal rays (all
    blocked at once) and one half dead.  Bit for bit on every lane
    (`check_cluster`)."""
    import numpy as np
    import torch

    from pim_tpu_torch.math.vec3 import V3
    from pim_tpu_torch.render import cluster as CL
    from pim_tpu_torch.tools.cluster_check import (
        aimed_rays,
        tie_soup,
        with_padding_supercluster,
    )

    soup, base = tie_soup(TIE_DISTINCT, TIE_COPIES, seed=12)
    built = CL.build_clusters(soup)
    cl = CL.ClusterArrays(*(torch.from_numpy(x).to(dev)
                            for x in with_padding_supercluster(*built, at=1)))
    ro, rd, t_far = aimed_rays(base, TIE_LANES, seed=13)
    t_far[:32] = 0.0
    ro[:, 32:64], rd[:, 32:64], t_far[32:64] = ro[:, 32:33], rd[:, 32:33], 1e6
    t_far[64:96:2] = 0.0
    rs = np.random.default_rng(14)
    t_short = np.where(t_far > 0.0, rs.uniform(0.5, 15.0, TIE_LANES), 0.0).astype(np.float32)
    t_short[32:64] = 1e6

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    rays = (V3(*(cuda(c) for c in ro)), V3(*(cuda(c) for c in rd)), 0.0)
    print(f"tie scene: {TIE_DISTINCT} triangles x {TIE_COPIES} copies, tris "
          f"{tuple(cl.tris.shape)}, an all-padding supercluster at 1")
    check_cluster("K4 cluster_isect [tie scene]", cl, (*rays, cuda(t_far)), False, TIE_LANES)
    check_cluster("K5 cluster_anyhit [tie scene]", cl, (*rays, cuda(t_short)), True, TIE_LANES)


def main_path_indices(scene, sro, srd, stf) -> dict:
    """The indices the main path hands K3 and K7 at the hits of rays in
    raysort's order: "tri", K4's tri ids clamped as surface.py passes them
    to the tri-table fetch; "atlas", the [12, N] corner indices that
    `surface._bilinear_setup` makes there for the albedo, ROME and normal
    textures; "sky", sky.py's [4, N] cube corners of the rays' directions."""
    import torch

    from pim_tpu_torch.render import cluster as CL
    from pim_tpu_torch.render import fetch as F
    from pim_tpu_torch.render import gather_kernel as gk
    from pim_tpu_torch.render import surface
    from pim_tpu_torch.render.scene import _finalize_hit_fused
    from pim_tpu_torch.render.sky import cube_corner_idx

    meta, arrays, _ = scene
    cl = CL.ClusterArrays(tris=arrays.cl_tris, clb=arrays.cl_clb, scb=arrays.cl_scb)
    t, tri = CL.cluster_isect(cl, sro, srd, 0.0, stf)
    hit = _finalize_hit_fused(arrays, t, tri, sro, srd)
    tri_idx = torch.clamp_min(tri, 0)
    rows = gk.gather_cols_plain(arrays.tri_table, tri_idx)
    uv = surface.hit_uv(rows, 1.0 - hit.u - hit.v, hit.u, hit.v)
    atlas = torch.cat([surface._bilinear_setup(arrays.tex_rec_t, rows[r].to(torch.int32), uv)[0]
                       for r in (F.ALBEDO_TEX, F.ROME_TEX, F.NORMAL_TEX)], dim=0)
    sky = cube_corner_idx(arrays.sky.shape[1], srd)[0]
    print(f"main-path indices: {int((tri >= 0).sum())} hits of {tri.shape[0]} sorted rays, "
          f"{int(torch.unique(tri_idx).numel())} distinct tri ids; atlas {tuple(atlas.shape)} "
          f"({int(torch.unique(atlas).numel())} distinct texels); sky {tuple(sky.shape)} "
          f"({int(torch.unique(sky).numel())} distinct texels)")
    return {"tri": tri_idx.contiguous(), "atlas": atlas.contiguous(), "sky": sky.contiguous()}


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


BSDF_SEED = 3_141_592_653  # the seeded lanes of the BSDF kernels' check


def _check_bsdf_bits(label: str, diffs: dict) -> None:
    print(f"{label}: lanes whose bits differ {diffs}")
    if any(diffs.values()):
        raise AssertionError(f"{label}: the BSDF kernels differ from the plain form")


def check_bsdf(dev, scene) -> dict:
    """The BSDF kernels against the plain form, bit for bit, on seeded and
    edge lanes and on the first scatter and eval calls of one e1m1 512^2,
    10-bounce step; each kernel timed there beside its byte bound and the
    plain form (a wall: it dispatches hundreds of ops).  Returns the three
    kernel rows."""
    import torch

    from pim_tpu_torch.app import bench_camera, render_step
    from pim_tpu_torch.math.brdf import BrdfLut
    from pim_tpu_torch.math.vec3 import V3
    from pim_tpu_torch.render import bsdf
    from pim_tpu_torch.tools import bsdf_check as bc

    meta, arrays, _ = scene
    lut = BrdfLut(texels=arrays.brdf_lut)
    for label, lanes in (("seeded", bc.random_lanes(N_RAYS, BSDF_SEED, dev)),
                         ("edge", bc.edge_lanes(dev))):
        n = lanes.i.x.shape[0]
        for refract in (False, True):
            _check_bsdf_bits(f"bsdf_scatter {label} lanes ({n}), glass path {refract}",
                             bc.scatter_differences(lut, lanes, refract))
        _check_bsdf_bits(f"bsdf_eval {label} lanes ({n})", bc.eval_differences(lut, lanes))

    with bc.recorded_calls() as calls:
        render_step(scene, bench_camera("e1m1", WIDTH, HEIGHT), WIDTH, HEIGHT, BOUNCES, 1, 0)
    torch.cuda.synchronize()
    s_lut, surf, i, state, occluded_fn = calls["scatter"][0]
    e_lut, e_surf, e_i, e_l = calls["eval"][0]
    n = i.x.shape[0]
    probes = []

    def probe(p, l, mask):
        probes.append((p, l, mask))
        return occluded_fn(p, l, mask)

    got_state, got = bsdf.scatter_principled(s_lut, surf, i, state, probe)
    want_state, want = bsdf.scatter_principled_plain(s_lut, surf, i, state, probe)
    diffs = bc.differing([*got_state, *got.pos, *got.dir, *got.attenuation, got.pdf,
                          *probes[0][0], *probes[0][1], probes[0][2]],
                         [*want_state, *want.pos, *want.dir, *want.attenuation, want.pdf,
                          *probes[1][0], *probes[1][1], probes[1][2]])
    _check_bsdf_bits(f"bsdf_scatter main path bounce 1 ({n} lanes; words, pos, dir, "
                     "attenuation, pdf, probe origin, direction, mask)", dict(enumerate(diffs)))
    got_a, got_p = bsdf.eval_principled(e_lut, e_surf, e_i, e_l)
    want_a, want_p = bsdf.eval_principled_plain(e_lut, e_surf, e_i, e_l)
    _check_bsdf_bits(f"bsdf_eval main path bounce 1 ({n} lanes; attenuation, pdf)",
                     dict(enumerate(bc.differing([*got_a, got_p], [*want_a, want_p]))))

    fields = [t.contiguous() for t in bsdf.scatter_fields(surf, i, state)]
    out, _, mask = bsdf.bsdf_scatter(s_lut.texels, fields, True)
    t_hit = occluded_fn(V3(out[10], out[11], out[12]), V3(out[13], out[14], out[15]),
                        mask).contiguous()
    albedo, rough = V3(*fields[9:12]), fields[12]
    probed = int(mask.sum())
    print(f"bsdf main path bounce 1: {n} lanes, {probed} probed for thickness")

    def given(p, l, m):
        return t_hit

    rows = {}
    k, p = _time_pair("bsdf_scatter main path bounce 1 (glass path)",
                      lambda: bsdf.bsdf_scatter(s_lut.texels, fields, True),
                      lambda: bsdf.scatter_principled_plain(s_lut, surf, i, state, given),
                      plain_runs=PLAIN_RUNS, plain_queued=False)
    rows["bsdf_scatter"] = _row(0.0, k, p, _bound(bc.scatter_bytes(n, True), 0))
    k0, p0 = _time_pair("bsdf_scatter main path bounce 1 (no glass path, Cornell's form)",
                        lambda: bsdf.bsdf_scatter(s_lut.texels, fields, False),
                        lambda: bsdf.scatter_principled_plain(s_lut, surf, i, state),
                        plain_runs=PLAIN_RUNS, plain_queued=False)
    rows["bsdf_scatter"].update({f"noglass_{key}": v for key, v in _row(
        0.0, k0, p0, _bound(bc.scatter_bytes(n, False), 0)).items() if key != "max_abs_err"})
    scratch = out.clone()
    k, p = _time_pair("bsdf_refract_finish main path bounce 1",
                      lambda: bsdf.bsdf_refract_finish(scratch, mask, t_hit, albedo, rough),
                      lambda: bc.refract_finish_plain(out, mask, t_hit, albedo, rough),
                      plain_runs=PLAIN_RUNS, plain_queued=False)
    rows["bsdf_refract_finish"] = _row(0.0, k, p, _bound(bc.refract_finish_bytes(n, probed), 0))
    rows["bsdf_refract_finish"]["probed_lanes"] = probed
    efields = [t.contiguous() for t in bsdf.eval_fields(e_surf, e_i, e_l)]
    k, p = _time_pair("bsdf_eval main path bounce 1",
                      lambda: bsdf.bsdf_eval(e_lut.texels, efields),
                      lambda: bsdf.eval_principled_plain(e_lut, e_surf, e_i, e_l),
                      plain_runs=PLAIN_RUNS, plain_queued=False)
    rows["bsdf_eval"] = _row(0.0, k, p, _bound(bc.eval_bytes(n), 0))
    for name, row in rows.items():
        print(f"{name}: {row['ms']:.4f} ms device a call, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms wall")
    return rows


SKY_GRAD_SEED = 1_414_213_562  # the incoming gradient of the sky backward's check
SKY_PLAIN_RUNS = 3             # the plain form's bake takes seconds a call


def _wall_timing(setup, fn, runs: int) -> dict:
    """`_timing`'s dict for a function that waits on the device itself: the
    wall of `fn(setup())` from an idle device, CUDA events around `fn`
    alone, `runs` times after a warm-up."""
    import torch

    fn(setup())
    times = []
    for _ in range(runs):
        arg = setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    med = statistics.median(times)
    return dict(ms=med, ms_range=(min(times), max(times)), call=(med, min(times), max(times)))


def check_sky(dev) -> dict:
    """The sky kernels against the plain form on the card: the forward on
    `tools/sky_check.py`'s cases (the values whose bits differ, and the
    largest relative gap, at most 1e-6), the backward against autograd of the
    plain form (rtol 1e-4) and twice to the same bits; both timed on the
    training step's cube beside their operation bounds (each density
    evaluation the march needs, `tools/sky_check.py`) and the plain form's
    wall.  Returns the two kernel rows."""
    import torch

    from pim_tpu_torch import native
    from pim_tpu_torch.render import sky
    from pim_tpu_torch.tools import sky_check as sc

    gaps = {}
    for case in sc.cases(dev):
        before = native.launches["sky_bake"]
        got = sc.kernel_out(case)
        torch.cuda.synchronize()
        if native.launches["sky_bake"] != before + 1:
            raise AssertionError(f"sky {case.label}: sky_bake did not launch once")
        differ, gap = sc.forward_gap(got, sc.plain_out(case))
        gaps[case.label] = gap
        print(f"sky_bake {case.label} ({case.rd.x.shape[0]} directions, {case.steps} steps): "
              f"{differ} of {got.numel()} values differ, largest relative gap {gap:.3e}")
        if gap > 1e-6:
            raise AssertionError(f"sky_bake {case.label}: relative gap {gap} above 1e-6")
    case = sc.cases(dev)[1]
    g = sc.cube_grad(case, SKY_GRAD_SEED)
    got, again = sc.kernel_grads(case, g), sc.kernel_grads(case, g)
    want = sc.plain_grads(case, g)
    bwd_gap = 0.0
    for name, a, b, c in zip(("light_dir", "luminance"), got, want, again):
        bwd_gap = max(bwd_gap, float(((a - b).abs() / b.abs()).max()))
        print(f"sky_bake_bwd {name}: kernel {a.tolist()}, autograd of the plain form "
              f"{b.tolist()}; two runs {'the same bits' if _bits_equal(a, c) else 'DIFFER'}")
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * float(b.abs().max()))
        if not _bits_equal(a, c):
            raise AssertionError(f"sky_bake_bwd {name}: two runs give other bits")

    med = sky.earth_atmosphere()
    ld, lum = case.light_dir.detach(), case.luminance.detach()
    consts, trips = sky.sky_consts(med, case.ro, case.steps), sky.steps_to_trips(case.steps)
    work = sc.work(case)
    evals = work["view"] + work["sun"]
    print(f"sky march of the training cube: {work['view']} view samples, {work['sun']} sun-march "
          f"density evaluations (of {trips * sky.SUN_STEPS * case.rd.x.shape[0]} at most)")
    n_bytes = case.rd.x.shape[0] * 4 * 6 + 6 * 4  # directions in, [3, D] out, sun and luminance
    rows = {}
    k, p = _time_pair("sky_bake e1m1 training cube",
                      lambda: sky.sky_bake(case.rd, ld, lum, consts, trips),
                      lambda: sky.atmosphere_plain(med, case.ro, case.rd, ld, lum, case.steps),
                      plain_runs=SKY_PLAIN_RUNS, plain_queued=False)
    rows["sky_bake"] = _row(max(gaps.values()), k, p, _bound(n_bytes, evals * sc.EVAL_FLOPS))
    k = _timing(lambda: sky.sky_bake_bwd(case.rd, ld, lum, consts, trips, g))

    def plain_graph():
        out = sc.plain_out(case)
        return (out * g).sum()

    p = _wall_timing(plain_graph,
                     lambda loss: torch.autograd.grad(loss, [case.light_dir, case.luminance]),
                     SKY_PLAIN_RUNS)
    print(f"sky_bake_bwd e1m1 training cube (with sky_grad_sum): kernel {_fmt(k)}; plain "
          f"autograd backward {_fmt(p)} ({SKY_PLAIN_RUNS} runs)")
    rows["sky_bake_bwd"] = _row(bwd_gap, k, p, _bound(n_bytes + 3 * 4 * case.rd.x.shape[0],
                                                      evals * sc.EVAL_FLOPS_BWD))
    for name, row in rows.items():
        print(f"{name}: {row['ms']:.4f} ms device a call, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms wall")
    return rows


RNG_SEED = 3_141_592_653     # the stream seed of the RNG kernels' check
RNG_LANES = (N_RAYS, 1 << 20)  # a render step's lanes, the e1m1 bake's


def _check_rng_bits(label: str, diffs: list) -> None:
    print(f"{label}: lanes whose bits differ {diffs}")
    if any(diffs):
        raise AssertionError(f"{label}: the RNG kernels differ from the plain form")


def check_rng(dev) -> dict:
    """The RNG kernels against the plain int64 form at the main path's
    shapes (RNG_LANES), bit for bit: make_state with the sample id a Python
    int and a device scalar, and every draw helper on its words (rows of one
    block), on tools/rng_check.py's edge ids; each kernel timed at both
    shapes beside its byte bound and the plain form's wall (about 130 and
    260 launches a call).  Returns the two kernel rows (a render step's
    shape; the bake's under `bake_` keys)."""
    import torch

    from pim_tpu_torch import native
    from pim_tpu_torch.core import rng
    from pim_tpu_torch.tools import rng_check as rc

    rows = {}
    for n in RNG_LANES:
        ids = rc.edge_ids(n, dev)
        before = dict(native.launches)
        for label, sample_id in (("int", 5), ("device scalar", torch.tensor(5, device=dev))):
            _check_rng_bits(f"rng_seed {n} lanes, sample id a {label}",
                            rc.seed_differences(ids, sample_id, RNG_SEED))
        state = rng.make_state(ids, 5, RNG_SEED)
        for name in rc.HELPERS:
            _check_rng_bits(f"rng_draw {n} lanes, {name}", rc.helper_differences(name, state))
        torch.cuda.synchronize()
        launched = {k: native.launches[k] - before[k] for k in RNG_KERNELS}
        if launched != {"rng_seed": 3, "rng_draw": len(rc.HELPERS)}:
            raise AssertionError(f"rng {n} lanes: launches {launched}")
        k, p = _time_pair(f"rng_seed {n} lanes", lambda: rng.rng_seed(ids, 5, RNG_SEED),
                          lambda: rng.make_state_plain(ids, 5, RNG_SEED), plain_queued=False)
        seed_row = _row(0.0, k, p, _bound(rc.seed_bytes(n), 0))
        k, p = _time_pair(f"rng_draw {n} lanes, two floats (next_f32x2)",
                          lambda: rng.rng_draw(state, 2), lambda: rng.draw_plain(state, 2),
                          plain_queued=False)
        draw_row = _row(0.0, k, p, _bound(rc.draw_bytes(n, 2), 0))
        for name, row in (("rng_seed", seed_row), ("rng_draw", draw_row)):
            print(f"{name} {n} lanes: {row['ms']:.4f} ms device a call, call {row['call_ms']:.4f} "
                  f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
                  f"{row['plain_ms']:.4f} ms wall")
            if n == N_RAYS:
                rows[name] = row
            else:
                rows[name].update({f"bake_{key}": v for key, v in row.items()
                                   if key != "max_abs_err"})
    return rows


MEDIA_SEED = 1_618_033_988
MEDIA_MAIN_CALLS = 3     # the main path's calls of each media kernel held bit for bit


def _check_media_bits(label: str, diffs: dict) -> None:
    print(f"{label}: lanes whose bits differ {diffs}")
    if any(diffs.values()):
        raise AssertionError(f"{label}: the media kernels differ from the plain form")


def check_media(dev) -> dict:
    """The media kernels against the plain form at the main path's shape
    (N_RAYS lanes), bit for bit: tools/media_check.py's seeded lanes through
    its dense medium, the cornell-media cell's medium and a random one, and
    the first MEDIA_MAIN_CALLS calls of each kernel in a Cornell 512^2,
    10-bounce step through the cell's medium; each kernel timed on the
    seeded lanes through the cell's medium beside its bound (the bytes and
    the plain form's operations that the lanes' result needs,
    media_check.call_work, from the kernel's tally, which is held to the
    plain form's) and the plain form's
    wall (about 20,000 and 17,000 launches a call); the device ops of one
    such step with the kernels and with the plain form forced
    (media_check.step_launches).  Returns the two kernel rows."""
    import dataclasses

    import torch

    from pim_tpu_torch import native
    from pim_tpu_torch.app import bench_camera, build_cornell_scene
    from pim_tpu_torch.render import media
    from pim_tpu_torch.tools import media_check as mc

    lanes = mc.random_lanes(N_RAYS, MEDIA_SEED, dev)
    before = dict(native.launches)
    for name, kw in (("dense", mc.DENSE), ("cell", mc.CELL),
                     ("random", mc.random_medium(MEDIA_SEED))):
        desc = media.make_media_desc(**kw)
        _check_media_bits(f"media_scatter {N_RAYS} seeded lanes, {name} medium",
                          mc.scatter_differences(desc, *lanes))
        _check_media_bits(f"media_transmittance {N_RAYS} seeded lanes, {name} medium",
                          mc.transmittance_differences(desc, *lanes))
    torch.cuda.synchronize()
    launched = {k: native.launches[k] - before[k] for k in MEDIA_KERNELS}
    if launched != {"media_scatter": 3, "media_transmittance": 3}:
        raise AssertionError(f"media: launches {launched}")
    for kind in ("scatter", "tr"):
        _check_media_bits(f"media {kind} tally {N_RAYS} seeded lanes, cell medium",
                          mc.tally_differences(kind, media.make_media_desc(**mc.CELL), *lanes))

    cell = media.make_media_desc(**mc.CELL)
    meta, arrays, lights = build_cornell_scene(dev)
    scene = (dataclasses.replace(meta, media_enabled=True, media=cell), arrays, lights)
    cam = bench_camera("cornell", WIDTH, HEIGHT)
    calls = mc.main_path_calls(scene, cam, WIDTH, HEIGHT, BOUNCES, MEDIA_MAIN_CALLS)
    steps = {plain: mc.step_launches(scene, cam, WIDTH, HEIGHT, BOUNCES, plain)
             for plain in (False, True)}
    print(f"media step launches (aten ops on the card, port kernels), {WIDTH}^2, {BOUNCES} "
          f"bounces: kernels {steps[False]}, plain form {steps[True]}")
    for kind, check in (("scatter", mc.scatter_differences),
                        ("tr", mc.transmittance_differences)):
        if len(calls[kind]) != MEDIA_MAIN_CALLS:
            raise AssertionError(f"media main path: {len(calls[kind])} {kind} calls kept")
        for i, (desc, args) in enumerate(calls[kind]):
            _check_media_bits(f"media {kind} main path call {i} ({args[0].x.shape[0]} lanes)",
                              check(desc, *args))

    ro, rd, length, state = lanes
    fields = [t.contiguous() for t in media.lane_fields(ro, rd, length, state)]
    rows = {}
    for name, kernel, plain, kind in (
            ("media_scatter", lambda: media.media_scatter(cell, fields),
             lambda: media.march_plain(cell, state, ro, rd, length), "scatter"),
            ("media_transmittance", lambda: media.media_transmittance(cell, fields),
             lambda: media.calc_transmittance_plain(cell, state, ro, rd, length), "tr")):
        k, p = _time_pair(f"{name} {N_RAYS} lanes, the cell's medium", kernel, plain,
                          plain_runs=2, plain_queued=False)
        rows[name] = row = _row(0.0, k, p, _bound(*mc.call_work(kind, cell, fields)))
        print(f"{name} {N_RAYS} lanes: {row['ms']:.4f} ms device a call, call "
              f"{row['call_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"share {100.0 * row['bound_ms'] / row['ms']:.1f}%, plain {row['plain_ms']:.4f} ms "
              "wall")
    return rows


def run_e1m1(dev):
    """Phase 4; returns (kernel rows, launches of the main path, the scene,
    the main-path indices of K3 and K7)."""
    import torch

    from pim_tpu_torch import native
    from pim_tpu_torch.app import build_e1m1_scene, gate_band, render_frame

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
    lo, hi = gate_band("e1m1_512")
    print(_frame_line(f"e1m1 frame {WIDTH}x{HEIGHT} bounces={BOUNCES} spp/step=1 "
                      f"steps={E1M1_STEPS} (TPU drift band [{lo:.4f}, {hi:.4f}], "
                      "for information only)", fr))
    print(f"e1m1 launches during the frame: {fr.launches}")
    print(f"e1m1 launches during build+frame: {launches}")
    _check_frame(fr, WIDTH * HEIGHT, ("gather_cols",) + E1M1_KERNELS)
    _check_no_syncs("e1m1 frame", scene, "e1m1", WIDTH, 1)

    kernels, main_idx = check_e1m1_kernels(dev, scene)
    kernels.update(check_bsdf(dev, scene))
    kernels.update(check_sky(dev))
    kernels.update(check_rng(dev))
    kernels.update(check_media(dev))
    time_e1m1_build(dev, scene)

    lo, hi = gate_band("e1m1_128")
    gate = render_frame(scene, "e1m1", GATE_RES, GATE_RES, BOUNCES, 1, 16)
    print(_frame_line(f"e1m1 gate frame {GATE_RES}x{GATE_RES} bounces={BOUNCES} spp=16 "
                      f"band=[{lo:.6f}, {hi:.6f}] (CPU anchor)", gate))
    _check_frame(gate, GATE_RES * GATE_RES, ())
    if not lo <= gate.mean <= hi:
        raise AssertionError(f"e1m1 {GATE_RES}^2 mean {gate.mean} outside the e1m1_128 band "
                             f"[{lo}, {hi}]")
    check_small_frame("e1m1", scene, _scene_to(scene, "cpu"))
    return kernels, launches, scene, main_idx


def run_training(dev, cornell_cpu, e1m1_scene, main_idx):
    """Phase 5, the differentiable path; returns (kernel rows, launches of
    its two main paths)."""
    kernels = check_train_kernels(dev, e1m1_scene, main_idx)
    e1m1_launches = run_e1m1_training(dev, e1m1_scene)
    cornell_card = _scene_to(cornell_cpu, dev)
    cornell_launches = run_cornell_inverse(dev, cornell_card)
    check_card_vs_cpu_grads("cornell", cornell_card, cornell_cpu)
    check_card_vs_cpu_grads("e1m1", e1m1_scene, _scene_to(e1m1_scene, "cpu"))
    check_ad_vs_fd("cornell", cornell_card)
    check_ad_vs_fd("e1m1", e1m1_scene)
    return kernels, {"e1m1_train": e1m1_launches, "cornell_train": cornell_launches}


def _check_scatter(label: str, kernel, bwd_plain, g, idx, t, library):
    """A backward kernel against its plain version accumulated in float64,
    within the atomics' bound gamma(adds - 1) * sum |g|
    (`fetch_check.scatter_error`); timed against its float32 plain version
    and one `index_add_` call (`library`, a fn()).  Returns (max abs error,
    kernel, plain, library)."""
    import torch

    from pim_tpu_torch.tools.fetch_check import scatter_error

    out_k = kernel(g, idx, t)
    torch.cuda.synchronize()
    ok, err, ratio = scatter_error(out_k, bwd_plain, g, idx, t)
    print(f"{label}: g {tuple(g.shape)} -> {tuple(out_k.shape)}: max_abs_err="
          f"{err:.3e} within gamma(adds-1)*sum|g|={ok} (largest err/bound {ratio:.3e})")
    if not ok:
        raise AssertionError(f"{label} leaves its float64 plain version's bound")
    k, p = _time_pair(f"{label} time", lambda: kernel(g, idx, t),
                      lambda: bwd_plain(g, idx, t))
    lib = _timing(library)
    print(f"{label} library index_add_: {_fmt(lib)}")
    return err, k, p, lib


def _scatter_bound(g, idx, t) -> dict:
    """The bound of a scatter-add call: g and the indices read, the [F, t]
    sum written; one operation for each nonzero add into range."""
    import torch

    ok = (idx >= 0) & (idx < t)
    adds = int(((g.reshape(g.shape[0], -1) != 0) & ok.reshape(1, -1)).sum())
    return _bound(g.numel() * 4 + idx.numel() * idx.element_size() + g.shape[0] * t * 4, adds)


def check_main_path_scatters(dev, scene) -> dict:
    """K3-bwd and K7-bwd on the calls one e1m1 WIDTH^2, TRAIN_BOUNCES-bounce
    training step hands them (`fetch_check.training_step_calls`): each
    within the atomics' bound of a float64 plain sum, timed beside its
    plain version and one `index_add_`; each K3-bwd call's lanes at column
    0 and with a zero gradient printed.  Returns {kernel: [the calls' rows]}."""
    import torch

    from pim_tpu_torch.app import SKY_STEPS
    from pim_tpu_torch.render import gather_kernel as gk
    from pim_tpu_torch.render import table_gather as tg
    from pim_tpu_torch.tools import fetch_check as fc

    calls = fc.training_step_calls(scene, WIDTH, HEIGHT, TRAIN_BOUNCES, SKY_STEPS, TRAIN_SEED)
    torch.cuda.synchronize()
    print(f"main-path scatters: one e1m1 {WIDTH}^2, {TRAIN_BOUNCES}-bounce training step hands "
          f"K3-bwd {len(calls['k3_bwd'])} calls and K7-bwd {len(calls['k7_bwd'])}")
    rows = {"gather_cols_bwd": [], "gather_texels_bwd": []}
    for name, key, kernel, plain, library in (
            ("gather_cols_bwd", "k3_bwd", gk.gather_cols_bwd, gk.gather_cols_bwd_plain,
             fc.index_add_call),
            ("gather_texels_bwd", "k7_bwd", tg.gather_texels_bwd, tg.gather_texels_bwd_plain,
             fc.texel_index_add_call)):
        for i, (g, idx, t) in enumerate(calls[key]):
            kind = "K3-bwd" if key == "k3_bwd" else "K7-bwd"
            label = f"{kind} {name}[main path {i}] {g.shape[0]}x{t}"
            if key == "k3_bwd":
                counts = fc.lane_counts(g, idx)
                print(f"{label}: {counts['lanes']} lanes, {counts['idx0']} at column 0, "
                      f"{counts['g0']} with a zero gradient ({counts['idx0_g0']} both)")
                bound = _scatter_bound(g, idx, t)
            else:
                counts = {}
                bound = _scatter_bound(g, idx.clamp(0, t - 1), t)  # K7-bwd clips, adds all
            err, k, p, lib = _check_scatter(label, kernel, plain, g, idx, t,
                                            library(g, idx, t))
            rows[name].append(dict(shape=list(g.shape), t=t, **counts,
                                   **_row(err, k, p, bound, lib)))
    return rows


def check_k7(label: str, planes, idx, time_it: bool = True):
    """K7 against its plain version on (planes, idx), bitwise; with
    `time_it` also timed beside its plain version and `torch.index_select`
    on the clipped indices.  Returns (kernel, plain, bound, library) or
    None."""
    import torch

    from pim_tpu_torch.render import table_gather as tg

    c, t = planes.shape
    k, n = idx.shape
    out_k = tg.gather_texels(planes, idx, parts=1)
    out_p = tg.gather_texels_plain(planes, idx)
    torch.cuda.synchronize()
    same = _bits_equal(out_k, out_p)
    print(f"K7 gather_texels[{label}] planes {tuple(planes.shape)} x [{k}, {n}]: "
          f"bitwise_equal={same}")
    if not same:
        raise AssertionError(f"K7 differs from its plain version on the {label}")
    if not time_it:
        return None
    k_p = _time_pair(f"K7 time[{label}]", lambda: tg.gather_texels(planes, idx),
                     lambda: tg.gather_texels_plain(planes, idx), batches=DEVICE_BATCHES,
                     cold=True)
    idx_in = idx.clamp(0, t - 1).to(torch.int64).reshape(-1)
    lib = _timing(lambda: torch.index_select(planes, 1, idx_in), batches=DEVICE_BATCHES,
                  cold=True)
    # indices read, the texels they reach, the [C, K, N] output written
    bound = _bound(k * n * 4 + _touched_bytes(idx_in, c * 4) + c * k * n * 4, 0.0)
    print(f"K7 library index_select[{label}]: {_fmt(lib)}; bound {bound['bound_ms']:.4f} ms")
    return (*k_p, bound, lib)


def check_train_kernels(dev, scene, main_idx):
    """K7 forward (bitwise; on random and on the main path's indices) and
    the K3 and K7 backward kernels (within the atomics' bound of a float64
    plain sum) at the training path's shapes."""
    import numpy as np
    import torch

    from pim_tpu_torch.render import fetch as F
    from pim_tpu_torch.render import gather_kernel as gk
    from pim_tpu_torch.render import table_gather as tg
    from pim_tpu_torch.tools import fetch_check as fc

    meta, arrays, _ = scene
    rs = np.random.default_rng(55)
    results = {}

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    k7 = {}
    sky_planes = arrays.sky.reshape(-1, 3).T.contiguous()
    for label, planes, k in (("atlas", arrays.atlas_planes, 12), ("sky", sky_planes, 4)):
        c, t = planes.shape
        idx = rs.integers(0, t, (k, N_RAYS)).astype(np.int32)
        idx[0, :2] = [-1, t]
        idx = cuda(idx)
        k7[label] = check_k7(label, planes, idx)
        k7[f"main_{label}"] = check_k7(f"{label} main-path", planes, main_idx[label])
        # 3 x (N_RAYS - 1) queries: the scalar path, from an aligned and a
        # misaligned pointer
        check_k7(f"{label} 3x(N-1)", planes, idx[:3, :-1].contiguous(), False)
        check_k7(f"{label} 3x(N-1) misaligned", planes,
                 idx.reshape(-1)[1 : 1 + 3 * (N_RAYS - 1)].view(3, N_RAYS - 1), False)

        g = cuda(rs.standard_normal((c, k, N_RAYS)).astype(np.float32))
        err, kb, pb, libb = _check_scatter(
            f"K7-bwd gather_texels_bwd[{label}]", tg.gather_texels_bwd,
            tg.gather_texels_bwd_plain, g, idx, t, fc.texel_index_add_call(g, idx, t))
        if label == "atlas":
            results["gather_texels_bwd"] = _row(
                err, kb, pb, _bound(c * k * N_RAYS * 4 + k * N_RAYS * 4 + c * t * 4,
                                    c * k * N_RAYS), libb)
    row = _row(0.0, *k7["atlas"])
    for key in ("sky", "main_atlas", "main_sky"):
        row.update({f"{key}_{name}": v for name, v in _row(0.0, *k7[key]).items()
                    if name != "max_abs_err"})
    results["gather_texels"] = row

    k3b = {}
    tt = arrays.tri_table
    mat_ids = tt[F.MAT_ID].to(torch.int64)
    for label, f, t, idx in (
            ("tri_table", tt.shape[0], tt.shape[1],
             cuda(np.concatenate([[-1, tt.shape[1]],
                                  rs.integers(-1, tt.shape[1] + 1, N_RAYS - 2)]).astype(np.int32))),
            ("mat_albedo graft", 4, meta.mat_count, mat_ids)):
        n = idx.shape[0]
        g = cuda(rs.standard_normal((f, n)).astype(np.float32))
        err, kb, pb, libb = _check_scatter(
            f"K3-bwd gather_cols_bwd[{label}] {f}x{t}", gk.gather_cols_bwd,
            gk.gather_cols_bwd_plain, g, idx, t, fc.index_add_call(g, idx, t))
        k3b[label] = _row(err, kb, pb, _scatter_bound(g, idx, t), libb)
    row = k3b["tri_table"]
    row["max_abs_err"] = max(row["max_abs_err"], k3b["mat_albedo graft"]["max_abs_err"])
    row.update({f"graft_{key}": v for key, v in k3b["mat_albedo graft"].items()
                if key != "max_abs_err"})
    results["gather_cols_bwd"] = row

    for name, calls in check_main_path_scatters(dev, scene).items():
        row = results[name]
        row["max_abs_err"] = max([row["max_abs_err"]] + [c["max_abs_err"] for c in calls])
        row["main_calls"] = calls
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            row[f"main_{key}_sum"] = sum(c[key] for c in calls)
        slowest = max(calls, key=lambda c: c["ms"])
        row.update(main_ms_max=slowest["ms"], main_ms_max_library_ms=slowest["library_ms"],
                   main_ms_max_bound_ms=slowest["bound_ms"])
    return results


def _train_setup(name: str, scene, res: int):
    """(camera, the scene's parameters) of a scene's bench camera at res^2."""
    from pim_tpu_torch.app import SUN_DIR, SUN_LUM, bench_camera
    from pim_tpu_torch.render import diff

    cam = bench_camera(name, res, res)
    meta, arrays, _ = scene
    return cam, diff.extract_params(meta, arrays, cam, sun_dir=SUN_DIR, sun_lum=(SUN_LUM,) * 3)


def _perturbed(params):
    """Target parameters: every group moved off the scene's."""
    import torch

    dev = params.sun_dir.device
    return params._replace(
        mat_albedo=torch.clamp(params.mat_albedo * 0.8 + 0.1, 0.0, 1.0),
        mat_rome=torch.clamp(params.mat_rome * 0.9 + 0.05, 0.0, 1.0),
        atlas_planes=params.atlas_planes * 0.9,
        sun_dir=params.sun_dir + torch.tensor([0.05, 0.0, -0.05], device=dev),
        sun_lum=params.sun_lum * 1.1,
        cam_eye=params.cam_eye + torch.tensor([0.02, 0.01, -0.02], device=dev))


def run_e1m1_training(dev, scene):
    """The e1m1 training path at full width: TRAIN_STEPS Adam steps, all six
    groups trainable, against a target rendered with perturbed parameters.
    Returns the launches of the path."""
    import torch

    from pim_tpu_torch import native
    from pim_tpu_torch.app import SKY_STEPS
    from pim_tpu_torch.render import diff

    meta, arrays, lights = scene
    cam, params = _train_setup("e1m1", scene, WIDTH)
    render = diff.make_render_fn(meta, WIDTH, HEIGHT, TRAIN_BOUNCES, sky_steps=SKY_STEPS)
    with torch.no_grad():
        target, _ = render(_perturbed(params), arrays, lights, cam, TRAIN_SEED)
    init, step = diff.make_train_step(meta, WIDTH, HEIGHT, TRAIN_BOUNCES, sky_steps=SKY_STEPS)
    opt = init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    native.reset_launches()
    losses, walls = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, params, opt = step(params, opt, arrays, lights, cam, target, TRAIN_SEED)
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
        if i == 0:
            grads = {name: p.grad for name, p in zip(diff.DiffParams._fields, params)}
            for name, g in grads.items():
                if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
                    raise AssertionError(f"e1m1 training: the {name} gradient is not finite "
                                         "and nonzero")
            print("e1m1 train step 0 gradient |g|_1: " + ", ".join(
                f"{name}={float(g.abs().sum()):.6g}" for name, g in grads.items()))
    launches = dict(native.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        raise AssertionError(f"e1m1 training: loss not finite: {losses}")
    ms = statistics.mean(walls[1:]) * 1e3
    print(f"e1m1 training {WIDTH}x{HEIGHT} bounces={TRAIN_BOUNCES} spp=1 mis_both use_rr=False "
          f"sky_steps={SKY_STEPS}, all six groups trainable: losses={losses} "
          f"ms/train_step={ms:.3f} (steps 2-{TRAIN_STEPS}; walls s {[round(w, 4) for w in walls]}) "
          f"max_memory_allocated={peak / 2**30:.3f} GiB")
    print(f"e1m1 training launches: {launches}")
    for name in ("gather_cols", "gather_cols_bwd", "gather_texels", "gather_texels_bwd",
                 "cluster_isect", "cluster_anyhit"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the e1m1 training path")
    return launches


def run_cornell_inverse(dev, scene):
    """tests/test_grad.py::test_inverse_rendering_converges at 512^2: albedo
    x0.5+0.2 clipped, only albedo trainable, lr 5e-2, INVERSE_STEPS steps;
    the last loss must be below 0.2x the first.  Returns its launches."""
    import torch

    from pim_tpu_torch import native
    from pim_tpu_torch.render import diff

    meta, arrays, lights = scene
    cam, params = _train_setup("cornell", scene, WIDTH)
    with torch.no_grad():
        target, _ = diff.make_render_fn(meta, WIDTH, HEIGHT, TRAIN_BOUNCES)(
            params, arrays, lights, cam, TRAIN_SEED)
    p = params._replace(mat_albedo=torch.clamp(params.mat_albedo * 0.5 + 0.2, 0.0, 1.0))
    only_albedo = diff.DiffParams(mat_albedo=True, mat_rome=False, atlas_planes=False,
                                  sun_dir=False, sun_lum=False, cam_eye=False)
    init, step = diff.make_train_step(meta, WIDTH, HEIGHT, TRAIN_BOUNCES, learning_rate=5e-2,
                                      trainable=only_albedo)
    opt = init(p)
    native.reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(INVERSE_STEPS):
        loss, p, opt = step(p, opt, arrays, lights, cam, target, TRAIN_SEED)
        losses.append(float(loss))
    seconds = time.perf_counter() - t0
    launches = dict(native.launches)
    print(f"cornell inverse rendering {WIDTH}x{HEIGHT} bounces={TRAIN_BOUNCES}: first loss "
          f"{losses[0]:.6e}, last {losses[-1]:.6e} (ratio {losses[-1] / losses[0]:.4f}), "
          f"{seconds / INVERSE_STEPS * 1e3:.3f} ms/step; launches {launches}")
    if not losses[-1] < 0.2 * losses[0]:
        raise AssertionError(f"cornell inverse rendering did not converge: {losses}")
    for name in ("dense_isect", "dense_anyhit", "gather_cols", "gather_cols_bwd"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the cornell training path")
    return launches


def _albedo_texels(arrays):
    """[4, H*W] direction: 1 on the rgb of the texels of the textures used
    only as albedo textures (their gradient is smooth: they move colours,
    not directions)."""
    import numpy as np
    import torch

    from pim_tpu_torch.render import fetch as F

    tt = arrays.tri_table.detach().cpu().numpy()
    rec = arrays.tex_rec_t.cpu().numpy()
    atlas_w = int(rec[4, 0])
    used = {row: set(tt[row][tt[row] >= 0].astype(int))
            for row in (F.ALBEDO_TEX, F.ROME_TEX, F.NORMAL_TEX)}
    v = np.zeros(tuple(arrays.atlas_planes.shape), np.float32)
    for tex in used[F.ALBEDO_TEX] - used[F.ROME_TEX] - used[F.NORMAL_TEX]:
        x0, y0, w, h = rec[:4, tex].astype(int)
        for y in range(y0, y0 + h):
            v[:3, y * atlas_w + x0 : y * atlas_w + x0 + w] = 1.0
    return torch.from_numpy(v)


def _direction(group: str, params, arrays):
    """(group index, direction tensor) of a named test direction."""
    import torch

    if group in ("albedo", "roughness", "emission"):
        d = torch.zeros_like(params.mat_albedo)
        if group == "albedo":
            d[:, :3] = 1.0
        else:
            d[:, 0 if group == "roughness" else 3] = 1.0
        return (0 if group == "albedo" else 1), d
    if group == "atlas":
        return 2, _albedo_texels(arrays).to(params.atlas_planes.device)
    vec = {"sun_dir": (3, [1.0, 0.0, -0.5]), "sun_lum": (4, [1.0, 1.0, 1.0]),
           "camera": (5, [1.0, 0.5, -0.25])}[group]
    return vec[0], torch.tensor(vec[1], device=params.cam_eye.device)


def _directional(name, scene, res, sky_steps, groups, params=None):
    """{group: d loss / d params along the group's direction} of a scene's
    res^2, TRAIN_BOUNCES render against a zero target, by autograd."""
    import torch

    from pim_tpu_torch.render import diff

    meta, arrays, lights = scene
    cam, base = _train_setup(name, scene, res)
    p = diff.DiffParams(*(x.detach().clone().requires_grad_(True)
                          for x in (base if params is None else params)))
    loss_fn = diff.make_loss_fn(meta, res, res, TRAIN_BOUNCES, sky_steps=sky_steps)
    target = torch.zeros((res * res, 3), device=arrays.tri_table.device)
    loss_fn(p, arrays, lights, cam, target, TRAIN_SEED)[0].backward()
    out = {}
    for group in groups:
        gi, v = _direction(group, p, arrays)
        g = p[gi].grad
        out[group] = 0.0 if g is None else float((g.double() * v.double()).sum())
    return out


GROUPS = {"cornell": ("albedo", "roughness", "emission", "camera"),
          "e1m1": ("albedo", "roughness", "atlas", "sun_dir", "sun_lum", "camera")}


def check_card_vs_cpu_grads(name: str, card_scene, cpu_scene) -> None:
    """Per-group directional derivatives of the same GRAD_RES^2 render on
    the card and on the CPU (plain versions), within GRAD_RTOL."""
    t0 = time.perf_counter()
    card = _directional(name, card_scene, GRAD_RES, GRAD_SKY_STEPS, GROUPS[name])
    cpu = _directional(name, cpu_scene, GRAD_RES, GRAD_SKY_STEPS, GROUPS[name])
    bad = []
    for group in GROUPS[name]:
        a, b = card[group], cpu[group]
        ok = abs(a - b) <= GRAD_RTOL * abs(b) and b != 0.0
        print(f"{name} gradient card vs cpu {GRAD_RES}^2 [{group}]: card {a:+.6e} cpu {b:+.6e} "
              f"rel {abs(a - b) / max(abs(b), 1e-30):.3e} ok={ok}")
        if not ok:
            bad.append(group)
    print(f"{name} card-vs-cpu gradients: {time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError(f"{name}: card and CPU gradients disagree in {bad}")


FD_CHECKS = {"cornell": (("albedo", None, 2e-2), ("camera", None, 5e-2), ("emission", None, 2e-2)),
             "e1m1": (("sun_dir", 2e-3, 5e-2), ("atlas", None, 5e-2))}


def check_ad_vs_fd(name: str, scene) -> None:
    """tests/test_grad.py's ladder on the card at FD_RES^2: autograd's
    directional derivative against central differences of the same
    estimator; a group passes if any rung agrees within its rtol."""
    import torch

    from pim_tpu_torch.app import SKY_STEPS
    from pim_tpu_torch.render import diff

    meta, arrays, lights = scene
    cam, base = _train_setup(name, scene, FD_RES)
    loss_fn = diff.make_loss_fn(meta, FD_RES, FD_RES, TRAIN_BOUNCES, sky_steps=SKY_STEPS)
    target = torch.zeros((FD_RES * FD_RES, 3), device=arrays.tri_table.device)
    groups = [g for g, _, _ in FD_CHECKS[name]]
    ad = _directional(name, scene, FD_RES, SKY_STEPS, groups)
    for group, eps, rtol in FD_CHECKS[name]:
        gi, v = _direction(group, base, arrays)
        sweep = []
        with torch.no_grad():
            for e in ((eps,) if eps is not None else FD_LADDER):
                def at(sign):
                    p = list(base)
                    p[gi] = p[gi] + sign * e * v
                    return float(loss_fn(diff.DiffParams(*p), arrays, lights, cam, target,
                                         TRAIN_SEED)[0])

                fd = (at(1.0) - at(-1.0)) / (2.0 * e)
                sweep.append((e, fd))
                if abs(fd - ad[group]) <= rtol * abs(ad[group]) + 1e-6:
                    break
            else:
                raise AssertionError(f"{name} [{group}] AD {ad[group]:+.6g} matched no FD rung: "
                                     f"{sweep}")
        print(f"{name} AD vs FD {FD_RES}^2 [{group}]: AD {ad[group]:+.6e} FD {sweep[-1][1]:+.6e} "
              f"at eps {sweep[-1][0]:g} (rtol {rtol}; rungs tried {len(sweep)})")
        if abs(ad[group]) <= 1e-8:
            raise AssertionError(f"{name} [{group}]: the gradient is zero")


SHELL_RES = 512          # the Cornell shell's pt_test and media frames
SHELL_FRAMES = 64        # pt_test -frames
MEDIA_FRAMES = 16        # the Cornell media frame's samples
E1M1_SHELL_RES = 128     # scripts/pt_test_e1m1.cmd's documented size
MEDIA_RES = 32           # the dense-medium card-vs-CPU frames
MEDIA_BOUNCES = 3
DENSE_MEDIUM = dict(constant_mfp=15.0, noise_mfp=1e9, absorption=0.2)  # tests/test_media.py:167
CKPT_RES = 512
SHELL_KERNELS = {"cornell_shell": CORNELL_KERNELS,
                 "cornell_media_shell": CORNELL_KERNELS + MEDIA_KERNELS,
                 "e1m1_shell": ("gather_cols",) + E1M1_KERNELS}


def _run_engine(label: str, res: int, script: str, smi: str):
    """`script` through the port's engine shell in process, on the card, one
    device sync a frame to time it; returns (engine, launches).  Fails when
    a deferred command failed."""
    import statistics as st

    from pim_tpu_torch import native
    from pim_tpu_torch.app import Engine
    from pim_tpu_torch.core.console import get_console

    get_console().clear()
    eng = Engine(width=res, height=res, device="cuda", sync_frames=True)
    eng.init()
    native.reset_launches()
    t0 = time.perf_counter()
    rc = eng.run(script)
    launches = dict(native.launches)
    wall = time.perf_counter() - t0
    gate = [m for _, tag, m in get_console().lines() if m.startswith("pt_gate")]
    ms = eng.frame_ms[1:] or eng.frame_ms
    print(f"{label}: {eng.frame} frames, {eng.render.sample_count} samples, {wall:.1f} s; "
          f"ms/frame median {st.median(ms):.3f} (min {min(ms):.3f}, max {max(ms):.3f}, "
          f"frames after the first) [{smi}]")
    print(f"{label} launches: {launches}")
    if gate:
        print(f"{label} {gate[-1]}")
    if rc != 0:
        raise AssertionError(f"{label}: the shell run failed (exit code {rc}); see its log")
    return eng, launches


def _new_pngs(before: set) -> list:
    from pim_tpu_torch.render.screenshot import read_png

    pngs = sorted(set(os.listdir("screenshots")) - before)
    for p in pngs:
        img = read_png(os.path.join("screenshots", p))
        if img.ndim != 3 or img.shape[2] != 3 or not img.any():
            raise AssertionError(f"screenshot {p} does not decode to an RGB image")
    return pngs


def check_media_frame(name: str, card_scene, cpu_scene) -> None:
    """A MEDIA_RES^2, MEDIA_BOUNCES-bounce frame through DENSE_MEDIUM on
    the card against the same frame on the CPU, with check_small_frame's
    limits."""
    import dataclasses

    import numpy as np
    import torch

    from pim_tpu_torch.app import bench_camera
    from pim_tpu_torch.core import rng
    from pim_tpu_torch.render.camera import generate_primary_rays
    from pim_tpu_torch.render.integrator import trace_rays
    from pim_tpu_torch.render.media import make_media_desc

    desc = make_media_desc(**DENSE_MEDIUM)
    cam = bench_camera(name, MEDIA_RES, MEDIA_RES)
    t0 = time.perf_counter()
    out = []
    for meta, arrays, lights in (card_scene, cpu_scene):
        meta = dataclasses.replace(meta, media_enabled=True)
        dev = arrays.tri_table.device
        state = rng.make_state(torch.arange(MEDIA_RES * MEDIA_RES, device=dev), 0)
        state, ro, rd = generate_primary_rays(cam, MEDIA_RES, MEDIA_RES, state)
        res = trace_rays(meta, arrays, lights, ro, rd, state, MEDIA_BOUNCES, media_desc=desc)
        out.append(res.color.cpu().numpy())
    gpu, cpu = out
    close = np.all(np.isclose(gpu, cpu, rtol=1e-4, atol=1e-5), axis=-1).mean()
    rel = abs(gpu.mean() - cpu.mean()) / cpu.mean()
    print(f"{name} dense-medium frame {MEDIA_RES}^2 card vs cpu: pixels_close={close:.4f} "
          f"mean={gpu.mean():.6f} mean_rel_diff={rel:.6f} ({time.perf_counter() - t0:.1f} s)")
    if not np.isfinite(gpu).all() or close < 0.97 or rel > 0.02:
        raise AssertionError(f"the card's dense-medium {name} frame disagrees with the CPU's")


def check_checkpoint(smi: str) -> None:
    """ckpt_save after 2 Cornell frames, ckpt_load into a fresh render
    system, 2 more frames: bit for bit the 4 frames of an uninterrupted run."""
    import numpy as np
    import torch

    from pim_tpu_torch.core import cvars as cv
    from pim_tpu_torch.core.cmd import CmdStat, get_cmd_system
    from pim_tpu_torch.render.render_system import RenderSystem

    cv.cv_pt_trace.set(True)
    cv.cv_exp_manual.set(True)
    q = get_cmd_system()
    q.reset()

    def fresh():
        rs = RenderSystem(width=CKPT_RES, height=CKPT_RES, device="cuda")
        rs.init()
        return rs

    t0 = time.perf_counter()
    rs = fresh()
    assert q.immediate("cornell_box; teleport -4 0 4; lookat 0 -1 0") == CmdStat.OK
    for _ in range(2):
        rs.update()
    if q.immediate("ckpt_save smoke") != CmdStat.OK:
        raise AssertionError("ckpt_save failed")
    for _ in range(2):
        rs.update()
    want = (rs.buffers.color.clone(), rs.lights.live.clone(), rs.dof.focal_length)
    rs2 = fresh()
    if q.immediate("ckpt_load smoke") != CmdStat.OK:
        raise AssertionError("ckpt_load failed")
    for _ in range(2):
        rs2.update()
    torch.cuda.synchronize()
    same = (torch.equal(rs2.buffers.color, want[0]) and torch.equal(rs2.lights.live, want[1])
            and rs2.dof.focal_length == want[2] and rs2.sample_count == rs.sample_count == 4)
    diff = int((rs2.buffers.color != want[0]).sum())
    print(f"checkpoint on the card: {CKPT_RES}^2 Cornell, 2 frames + ckpt_save + ckpt_load + "
          f"2 frames vs 4 frames: bit-identical {same} (color diffs {diff}, mean "
          f"{float(np.float64(rs2.buffers.color.mean().item())):.6f}; "
          f"{time.perf_counter() - t0:.1f} s) [{smi}]")
    if not same:
        raise AssertionError("the resumed checkpoint differs from the uninterrupted run")


def run_shell(dev, e1m1_scene, cornell_cpu, smi: str):
    """Phase 6, the engine shell; returns (launches of its paths, the
    autofocus probe's K1 check)."""
    import numpy as np
    import torch

    from pim_tpu_torch.core import cvars as cv
    from pim_tpu_torch.math.vec3 import RCP_EPS, V3
    from pim_tpu_torch.render.camera import Camera, DofInfo, camera_arrays
    from pim_tpu_torch.render.render_system import load_gate_band

    import shutil

    out_dir = os.path.join(ROOT, "build", "shell")
    shutil.rmtree(out_dir, ignore_errors=True)  # this phase's own outputs only
    os.makedirs(os.path.join(out_dir, "screenshots"))
    cwd = os.getcwd()
    os.chdir(out_dir)
    try:
        cv.cv_basedir.set(os.path.join(ROOT, "data"))
        launches = {}
        before = set(os.listdir("screenshots"))
        eng, launches["cornell_shell"] = _run_engine(
            f"cornell shell {SHELL_RES}^2 pt_test -frames {SHELL_FRAMES}", SHELL_RES,
            f"pt_max_bounces {BOUNCES}; pt_media 0; pt_test -frames {SHELL_FRAMES}", smi)
        pngs = _new_pngs(before)
        band = load_gate_band(eng.render.sample_count, "cornell")
        print(f"cornell shell: stddev={eng.render.stddev():.6f} "
              f"mean={float(eng.render.buffers.color.mean()):.6f} band(maxstddev, meanlo, "
              f"meanhi)={band}; screenshots {pngs}")
        if len(pngs) < 2:
            raise AssertionError(f"pt_test wrote {pngs}, not its two screenshots")
        tris12 = eng.render.arrays.tris12

        eng, launches["cornell_media_shell"] = _run_engine(
            f"cornell media shell {SHELL_RES}^2 {MEDIA_FRAMES} frames", SHELL_RES,
            "cornell_box; teleport -4 0 4; lookat 0 -1 0; pt_denoise 0; exp_manual 1; "
            f"exp_evoffset 5; pt_media 1; pt_trace 1; wait {MEDIA_FRAMES}; pt_stddev; pt_gate; "
            "pt_trace 0; pt_media 0; quit", smi)
        if not eng.render.meta.media_enabled:
            raise AssertionError("the media shell's scene was built without media")
        print(f"cornell media shell: stddev={eng.render.stddev():.6f} "
              f"mean={float(eng.render.buffers.color.mean()):.6f} band="
              f"{load_gate_band(eng.render.sample_count, 'cornell')}")

        before = set(os.listdir("screenshots"))
        script = os.path.join(ROOT, "scripts", "pt_test_e1m1.cmd")
        cv.cv_pt_media.set(False)
        cv.cv_exp_evoffset.set(0.0)  # the script's own settings, as in a fresh process
        eng, launches["e1m1_shell"] = _run_engine(
            f"e1m1 shell {E1M1_SHELL_RES}^2 exec scripts/pt_test_e1m1.cmd", E1M1_SHELL_RES,
            f'pt_max_bounces {BOUNCES}; exec "{script}"', smi)
        print(f"e1m1 shell: stddev={eng.render.stddev():.6f} "
              f"mean={float(eng.render.buffers.color.mean()):.6f} band="
              f"{load_gate_band(eng.render.sample_count, 'e1m1')} backend "
              f"{eng.render.meta.backend}; screenshots {_new_pngs(before)}")
        for path, counts in launches.items():
            for name in SHELL_KERNELS[path]:
                if counts[name] <= 0:
                    raise AssertionError(f"kernel {name} was not launched on the {path} path")

        check_media_frame("cornell", _scene_to(cornell_cpu, dev), cornell_cpu)
        check_media_frame("e1m1", e1m1_scene, _scene_to(e1m1_scene, "cpu"))
        check_checkpoint(smi)

        # the autofocus probe: one ray down the pt_test camera's view
        cam = Camera(position=np.asarray([-4.0, 0.0, 4.0], np.float32))
        cam.look_at([0.0, -1.0, 0.0])
        ca = camera_arrays(cam, DofInfo(), SHELL_RES, SHELL_RES)

        def one(v):
            return torch.full((1,), float(v), dtype=torch.float32, device=dev)

        probe = _check_k1("autofocus probe, one ray", tris12, V3(*(one(v) for v in ca.eye)),
                          V3(*(one(v) for v in ca.fwd)), 0.0, RCP_EPS)
    finally:
        os.chdir(cwd)
    return launches, probe


BAKE_MAP = "e1m1"
BAKE_RES = 64             # the shell's frame while it bakes (the bakes are what is checked)
E1M1_BAKE_FRAMES = 3      # lm_gen frames of the e1m1 atlas (1024^2, every texel traced)
CORNELL_BAKE_PASSES = 64  # lm_gen passes gated by pim_tpu_torch/render/bake_bands.json
BAKE_CHECK_BOUNCES = 3    # the card-vs-CPU bakes
SHARD_LIVE = 1024         # live e1m1 texels of the card-vs-CPU shard
REFL_CHECK_RES = 16       # the card-vs-CPU reflection probe
PROBE_RAYS = 1024         # probe_bake -samples
RESUME_FRAMES = 2         # frames before and after the bake checkpoint
TOOL_FRAMES = 4           # frames of pim_tpu_torch/tools/bake_e1m1_lightmap.py
PROBE_AT = (0.0, 1.0, 0.0)  # the Cornell card-vs-CPU probes' origin


def _counted(fn, into: dict, times: list = None):
    """fn wrapped: each call starts with every launch count at 0 and adds
    the counts after it into `into`; with `times`, each call is timed from
    an idle device to its end (ms appended)."""
    import torch

    from pim_tpu_torch import native

    def run(*args, **kwargs):
        if times is not None:
            torch.cuda.synchronize()
        native.reset_launches()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if times is not None:
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        for name, c in native.launches.items():
            into[name] = into.get(name, 0) + c
        return out
    return run


def _bake_rule(label: str, gpu, cpu, elementwise: bool = True) -> None:
    """The small frames' rule on a bake's values: >= 97% within rtol 1e-4 /
    atol 1e-5 (each value, or each ray's rgb with elementwise=False), the
    means within 2%."""
    import numpy as np

    gpu = gpu.detach().cpu().numpy() if hasattr(gpu, "detach") else np.asarray(gpu)
    cpu = cpu.detach().cpu().numpy() if hasattr(cpu, "detach") else np.asarray(cpu)
    close = np.isclose(gpu, cpu, rtol=1e-4, atol=1e-5)
    share = close.mean() if elementwise else np.all(close, axis=-1).mean()
    rel = abs(gpu.mean() - cpu.mean()) / max(abs(cpu.mean()), 1e-30)
    print(f"{label} card vs cpu: {gpu.size} values, close={share:.4f} mean={gpu.mean():.6f} "
          f"mean_rel_diff={rel:.6f}")
    if not np.isfinite(gpu).all() or share < 0.97 or rel > 0.02:
        raise AssertionError(f"{label}: the card's bake disagrees with the CPU's")


def _bake_call_against_plain(cl, args, anyhit: bool, lanes: int):
    """K4 (K5 with `anyhit`) through its wrapper on the whole of a bake's
    ray call (ro, rd, t_near, t_far): (the live lanes (t_far > 0); the
    lanes compared: at most `lanes` live ones, evenly spaced over the call
    so that they cover the whole atlas; whether the wrapper's outputs there
    equal the plain version's on those lanes bit for bit; their largest
    difference there; whether every dead lane reports a miss: t = -1 and
    tri = -1 from K4, 0 from K5)."""
    import torch

    from pim_tpu_torch.math.vec3 import V3
    from pim_tpu_torch.render import cluster as CL
    from pim_tpu_torch.tools import cluster_check as cc

    ro, rd, t_near, t_far = args
    tf = CL._per_ray_t_far(t_far, ro.x.shape[0], ro.x.device)
    wrap, plain = ((CL.cluster_anyhit, CL.cluster_anyhit_plain) if anyhit
                   else (CL.cluster_isect, CL.cluster_isect_plain))
    got = cc.outs(wrap(cl, ro, rd, t_near, t_far))
    live = tf > 0.0
    idx = torch.nonzero(live).flatten()
    idx = idx[:: max(1, -(-idx.numel() // lanes))]
    want = cc.outs(plain(cl, V3(*(c[idx] for c in ro)), V3(*(c[idx] for c in rd)), t_near,
                         tf[idx]))
    head = tuple(a[idx] for a in got)
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(head, want))
    miss = (0,) if anyhit else (-1.0, -1)
    dead_miss = all(bool((a[~live] == m).all()) for a, m in zip(got, miss))
    return int(live.sum()), idx.numel(), cc.same_bits(head, want), err, dead_miss


def _bake_shell(dev, script: str):
    """A fresh render system on `dev` at BAKE_RES^2 with `script` run."""
    from pim_tpu_torch.core.cmd import CmdStat, get_cmd_system
    from pim_tpu_torch.render import cubemap
    from pim_tpu_torch.render.render_system import RenderSystem

    cubemap._registry = None  # the probe registry is a module global
    rs = RenderSystem(width=BAKE_RES, height=BAKE_RES, device=dev)
    rs.init()
    q = get_cmd_system()
    q.reset()
    if q.immediate(script) != CmdStat.OK:
        raise AssertionError(f"the shell refused {script!r}")
    return rs


def _set_bake_cvars(lm_gen: bool, refl: bool) -> None:
    from pim_tpu_torch.core import cvars as cv

    for c, v in ((cv.cv_pt_max_bounces, BOUNCES), (cv.cv_pt_trace, True), (cv.cv_pt_media, False),
                 (cv.cv_pt_backend, "auto"),
                 (cv.cv_exp_manual, True), (cv.cv_lm_density, 4.0), (cv.cv_lm_timeslice, 1),
                 (cv.cv_lm_spp, 1), (cv.cv_lm_gen, lm_gen), (cv.cv_r_refl_gen, refl)):
        c.set(v)


def _probe_cmd(rs, label: str, launches: dict) -> None:
    """probe_bake -samples PROBE_RAYS at the camera and probe_report, the
    launches of the bake counted as the path `label`."""
    import torch

    from pim_tpu_torch.core.cmd import CmdStat, get_cmd_system
    from pim_tpu_torch.core.console import get_console

    q = get_cmd_system()
    counts = {}
    status = _counted(q.immediate, counts)(f"probe_bake -samples {PROBE_RAYS}")
    if status != CmdStat.OK or q.immediate("probe_report") != CmdStat.OK:
        raise AssertionError(f"{label}: probe_bake or probe_report failed")
    launches[label] = counts
    p = rs.probes["camera"]
    report = [m for _, tag, m in get_console().lines() if tag == "probe"][-6:]
    print(f"{label}: probe_bake -samples {PROBE_RAYS}, pass {int(p.sample_count)}; "
          f"probe_report {report[0]} ... {report[-1]}; launches {counts}")
    if not bool(torch.isfinite(p.faces).all() & torch.isfinite(p.sh).all()):
        raise AssertionError(f"{label}: the probe is not finite")


def run_e1m1_bakes(dev, e1m1_scene, launches: dict, smi: str):
    """`mapload e1m1` and E1M1_BAKE_FRAMES frames of `lm_gen 1` and
    `r_refl_gen 1` through the shell at the release density (the 1024^2
    atlas, every texel traced), then probe_bake; the pack bit for bit
    against data/e1m1/lmpack.npz; K4 and K5 on the bake's own rays; an
    e1m1 shard on the card against the CPU; the compacted bake tool.
    Returns the shell's render system."""
    import numpy as np
    import torch

    from pim_tpu_torch.core.console import get_console
    from pim_tpu_torch.core.crate import Crate
    from pim_tpu_torch.render import lightmap as lm
    from pim_tpu_torch.render.scene import _cluster_arrays
    from pim_tpu_torch.tools import bake_e1m1_lightmap as tool
    from pim_tpu_torch.tools import cluster_check as cc

    _set_bake_cvars(lm_gen=True, refl=True)
    t0 = time.perf_counter()
    rs = _bake_shell(dev, f"mapload {BAKE_MAP}; teleport -2.5 1.7 -2.5; lookat 6 1 6")
    pass_ms, refl_ms, lm_counts, refl_counts = [], [], {}, {}
    rs._lightmap_trace = _counted(rs._lightmap_trace, lm_counts, pass_ms)
    rs._cubemap_trace = _counted(rs._cubemap_trace, refl_counts, refl_ms)
    rs.update()  # the scene build, its sky, the pack and the first pass
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for _ in range(E1M1_BAKE_FRAMES - 1):
        rs.update()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches["e1m1_lightmap"], launches["e1m1_refl"] = lm_counts, refl_counts
    pack = rs.lm_pack
    packed = [m for _, tag, m in get_console().lines() if tag == "lm" and "atlas in" in m]
    want = Crate.load(os.path.join(ROOT, "data", "e1m1", "lmpack.npz")).get("e1m1_lmpack")
    counts = pack.sample_counts.cpu().numpy()
    live = want["sample_counts"] > 0
    same = (np.array_equal(pack.position.cpu().numpy(), want["position"])
            and np.array_equal(pack.normal.cpu().numpy(), want["normal"])
            and np.array_equal(counts > 0, live))
    probes = pack.probes.cpu().numpy()
    irr = lm.lightmap_irradiance(pack, pack.normal.T.contiguous())[torch.from_numpy(live).to(dev)]
    print(f"e1m1 lightmap pack: {packed[-1] if packed else '?'}; {int(live.sum())} live of "
          f"{pack.size * pack.size}; bit for bit data/e1m1/lmpack.npz (position, normal, live "
          f"mask) {same}")
    print(f"e1m1 lm_gen 1 through the shell: {pack.size * pack.size} lanes a pass, {BOUNCES} "
          f"bounces, {E1M1_BAKE_FRAMES} frames (first frame with the build and pack "
          f"{first_s:.1f} s); ms a pass {[round(t, 3) for t in pass_ms]}; peak memory "
          f"{peak / 2**30:.3f} GiB over frames 2-{E1M1_BAKE_FRAMES}; mean irradiance over live "
          f"texels {float(irr.mean()):.6f}; launches {lm_counts}; r_refl_gen (the 64^2 "
          f"default probe, baked and convolved) ms a frame {[round(t, 3) for t in refl_ms]}, "
          f"launches {refl_counts} [{smi}]")
    ok_counts = (counts[live] == 1 + E1M1_BAKE_FRAMES).all() and (counts[~live] == 0).all()
    ok_probes = (np.isfinite(probes).all() and (probes[live][..., :3] >= 0).all()
                 and not probes[~live].any())
    if not (same and ok_counts and ok_probes):
        raise AssertionError(f"e1m1 lightmap: pack equal {same}, counts {ok_counts}, probes "
                             f"{ok_probes}")
    _probe_cmd(rs, "e1m1_light_probe", launches)

    # K4 and K5 on the bake's own rays: one more pass, its calls recorded
    with cc.recorded_calls() as calls:
        lm.bake_step(rs.meta, rs.arrays, rs.lights, pack, E1M1_BAKE_FRAMES, max_bounces=BOUNCES)
    n_tex = pack.size * pack.size
    isect = [c for c in calls["isect"] if c[0].x.shape[0] == n_tex]
    anyhit = [c for c in calls["anyhit"] if c[0].x.shape[0] == n_tex]
    cont = 2 if rs.meta.has_refractive else 1  # a refractive scene probes glass thickness first
    cl = _cluster_arrays(rs.arrays)
    for label, args, hit in (("hemisphere rays", isect[0], False),
                             ("bounce-1 rays", isect[cont], False),
                             ("bounce-1 NEE shadow rays", anyhit[0], True),
                             ("bounce-2 NEE shadow rays", anyhit[1], True)):
        n_live, n_cmp, ok, err, dead_miss = _bake_call_against_plain(cl, args, hit,
                                                                     PLAIN_LANES)
        print(f"{'K5' if hit else 'K4'} on the e1m1 bake's {label}: the wrapper on all "
              f"{n_tex} lanes, {n_live} live; at {n_cmp} live lanes spread over the call "
              f"bitwise equal to plain {ok} (max abs err {err}); all {n_tex - n_live} dead "
              f"lanes a miss {dead_miss}")
        if not (ok and dead_miss):
            raise AssertionError(f"K4/K5 differ from their plain versions on the bake's {label}")
    del calls, isect, anyhit

    # an e1m1 shard on the card against the CPU: SHARD_LIVE live texels
    idx = torch.nonzero(pack.sample_counts > 0).flatten()[:SHARD_LIVE]
    shard = pack._replace(position=pack.position[:, idx].contiguous(),
                          normal=pack.normal[:, idx].contiguous(),
                          probes=torch.zeros_like(pack.probes[idx]),
                          sample_counts=torch.ones_like(pack.sample_counts[idx]))
    scene = (rs.meta, rs.arrays, rs.lights)
    t1 = time.perf_counter()
    card = lm.bake_step(*scene, shard, 0, max_bounces=BAKE_CHECK_BOUNCES)
    cpu_shard = shard._replace(**{f: getattr(shard, f).cpu() for f in
                                  ("position", "normal", "probes", "sample_counts", "axii")})
    cpu = lm.bake_step(*_scene_to(scene, "cpu"), cpu_shard, 0, max_bounces=BAKE_CHECK_BOUNCES)
    _bake_rule(f"e1m1 lightmap shard ({SHARD_LIVE} live texels, {BAKE_CHECK_BOUNCES} bounces, "
               f"{time.perf_counter() - t1:.1f} s)", card.probes, cpu.probes)

    # the compacted bake tool on the same scene and a fresh copy of the pack
    fresh = pack._replace(probes=torch.zeros_like(pack.probes),
                          sample_counts=(pack.sample_counts > 0).to(torch.float32))
    counts_tool = {}
    out = _counted(tool.bake, counts_tool)(
        e1m1_scene, fresh, TOOL_FRAMES, os.path.join(ROOT, "build", "bakes", "e1m1_lightmap"),
        log=lambda m: print(f"bake_e1m1_lightmap: {m}"))
    launches["e1m1_lightmap_compacted"] = counts_tool
    print(f"bake_e1m1_lightmap at {TOOL_FRAMES} frames: {out['mtexel_samples_per_s']:.4f} "
          f"Mtexel-samples/s, {out['run_ms_per_frame']:.3f} ms a frame ({out['n_live']} live "
          f"texels in chunks of {out['chunk']}); resume bit-identical "
          f"{out['resume_bit_identical']}; launches {counts_tool} [{smi}]")
    return rs


def run_cornell_bakes(dev, cornell_cpu, launches: dict, smi: str) -> None:
    """Cornell: the lightmap, a reflection probe and a light probe on the
    card against the CPU; CORNELL_BAKE_PASSES passes of `lm_gen 1` through
    the shell inside bake_bands.json; K1 and K2 on the bake's own rays; a
    checkpoint of lm_gen + r_refl_gen + probe_bake resumed bit for bit."""
    import torch

    from pim_tpu_torch.core import cvars as cv
    from pim_tpu_torch.core.cmd import CmdStat, get_cmd_system
    from pim_tpu_torch.geom.cornell import build_cornell_box
    from pim_tpu_torch.geom.entities import flatten
    from pim_tpu_torch.render import cubemap, probes
    from pim_tpu_torch.render import lightmap as lm
    from pim_tpu_torch.render.integrator import trace_rays
    from pim_tpu_torch.tools import dense_check as dc

    card_scene = _scene_to(cornell_cpu, dev)
    scenes = (("card", card_scene), ("cpu", cornell_cpu))

    # the card against the CPU: the full-width lightmap pass, a 16^2
    # reflection probe baked and convolved, a light probe's rays and fit
    t0 = time.perf_counter()
    flat = flatten(build_cornell_box("boxes")[0])
    out = {}
    for name, scene in scenes:
        pack = lm.pack_lightmaps(flat.positions, flat.normals, 4.0,
                                 device=scene[1].tri_table.device)
        out[name] = lm.bake_step(*scene, pack, 0, max_bounces=BAKE_CHECK_BOUNCES)
    live = out["cpu"].sample_counts > 0
    _bake_rule(f"cornell lightmap ({out['cpu'].size}^2 atlas, {int(live.sum())} live texels, "
               f"{BAKE_CHECK_BOUNCES} bounces)", out["card"].probes.cpu()[live],
               out["cpu"].probes[live])
    for name, scene in scenes:
        dev_s = scene[1].tri_table.device
        cm = cubemap.bake_step(*scene, cubemap.cubemap_new(REFL_CHECK_RES, dev_s), PROBE_AT, 0,
                               1.0, BAKE_CHECK_BOUNCES)
        cm = cubemap.convolve(cm, 32, 1.0, 0)
        out[name] = torch.cat([cm.color.flatten()] + [m.flatten() for m in cm.mips]).cpu()
    _bake_rule(f"cornell reflection probe {REFL_CHECK_RES}^2 (color and {len(cm.mips)} mips)",
               out["card"], out["cpu"])
    for name, scene in scenes:
        dev_s = scene[1].tri_table.device
        p = probes.probe_new(PROBE_AT, dev_s)
        state, ro, rd = probes.probe_rays(p, PROBE_RAYS)
        radiance = trace_rays(*scene, ro, rd, state, BAKE_CHECK_BOUNCES).color
        p = probes.probe_bake_step(*scene, p, PROBE_RAYS, BAKE_CHECK_BOUNCES)
        out[name] = (radiance.cpu(), torch.cat([p.faces.flatten(), p.sh.flatten()]).cpu())
    _bake_rule(f"cornell light probe, {PROBE_RAYS} rays' radiance", out["card"][0],
               out["cpu"][0], elementwise=False)
    fit_err = float((out["card"][1] - out["cpu"][1]).abs().max())
    fit_max = float(out["cpu"][1].abs().max())
    print(f"cornell light probe fit (cube faces and SH) card vs cpu: max abs diff {fit_err:.6g} "
          f"of max {fit_max:.6g} ({time.perf_counter() - t0:.1f} s for the three checks)")
    if fit_err > 0.02 * fit_max:
        raise AssertionError("the card's light probe fit disagrees with the CPU's")

    # CORNELL_BAKE_PASSES passes of lm_gen 1 through the shell, in the band
    _set_bake_cvars(lm_gen=True, refl=False)
    rs = _bake_shell(dev, "cornell_box; teleport -4 0 4; lookat 0 -1 0")
    pass_ms, lm_counts = [], {}
    rs._lightmap_trace = _counted(rs._lightmap_trace, lm_counts, pass_ms)
    t0 = time.perf_counter()
    for _ in range(CORNELL_BAKE_PASSES):
        rs.update()
    torch.cuda.synchronize()
    launches["cornell_lightmap"] = lm_counts
    pack = rs.lm_pack
    live = pack.sample_counts > 0
    mean = float(lm.lightmap_irradiance(pack, pack.normal.T.contiguous())[live].double().mean())
    with open(os.path.join(ROOT, "pim_tpu_torch", "render", "bake_bands.json")) as f:
        band = json.load(f)["cornell_lightmap"]
    lo, hi = band["mean"] - band["half"], band["mean"] + band["half"]
    ok_counts = bool((pack.sample_counts[live] == 1 + CORNELL_BAKE_PASSES).all())
    print(f"cornell lm_gen 1 through the shell: {pack.size}^2 atlas ({pack.size ** 2} lanes a "
          f"pass, {int(live.sum())} live), {BOUNCES} bounces, {CORNELL_BAKE_PASSES} passes in "
          f"{time.perf_counter() - t0:.1f} s; ms a pass median "
          f"{statistics.median(pass_ms[1:]):.3f} (min {min(pass_ms[1:]):.3f}, max "
          f"{max(pass_ms[1:]):.3f}, passes after the first); mean irradiance over live texels "
          f"{mean:.6f}, band [{lo:.6f}, {hi:.6f}] (bake_bands.json, {band['device']}-derived); "
          f"launches {lm_counts} [{smi}]")
    if not (lo <= mean <= hi and ok_counts):
        raise AssertionError(f"the Cornell lightmap mean {mean} leaves [{lo}, {hi}] "
                             f"(counts {ok_counts})")

    # K1 and K2 on the bake's own rays: one more pass, its calls recorded
    with dc.recorded_calls() as calls:
        lm.bake_step(rs.meta, rs.arrays, rs.lights, pack, CORNELL_BAKE_PASSES,
                     max_bounces=BOUNCES)
    n_tex = pack.size * pack.size
    isect = [c for c in calls["isect"] if c[1].x.shape[0] == n_tex]
    anyhit = [c for c in calls["anyhit"] if c[1].x.shape[0] == n_tex]
    _check_k1("the Cornell bake's hemisphere rays", *isect[0])
    _check_k1("the Cornell bake's bounce-1 rays", *isect[1])
    _check_k2("the Cornell bake's bounce-1 NEE shadow rays", *anyhit[0])
    _check_k2("the Cornell bake's bounce-2 NEE shadow rays", *anyhit[1])
    del calls, isect, anyhit

    # a checkpoint of the bakes: RESUME_FRAMES frames of lm_gen 1 and
    # r_refl_gen 1 and a probe_bake, ckpt_save, RESUME_FRAMES more, against
    # a fresh render system resumed from the crate
    _set_bake_cvars(lm_gen=True, refl=True)
    t0 = time.perf_counter()
    q = get_cmd_system()
    rs = _bake_shell(dev, "cornell_box; teleport -4 0 4; lookat 0 -1 0")
    refl_counts, refl_ms = {}, []
    rs._cubemap_trace = _counted(rs._cubemap_trace, refl_counts, refl_ms)
    for _ in range(RESUME_FRAMES):
        rs.update()
    launches["cornell_refl"] = refl_counts
    _probe_cmd(rs, "cornell_light_probe", launches)
    if q.immediate("ckpt_save bake_smoke") != CmdStat.OK:
        raise AssertionError("ckpt_save failed")
    for _ in range(RESUME_FRAMES):
        rs.update()
    rs2 = _bake_shell(dev, "ckpt_load bake_smoke")
    for _ in range(RESUME_FRAMES):
        rs2.update()
    torch.cuda.synchronize()
    same = {"frame": torch.equal(rs2.buffers.color, rs.buffers.color),
            "lightmap": all(torch.equal(getattr(rs2.lm_pack, f), getattr(rs.lm_pack, f))
                            for f in ("probes", "sample_counts")),
            "light probe": all(torch.equal(getattr(rs2.probes["camera"], f),
                                           getattr(rs.probes["camera"], f))
                               for f in ("faces", "sh", "sample_count")),
            "lm_frame": rs2._lm_frame == rs._lm_frame == 2 * RESUME_FRAMES}
    cm = cubemap.get_registry().find("default")
    print(f"bake checkpoint on the card: Cornell, {RESUME_FRAMES} frames of lm_gen 1 + r_refl_gen "
          f"1 + probe_bake, ckpt_save, ckpt_load into a fresh render system, {RESUME_FRAMES} "
          f"frames vs {2 * RESUME_FRAMES} frames: bit-identical {same} (the {cm.size}^2 "
          f"reflection probe, {cm.mip_count} mips, is not in a crate, as in the reference; "
          f"r_refl_gen over the first run's {2 * RESUME_FRAMES} frames: ms "
          f"{[round(t, 3) for t in refl_ms]}, launches {refl_counts}; "
          f"{time.perf_counter() - t0:.1f} s) [{smi}]")
    if not all(same.values()):
        raise AssertionError(f"the resumed bakes differ from the uninterrupted run: {same}")
    cv.cv_lm_gen.set(False)
    cv.cv_r_refl_gen.set(False)


def run_bakes(dev, e1m1_scene, cornell_cpu, smi: str) -> dict:
    """Phase 7, the bakes; returns the launches of their paths."""
    import shutil

    from pim_tpu_torch.core import cvars as cv

    out_dir = os.path.join(ROOT, "build", "bakes")
    shutil.rmtree(out_dir, ignore_errors=True)  # this phase's own outputs only
    os.makedirs(out_dir)
    cwd = os.getcwd()
    os.chdir(out_dir)
    launches = {}
    try:
        cv.cv_basedir.set(os.path.join(ROOT, "data"))
        t0 = time.perf_counter()
        run_e1m1_bakes(dev, e1m1_scene, launches, smi)
        print(f"e1m1 bakes: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        run_cornell_bakes(dev, cornell_cpu, launches, smi)
        print(f"cornell bakes: {time.perf_counter() - t0:.1f} s")
    finally:
        os.chdir(cwd)
    return launches  # main fails the run if a kernel of a path (PATHS) never launched


# ---------------------------------------------------------------------------
# Phase 8: the scale-out layer (pim_tpu_torch/parallel/)
# ---------------------------------------------------------------------------

PAR_RANKS = 2             # the gloo world's ranks, both on cuda:0
PAR_SAMPLE = 0            # the sharded render's sample id
PAR_TRAIN_STEPS = 2       # SGD steps of the sharded train step
PAR_LR = 0.05             # make_sharded_train_step's default
PAR_BAKE_FRAMES = (0, 1)  # passes of the texel-sharded e1m1 lightmap bake
PAR_UPDATE_RTOL = 1e-4    # a sharded SGD update against the one-rank one (atomics)
PAR_RENDER_RUNS = 3       # timed calls of the sharded and the unsharded render
SPHERES_RES = 128         # the cornell_box spheres shell frame


def _scene_digest(scene) -> dict:
    """sha256 of every tensor of a scene's arrays and lights, by field."""
    import dataclasses
    import hashlib

    _, arrays, lights = scene
    return {f"{type(obj).__name__}.{f.name}": hashlib.sha256(
        getattr(obj, f.name).detach().cpu().contiguous().numpy().tobytes()).hexdigest()
        for obj in (arrays, lights) for f in dataclasses.fields(obj)}


def _par_timed(fn, barrier: bool = True):
    """(fn(), its launches, its wall in s): from an idle device, every rank
    starting together, the launch counts set to 0 just before."""
    import torch
    import torch.distributed as tdist

    from pim_tpu_torch import native

    torch.cuda.synchronize()
    if barrier and tdist.is_initialized():
        tdist.barrier()
    native.reset_launches()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, dict(native.launches), time.perf_counter() - t0


def _sum_counts(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def _par_gloo_rank(out_dir: str) -> None:
    """One rank of phase 8's gloo world: e1m1 built on cuda:0, then the
    sharded render, train step and bake; its outputs to out_dir."""
    import hashlib

    import numpy as np
    import torch

    from pim_tpu_torch.app import SKY_STEPS, bench_camera, build_e1m1_scene
    from pim_tpu_torch.core.crate import Crate
    from pim_tpu_torch.parallel import dist as pdist
    from pim_tpu_torch.parallel.shard import (make_mesh, make_sharded_render_step,
                                              make_sharded_train_step)
    from pim_tpu_torch.render import diff
    from pim_tpu_torch.render import lightmap as lm
    from pim_tpu_torch.tools.scaling_worker import gather_shards, shard_range

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    info = pdist.init_distributed(device=dev)
    rank = info.process_id
    mesh = make_mesh(PAR_RANKS, dev)
    t0 = time.perf_counter()
    scene = build_e1m1_scene(dev)
    torch.cuda.synchronize()
    out = {"rank": rank, "backend": mesh.backend, "build_s": time.perf_counter() - t0,
           "digest": _scene_digest(scene)}
    meta, arrays, lights = scene
    torch.cuda.reset_peak_memory_stats(dev)

    cam = bench_camera("e1m1", WIDTH, HEIGHT)
    step = make_sharded_render_step(meta, mesh, WIDTH, HEIGHT, BOUNCES)
    step(arrays, lights, cam, PAR_SAMPLE + 1)  # warm-up, another sample
    out["launches"] = {}
    (color, albedo, normal, live), out["launches"]["e1m1_sharded_render"], wall = _par_timed(
        lambda: step(arrays, lights, cam, PAR_SAMPLE))
    out["render_s"] = [wall] + [_par_timed(lambda: step(arrays, lights, cam, PAR_SAMPLE))[2]
                                for _ in range(PAR_RENDER_RUNS - 1)]
    out["render"] = [pdist.allgather_rows(x.cpu().numpy()) for x in (color, albedo, normal)]
    out["render_live"] = live.cpu().numpy()

    inp = torch.load(os.path.join(out_dir, "train_in.pt"), weights_only=False)
    params = diff.DiffParams(*(x.to(dev) for x in inp["params"]))
    target = inp["target"].to(dev)
    tstep = make_sharded_train_step(meta, mesh, WIDTH, HEIGHT, TRAIN_BOUNCES, PAR_LR,
                                    sky_steps=SKY_STEPS)
    counts, losses, walls, updates, lt = {}, [], [], [], lights
    for _ in range(PAR_TRAIN_STEPS):
        (loss, params, lt), c, wall = _par_timed(
            lambda p=params, l=lt: tstep(p, arrays, l, inp["cam"], target, TRAIN_SEED))
        counts = _sum_counts(counts, c)
        losses.append(float(loss))
        walls.append(wall)
        updates.append([x.cpu().numpy() for x in params])
    out["launches"]["e1m1_sharded_train"] = counts
    out["train"] = {"losses": losses, "walls": walls, "params": updates}

    pack = lm.lmpack_from_crate_entry(
        Crate.load(os.path.join(ROOT, "data", "e1m1", "lmpack.npz")).get("e1m1_lmpack"), dev)
    off, cnt, per = shard_range(pack.position.shape[1], rank, PAR_RANKS)
    counts, walls = {}, []
    for f in PAR_BAKE_FRAMES:
        pack, c, wall = _par_timed(lambda p=pack, f=f: lm.bake_step(
            meta, arrays, lights, p, f, max_bounces=BOUNCES, texel_offset=off, texel_count=cnt))
        counts = _sum_counts(counts, c)
        walls.append(wall)
    pack = gather_shards(pack, off, cnt, per)
    probes, texel_counts = pack.probes.cpu().numpy(), pack.sample_counts.cpu().numpy()
    out["launches"]["e1m1_sharded_bake"] = counts
    out["bake"] = {"walls": walls, "texels": cnt,
                   "sha256": hashlib.sha256(probes.tobytes() + texel_counts.tobytes()).hexdigest()}
    if rank == 0:
        np.save(os.path.join(out_dir, "bake_probes.npy"), probes)
        np.save(os.path.join(out_dir, "bake_counts.npy"), texel_counts)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    torch.save(out, os.path.join(out_dir, f"gloo_rank{rank}.pt"))


def _par_nccl_rank(out_dir: str, coordinator: str) -> None:
    """The one-rank NCCL world on cuda:0: dryrun_multichip(1) and the sharded
    Cornell 512^2 frame, their all-reduces on NCCL."""
    import contextlib
    import io

    import torch
    import torch.distributed as tdist

    from pim_tpu_torch.app import bench_camera, build_cornell_scene
    from pim_tpu_torch.parallel.dryrun import dryrun_multichip
    from pim_tpu_torch.parallel.shard import make_mesh, make_sharded_render_step

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    tdist.init_process_group("nccl", init_method=f"tcp://{coordinator}", world_size=1, rank=0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, dry_counts, dry_s = _par_timed(lambda: dryrun_multichip(1, dev), barrier=False)
    meta, arrays, lights = build_cornell_scene(dev)
    mesh = make_mesh(1, dev)
    cam = bench_camera("cornell", WIDTH, HEIGHT)
    step = make_sharded_render_step(meta, mesh, WIDTH, HEIGHT, BOUNCES)
    torch.cuda.reset_peak_memory_stats(dev)

    def frame():
        acc = torch.zeros((WIDTH * HEIGHT, 3), dtype=torch.float32, device=dev)
        for s in range(SPP):
            acc = acc + step(arrays, lights, cam, s)[0]
        return acc * (1.0 / SPP)

    img, counts, wall = _par_timed(frame, barrier=False)
    out = {"backend": tdist.get_backend(), "mesh_backend": mesh.backend,
           "dryrun": buf.getvalue(), "dryrun_launches": dry_counts, "dryrun_s": dry_s,
           "render_launches": counts, "render_s": wall,
           "finite": bool(torch.isfinite(img).all()), "mean": float(img.mean()),
           "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    tdist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, "nccl_rank0.pt"))


def _par_reference(dev, e1m1_scene, out_dir: str) -> dict:
    """The main process's one-rank side of phase 8 on its own e1m1 scene:
    the unsharded trace of the sample, the train step's inputs (saved for
    the ranks) and one one-rank SGD step, the whole bake."""
    import torch

    from pim_tpu_torch.core import rng
    from pim_tpu_torch.core.crate import Crate
    from pim_tpu_torch.parallel.shard import make_mesh, make_sharded_train_step
    from pim_tpu_torch.render import diff
    from pim_tpu_torch.render import lightmap as lm
    from pim_tpu_torch.render.camera import generate_primary_rays
    from pim_tpu_torch.render.integrator import trace_rays
    from pim_tpu_torch.app import SKY_STEPS, bench_camera

    meta, arrays, lights = e1m1_scene
    ref = {"digest": _scene_digest(e1m1_scene)}
    cam = bench_camera("e1m1", WIDTH, HEIGHT)

    def trace():
        state = rng.make_state(torch.arange(N_RAYS, device=dev), PAR_SAMPLE)
        state, ro, rd = generate_primary_rays(cam, WIDTH, HEIGHT, state)
        return trace_rays(meta, arrays, lights, ro, rd, state, BOUNCES)

    res, _, wall = _par_timed(trace)
    ref["render_s"] = [wall] + [_par_timed(trace)[2] for _ in range(PAR_RENDER_RUNS - 1)]
    ref["render"] = [x.cpu().numpy() for x in (res.color, res.albedo, res.normal)]
    ref["render_live"] = (res.live & rng.MASK32).cpu().numpy()

    tcam, params = _train_setup("e1m1", e1m1_scene, WIDTH)
    with torch.no_grad():
        target, _ = diff.make_render_fn(meta, WIDTH, HEIGHT, TRAIN_BOUNCES, SKY_STEPS)(
            _perturbed(params), arrays, lights, tcam, TRAIN_SEED)
    torch.save({"params": [x.cpu() for x in params], "target": target.cpu(), "cam": tcam},
               os.path.join(out_dir, "train_in.pt"))
    tstep = make_sharded_train_step(meta, make_mesh(1, dev), WIDTH, HEIGHT, TRAIN_BOUNCES, PAR_LR,
                                    sky_steps=SKY_STEPS)
    ref["params0"] = [x.cpu().numpy() for x in params]
    ref["train_losses"], ref["train_s"], lt = [], [], lights
    for i in range(PAR_TRAIN_STEPS):
        (loss, params, lt), _, wall = _par_timed(
            lambda p=params, l=lt: tstep(p, arrays, l, tcam, target, TRAIN_SEED))
        ref["train_losses"].append(float(loss))
        ref["train_s"].append(wall)
        if i == 0:
            ref["params1"] = [x.cpu().numpy() for x in params]

    pack = lm.lmpack_from_crate_entry(
        Crate.load(os.path.join(ROOT, "data", "e1m1", "lmpack.npz")).get("e1m1_lmpack"), dev)
    ref["bake_walls"] = []
    for f in PAR_BAKE_FRAMES:
        pack, _, wall = _par_timed(lambda p=pack, f=f: lm.bake_step(
            meta, arrays, lights, p, f, max_bounces=BOUNCES))
        ref["bake_walls"].append(wall)
    ref["bake"] = (pack.probes.cpu().numpy(), pack.sample_counts.cpu().numpy())
    return ref


def _check_counts(label: str, counts: dict, path: str) -> None:
    for name in PATH_KERNELS[path]:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched on {label} ({path})")


def check_gloo_world(ref: dict, ranks: list, out_dir: str, smi: str) -> dict:
    """Phase 8's two-rank results against the main process's one-rank ones;
    returns the launches of the sharded paths (summed over the ranks)."""
    import hashlib

    import numpy as np

    from pim_tpu_torch.app import SKY_STEPS
    from pim_tpu_torch.render.diff import DiffParams

    for r in ranks:
        bad = [k for k, v in r["digest"].items() if ref["digest"][k] != v]
        if bad or r["backend"] != "gloo":
            raise AssertionError(f"rank {r['rank']} ({r['backend']}): its e1m1 build differs "
                                 f"from the main process's in {bad}")
    names = ("color", "albedo", "normal")
    same = {}
    for r in ranks:
        for name, got, want in zip(names, r["render"], ref["render"]):
            diff_lanes = int(np.any(got.view(np.int32) != want.view(np.int32), axis=-1).sum())
            same[(r["rank"], name)] = diff_lanes
        same[(r["rank"], "live")] = int((r["render_live"] != ref["render_live"]).sum())
    print(f"parallel e1m1 {WIDTH}^2 render, {BOUNCES} bounces, sample {PAR_SAMPLE}, "
          f"{PAR_RANKS} gloo ranks on cuda:0 ({N_RAYS // PAR_RANKS} rays a rank): lanes (or "
          f"live cells) differing from the unsharded trace {same}; walls of a step per rank "
          f"{[[round(w * 1e3, 3) for w in r['render_s']] for r in ranks]} ms, unsharded "
          f"{[round(w * 1e3, 3) for w in ref['render_s']]} ms; launches per rank "
          f"{[r['launches']['e1m1_sharded_render'] for r in ranks]} [{smi}]")
    if any(same.values()):
        raise AssertionError(f"the sharded e1m1 render differs from the unsharded trace: {same}")

    p0 = ref["params0"]
    first = ranks[0]["train"]["params"][0]
    worst = {}
    for r in ranks:
        t = r["train"]
        if not all(np.isfinite(t["losses"])):
            raise AssertionError(f"rank {r['rank']}: sharded train losses {t['losses']}")
        for name, a, b, last, c in zip(DiffParams._fields, p0, t["params"][0], t["params"][-1],
                                       first):
            if not np.array_equal(b, c):
                raise AssertionError(f"the ranks' {name} differ after the first step")
            if np.array_equal(a, last):
                raise AssertionError(f"the sharded train step did not move {name}")
        for name, a, b, want in zip(DiffParams._fields, p0, t["params"][0], ref["params1"]):
            du, dw = (b - a).astype(np.float64), (want - a).astype(np.float64)
            tol = PAR_UPDATE_RTOL * (np.abs(dw) + np.abs(dw).max())
            worst[name] = float(np.max(np.abs(du - dw) / np.maximum(np.abs(dw).max(), 1e-30)))
            if not (np.abs(du - dw) <= tol).all():
                raise AssertionError(f"the sharded {name} update differs from the one-rank "
                                     f"update beyond rtol {PAR_UPDATE_RTOL}: {worst[name]}")
    print(f"parallel e1m1 train step {WIDTH}^2, {TRAIN_BOUNCES} bounces, sky_steps {SKY_STEPS}, "
          f"all six groups, SGD lr {PAR_LR}: losses per rank "
          f"{[r['train']['losses'] for r in ranks]} (one rank {ref['train_losses']}); first "
          f"update against the one-rank step, max |diff| / max |update| by group {worst}; "
          f"walls of a step per rank "
          f"{[[round(w * 1e3, 1) for w in r['train']['walls']] for r in ranks]} ms, one rank "
          f"{[round(w * 1e3, 1) for w in ref['train_s']]} ms; launches per rank "
          f"{[r['launches']['e1m1_sharded_train'] for r in ranks]} [{smi}]")

    probes, counts = ref["bake"]
    want_sha = hashlib.sha256(probes.tobytes() + counts.tobytes()).hexdigest()
    got_p = np.load(os.path.join(out_dir, "bake_probes.npy"))
    got_c = np.load(os.path.join(out_dir, "bake_counts.npy"))
    same_bake = (np.array_equal(got_p.view(np.int32), probes.view(np.int32))
                 and np.array_equal(got_c, counts))
    print(f"parallel e1m1 lm_gen bake, {counts.shape[0]} texels "
          f"({[r['bake']['texels'] for r in ranks]} a rank), {len(PAR_BAKE_FRAMES)} passes, "
          f"{BOUNCES} bounces: bit for bit the whole bake {same_bake}, every rank's gather the "
          f"same "
          f"{all(r['bake']['sha256'] == want_sha for r in ranks)}; ms a pass per rank "
          f"{[[round(w * 1e3, 3) for w in r['bake']['walls']] for r in ranks]}, whole "
          f"{[round(w * 1e3, 3) for w in ref['bake_walls']]}; launches per rank "
          f"{[r['launches']['e1m1_sharded_bake'] for r in ranks]} [{smi}]")
    if not same_bake or any(r["bake"]["sha256"] != want_sha for r in ranks):
        raise AssertionError("the texel-sharded e1m1 bake differs from the whole bake")
    print(f"parallel gloo ranks: e1m1 build {[round(r['build_s'], 3) for r in ranks]} s; peak "
          f"memory {[round(r['peak_bytes'] / 2**30, 3) for r in ranks]} GiB")

    launches = {}
    for path in ("e1m1_sharded_render", "e1m1_sharded_train", "e1m1_sharded_bake"):
        for r in ranks:
            _check_counts(f"rank {r['rank']}", r["launches"][path], path)
        launches[path] = _sum_counts(*(r["launches"][path] for r in ranks))
    return launches


def check_nccl_world(r: dict, smi: str) -> dict:
    from pim_tpu_torch.app import gate_band

    lo, hi = gate_band("cornell512")
    line = r["dryrun"].strip().splitlines()[-1] if r["dryrun"].strip() else ""
    print(f"parallel one-rank NCCL world on cuda:0 (backend {r['backend']}, mesh "
          f"{r['mesh_backend']}): {line} ({r['dryrun_s']:.2f} s, launches "
          f"{r['dryrun_launches']}); Cornell {WIDTH}^2 {SPP} spp, {BOUNCES} bounces: mean "
          f"{r['mean']:.6f} band [{lo:.6f}, {hi:.6f}], finite {r['finite']}, wall "
          f"{r['render_s'] * 1e3:.1f} ms, launches {r['render_launches']}; peak memory "
          f"{r['peak_bytes'] / 2**30:.3f} GiB [{smi}]")
    if r["backend"] != "nccl" or r["mesh_backend"] != "nccl":
        raise AssertionError("the one-rank world did not reduce over NCCL")
    if not (line.startswith("dryrun_multichip(1): loss=") and line.endswith(" ok")):
        raise AssertionError(f"dryrun_multichip(1) printed {r['dryrun']!r}")
    if not r["finite"] or not lo <= r["mean"] <= hi:
        raise AssertionError("the NCCL world's Cornell frame is outside cornell512")
    _check_counts("the NCCL rank", r["dryrun_launches"], "cornell_nccl_dryrun")
    _check_counts("the NCCL rank", r["render_launches"], "cornell_nccl_render")
    return {"cornell_nccl_dryrun": r["dryrun_launches"],
            "cornell_nccl_render": r["render_launches"]}


def run_spheres_shell(smi: str) -> dict:
    """`cornell_box spheres` through the shell on the card: one 128^2 frame
    (the cluster backend with glass); finite, nonzero, K4/K5 launched."""
    import torch

    os.makedirs("screenshots", exist_ok=True)
    eng, launches = _run_engine(
        f"cornell spheres shell {SPHERES_RES}^2", SPHERES_RES,
        "cornell_box spheres; teleport -4 0 4; lookat 0 -1 0; pt_trace 1; wait 1; pt_trace 0; "
        "quit", smi)
    img = eng.render.buffers.color
    mean = float(img.mean())
    print(f"cornell spheres shell: {eng.render.meta.tri_count} tris, backend "
          f"{eng.render.meta.backend}, refractive {eng.render.meta.has_refractive}, "
          f"{eng.render.sample_count} samples, mean {mean:.6f}")
    if not bool(torch.isfinite(img).all()) or not mean > 0.0:
        raise AssertionError("the spheres frame is not finite and nonzero")
    if eng.render.meta.backend != "cluster":
        raise AssertionError("the spheres scene did not take the cluster backend")
    _check_counts("the shell", launches, "cornell_spheres_shell")
    return {"cornell_spheres_shell": launches}


def run_parallel(dev, e1m1_scene, smi: str) -> dict:
    """Phase 8, the scale-out layer; returns the launches of its paths."""
    import shutil

    import torch

    from pim_tpu_torch.parallel.dryrun import free_port, spawn_world

    out_dir = os.path.join(ROOT, "build", "parallel")
    shutil.rmtree(out_dir, ignore_errors=True)  # this phase's own outputs only
    os.makedirs(out_dir)
    torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the ranks
    t0 = time.perf_counter()
    ref = _par_reference(dev, e1m1_scene, out_dir)
    print(f"parallel: the one-rank side in the main process {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    spawn_world(PAR_RANKS, _par_gloo_rank, (out_dir,))
    print(f"parallel: the {PAR_RANKS}-rank gloo world {time.perf_counter() - t0:.1f} s")
    ranks = [torch.load(os.path.join(out_dir, f"gloo_rank{r}.pt"), weights_only=False)
             for r in range(PAR_RANKS)]
    launches = check_gloo_world(ref, ranks, out_dir, smi)
    t0 = time.perf_counter()
    spawn_world(1, _par_nccl_rank, (out_dir, f"127.0.0.1:{free_port()}"))
    print(f"parallel: the one-rank NCCL world {time.perf_counter() - t0:.1f} s")
    launches.update(check_nccl_world(
        torch.load(os.path.join(out_dir, "nccl_rank0.pt"), weights_only=False), smi))
    cwd = os.getcwd()
    os.chdir(out_dir)
    try:
        launches.update(run_spheres_shell(smi))
    finally:
        os.chdir(cwd)
    return launches


SORT_RES = 128            # ab_sort's frame
CLUSTER_RAYS = 262144     # bench_cluster --n
NAMED_SUBSYSTEMS = ("intersect", "table-gather", "surface-fetch")  # where K1-K7 must land


def run_perf_table(dev, e1m1_scene, smi: str) -> dict:
    """tools/perf_table.py on the Cornell and e1m1 steps: the rows sum to
    the profiler's device time within 1%, every port kernel lands in a
    named subsystem.  Returns the traced steps' launches."""
    from pim_tpu_torch.app import build_cornell_scene
    from pim_tpu_torch.tools import perf_table

    launches = {}
    for name, scene in (("cornell", build_cornell_scene(dev)), ("e1m1", e1m1_scene)):
        t0 = time.perf_counter()
        r = perf_table.run_path(name, scene, dev)
        perf_table.print_result(r, smi)
        print(f"measurement perf_table {name}: other share {r['device']['other_share']:.4f}, "
              f"{time.perf_counter() - t0:.1f} s [{smi}]")
        perf_table.check(r)
        stray = {k: v for k, v in r["port_kernels"].items() if set(v) - set(NAMED_SUBSYSTEMS)}
        if stray:
            raise AssertionError(f"perf_table {name}: port kernels outside "
                                 f"{NAMED_SUBSYSTEMS}: {stray}")
        launches[f"perf_table_{name}"] = r["launches"]
        _check_counts("perf_table", r["launches"], f"perf_table_{name}")
    return launches


def run_ab_sort(dev, e1m1_scene, smi: str) -> dict:
    """tools/ab_sort.py on e1m1 at SORT_RES^2: images and ray counts bit
    for bit equal sorted and unsorted.  Returns its launches."""
    from pim_tpu_torch import native
    from pim_tpu_torch.tools import ab_sort

    t0 = time.perf_counter()
    native.reset_launches()
    r = ab_sort.run(e1m1_scene, dev, SORT_RES)
    launches = dict(native.launches)
    print(ab_sort.report(r, smi))
    print(f"measurement ab_sort: {time.perf_counter() - t0:.1f} s, launches {launches} [{smi}]")
    if not (r["images_equal"] and r["rays_equal"]):
        raise AssertionError("ab_sort: the sorted and unsorted e1m1 frames differ")
    _check_counts("ab_sort", launches, "ab_sort")
    return {"ab_sort": launches}


def run_bench_cluster(dev, smi: str) -> dict:
    """tools/bench_cluster.py at CLUSTER_RAYS rays: the table and the
    measured crossover; K4's t must equal K1's and K5's flag K2's on every
    ray of every soup, and the bvh walk K1's triangle and K2's flag on every
    ray on which no compare lies near its limit (`bvh_off` 0).  Returns its
    launches."""
    import math

    from pim_tpu_torch import native
    from pim_tpu_torch.render.scene import DENSE_CROSSOVER_TRIS
    from pim_tpu_torch.tools import bench_cluster

    t0 = time.perf_counter()
    native.reset_launches()
    rows = bench_cluster.run(dev, CLUSTER_RAYS)
    launches = dict(native.launches)
    print(bench_cluster.table(rows))
    print(f"bench_cluster crossover (K4 beats K1 on both ray sets from): "
          f"{bench_cluster.crossover(rows)} tris; any hit (K5 beats K2): "
          f"{bench_cluster.crossover(rows, 'k2', 'k5')} tris; DENSE_CROSSOVER_TRIS "
          f"{DENSE_CROSSOVER_TRIS}; every timing back to back "
          f"{all(r[k + '_back_to_back'] for r in rows for k in bench_cluster.KERNELS)}")
    print(json.dumps({"bench_cluster": rows}))
    print(f"measurement bench_cluster: {time.perf_counter() - t0:.1f} s [{smi}]")
    bad = [r for r in rows for k in bench_cluster.KERNELS
           if not (math.isfinite(r[k + "_mrays"]) and r[k + "_mrays"] > 0.0)]
    if bad:
        raise AssertionError(f"bench_cluster: rows without a rate: {bad}")
    bad = bench_cluster.disagreements(rows)
    if bad:
        raise AssertionError(f"bench_cluster: K4's t is not K1's or K5's flag not K2's on "
                             f"every ray, or the walk leaves them off a limit: {bad}")
    _check_counts("bench_cluster", launches, "bench_cluster")
    return {"bench_cluster": launches}


def run_measurement(dev, e1m1_scene, smi: str) -> dict:
    """Phase 9, the measurement modules; returns the launches of their
    paths."""
    launches = run_perf_table(dev, e1m1_scene, smi)
    launches.update(run_ab_sort(dev, e1m1_scene, smi))
    launches.update(run_bench_cluster(dev, smi))
    return launches


# ---------------------------------------------------------------------------
# Phase 10: the Moller-Trumbore backends (brute, bvh)
# ---------------------------------------------------------------------------

MT_KERNELS = ("brute_isect", "brute_anyhit", "bvh_isect", "bvh_anyhit")
MT_BRUTE_LANES = 32768   # e1m1 rays through the brute-force kernels (2.7e9 tests)
MT_TIE_DISTINCT = 40     # the MT tie soup: distinct triangles,
MT_TIE_COPIES = 20       # each this often, shuffled (800: two chunks of the scan)
MT_TIE_LANES = 32768
MT_E1M1_STEPS = 3        # 512^2 1-spp steps a turn through bvh and cluster (1 warm-up)
MT_SHELL_RES = 128       # the shell frames after pt_backend brute / bvh
MT_SHADOW_T = 7.0        # one t_far for all of the camera rays' any hit
MT_PLAIN_RUNS = 1        # timed calls of a plain MT version (a walk takes ~0.7 s)


def _check_mt(label: str, got, want) -> float:
    """Kernel outputs against the plain version's, bit for bit; returns the
    largest |difference| of the first output (t, or the flag)."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    diffs = [int((g.view(torch.int32) != w.view(torch.int32)).sum()) for g, w in zip(got, want)]
    hits = int((got[1] >= 0).sum()) if len(got) > 1 else int(got[0].sum())
    print(f"{label}: lanes {got[0].shape[0]}, hits {hits}, bit differences {diffs} "
          "(t, tri, u, v, det | flag)")
    if any(diffs) or len(got) != len(want):
        raise AssertionError(f"{label} differs from its plain version: {diffs}")
    return float((got[0].float() - want[0].float()).abs().max())


def check_bvh_builds(e1m1_positions) -> None:
    """Both builders on the Cornell, spheres and e1m1 soups: seconds, nodes,
    and every tree's validate_bvh depth (it must fit the walk's stack)."""
    from pim_tpu_torch import native
    from pim_tpu_torch.geom import bvh
    from pim_tpu_torch.geom.cornell import build_cornell_box
    from pim_tpu_torch.geom.entities import flatten

    t0 = time.perf_counter()
    path = native.build_bvh_builder()
    print(f"bvh builder: {path} (g++ {' '.join(native.GXX_FLAGS)}) "
          f"{time.perf_counter() - t0:.2f} s")
    for name, pos in (("cornell boxes", flatten(build_cornell_box("boxes")[0]).positions),
                      ("cornell spheres", flatten(build_cornell_box("spheres")[0]).positions),
                      ("e1m1", e1m1_positions)):
        t0 = time.perf_counter()
        tn = bvh.build_bvh_numpy(pos)
        t1 = time.perf_counter()
        tc = native.build_bvh_native(pos)
        t2 = time.perf_counter()
        dn, dc = bvh.validate_bvh(tn, pos), bvh.validate_bvh(tc, pos)
        print(f"bvh build {name}: {pos.shape[0] // 3} tris; numpy {t1 - t0:.3f} s, "
              f"{len(tn.node_a)} nodes, depth {dn}; native {t2 - t1:.3f} s, {len(tc.node_a)} "
              f"nodes, depth {dc} (the walk's stack {bvh.STACK_DEPTH})")
        if max(dn, dc) > bvh.STACK_DEPTH:
            raise AssertionError(f"the {name} BVH is deeper than the walk's stack")


def _mt_time(label: str, kernel, plain, work: dict, args, anyhit: bool) -> tuple:
    """A kernel timed (queued) beside its plain version (MT_PLAIN_RUNS calls
    from an idle device: the walk waits on the device every trip) and its
    bound: `work`'s operations and scene bytes, the rays `args` (ro, rd,
    t_near, t_far) and the outputs (t, tri, u, v, det; or the flag).
    Returns (kernel, plain, bound)."""
    k = _timing(kernel)
    p = _timing(plain, MT_PLAIN_RUNS, queued=False)
    n = args[0].x.shape[0]
    n_bytes = work["scene_bytes"] + _ray_bytes(n, args[3]) + n * (4 if anyhit else 20)
    bound = _bound(n_bytes, work["ops"])
    print(f"{label}: kernel {_fmt(k)}; plain {_fmt(p)} ({MT_PLAIN_RUNS} runs); bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}; {n_bytes} bytes, "
          f"{work['ops']} operations)")
    return k, p, bound


def _repo_site(filename: str, lineno: int) -> str:
    """The innermost line of this repository on the stack of a warning
    being shown (skipping the hook's own frames), else the warning's own
    location."""
    for f in reversed(traceback.extract_stack()[:-2]):
        if f.filename.startswith(ROOT + os.sep):
            return f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"
    return f"{filename}:{lineno}"


@contextlib.contextmanager
def _sync_watch(syncs: dict):
    """Fills `syncs` ({"count": n, "at": {"file:line": n}}) while the block
    runs with the host syncs torch reports on the card (sync debug mode
    "warn"), each at the innermost line of this repository that led to it.
    The switch into the mode happens before the block, unwatched: its first
    use in a process reports a sync of its own."""
    import torch

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return shown(message, category, filename, lineno, file, line)
        at = _repo_site(filename, lineno)
        syncs["count"] += 1
        syncs["at"][at] = syncs["at"].get(at, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            shown, warnings.showwarning = warnings.showwarning, note
            yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _check_no_syncs(label: str, scene, scene_name: str, res: int, spp: int) -> None:
    """One more step of a frame (res^2, BOUNCES, spp samples, each through
    the same bounce loop, and the exposure pass on its image where the
    scene is exposed, as `app.render_frame` steps) queued by
    `app.timed_steps` under `_sync_watch` (torch's sync debug mode): the
    host syncs torch reports in it must be 0, as in the benchmark's window."""
    from pim_tpu_torch.app import EXPOSURE_DT, SCENES, bench_camera, render_step, timed_steps
    from pim_tpu_torch.render.exposure import ExposureParams, exposure_pass, make_exposure_state

    dev = scene[1].tri_table.device
    cam = bench_camera(scene_name, res, res)
    exp_params = ExposureParams.from_cvars() if SCENES[scene_name].exposed else None

    def step(i: int):
        res_i = render_step(scene, cam, res, res, BOUNCES, spp, i)
        if exp_params is not None:
            exposure_pass(res_i.color, exp_params, make_exposure_state(dev), EXPOSURE_DT)
        return res_i.rays_traced

    syncs = {"count": 0, "at": {}}
    timed_steps(step, dev, 1, 0, _sync_watch(syncs))
    print(f"{label}: host syncs in one queued step {syncs['count']} {syncs['at']}")
    if syncs["count"]:
        raise AssertionError(f"{label}: the step synced with the host: {syncs['at']}")


def _camera_rays(dev, scene_name: str):
    """The N_RAYS primary rays of sample 0 of the scene's bench camera."""
    import torch

    from pim_tpu_torch.app import bench_camera
    from pim_tpu_torch.core import rng
    from pim_tpu_torch.math.vec3 import V3
    from pim_tpu_torch.render.camera import generate_primary_rays

    state = rng.make_state(torch.arange(N_RAYS, device=dev), 0)
    _, ro, rd = generate_primary_rays(bench_camera(scene_name, WIDTH, HEIGHT), WIDTH, HEIGHT,
                                      state)
    return V3(*(c.contiguous() for c in ro)), V3(*(c.contiguous() for c in rd))


def run_cornell_brute(dev) -> tuple:
    """The Cornell slice through `brute`: its main path (built on the card,
    the 512^2 frame gated by `cornell512`, its host syncs), brute_isect and brute_anyhit on
    the camera rays and one seeded bounce against their plain versions, the
    small frame against the CPU.  Returns (rows, launches)."""
    import torch

    from pim_tpu_torch import native
    from pim_tpu_torch.app import build_cornell_scene, gate_band, render_frame
    from pim_tpu_torch.math.vec3 import RCP_EPS
    from pim_tpu_torch.render import intersect as MT
    from pim_tpu_torch.tools.mt_check import brute_work

    native.reset_launches()
    t0 = time.perf_counter()
    scene = build_cornell_scene(dev, "brute")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fr = render_frame(scene, "cornell", WIDTH, HEIGHT, BOUNCES, SPP, STEPS)
    launches = dict(native.launches)
    lo, hi = gate_band("cornell512")
    print(f"cornell brute scene build on card: {build_s:.3f} s")
    print(_frame_line(f"cornell brute frame {WIDTH}x{HEIGHT} bounces={BOUNCES} spp/step={SPP} "
                      f"steps={STEPS} band=[{lo:.6f}, {hi:.6f}]", fr))
    print(f"cornell brute launches during build+frame: {launches}")
    _check_frame(fr, WIDTH * HEIGHT, ("gather_cols", "brute_isect", "brute_anyhit"))
    if not lo <= fr.mean <= hi:
        raise AssertionError(f"brute frame mean {fr.mean} outside cornell512 [{lo}, {hi}]")
    _check_no_syncs("cornell brute frame", scene, "cornell", WIDTH, 1)

    pos = scene[1].positions
    cro, crd = _camera_rays(dev, "cornell")
    ro, rd, t_far, t_short = _bounce_rays(dev, scene, "cornell")
    err = _check_mt("brute_isect [cornell camera]", MT.brute_isect(pos, cro, crd, 0.0, RCP_EPS),
                    MT.brute_isect_plain(pos, cro, crd, 0.0, RCP_EPS))
    err = max(err, _check_mt("brute_isect [cornell bounce]",
                             MT.brute_isect(pos, ro, rd, 0.0, t_far),
                             MT.brute_isect_plain(pos, ro, rd, 0.0, t_far)))
    aerr = _check_mt("brute_anyhit [cornell camera]",
                     MT.brute_anyhit(pos, cro, crd, 0.0, MT_SHADOW_T),
                     MT.brute_anyhit_plain(pos, cro, crd, 0.0, MT_SHADOW_T))
    aerr = max(aerr, _check_mt("brute_anyhit [cornell bounce]",
                               MT.brute_anyhit(pos, ro, rd, 0.0, t_short),
                               MT.brute_anyhit_plain(pos, ro, rd, 0.0, t_short)))
    rows = {
        "brute_isect": _row(err, *_mt_time(
            "brute_isect time [cornell bounce]", lambda: MT.brute_isect(pos, ro, rd, 0.0, t_far),
            lambda: MT.brute_isect_plain(pos, ro, rd, 0.0, t_far),
            brute_work(pos, ro, rd, 0.0, t_far, False), (ro, rd, 0.0, t_far), False)),
        "brute_anyhit": _row(aerr, *_mt_time(
            "brute_anyhit time [cornell bounce]",
            lambda: MT.brute_anyhit(pos, ro, rd, 0.0, t_short),
            lambda: MT.brute_anyhit_plain(pos, ro, rd, 0.0, t_short),
            brute_work(pos, ro, rd, 0.0, t_short, True), (ro, rd, 0.0, t_short), True)),
    }
    check_small_frame("cornell", scene, _scene_to(scene, "cpu"))
    return rows, {"cornell_brute": launches}


def run_e1m1_bvh(dev, e1m1_scene) -> tuple:
    """The e1m1 slice through `bvh`: its main path (built on the card, the
    128^2 16-step render gated by `e1m1_128`, its host syncs), a 512^2
    1-spp step through bvh beside the same step through cluster (two turns
    each), bvh_isect / bvh_anyhit on the main path's camera, bounce-1 and
    NEE rays and a seeded bounce against the plain walk on every lane
    (K4/K5 timed on the same rays), brute_isect / brute_anyhit on
    MT_BRUTE_LANES of the seeded bounce, the small frame against the CPU.  Returns (rows, launches, scene)."""
    import torch

    from pim_tpu_torch import native
    from pim_tpu_torch.app import build_e1m1_scene, gate_band, render_frame
    from pim_tpu_torch.math.vec3 import V3
    from pim_tpu_torch.render import cluster as CL
    from pim_tpu_torch.geom.bvh import BvhArrays
    from pim_tpu_torch.render import intersect as MT
    from pim_tpu_torch.tools.mt_check import brute_work, bvh_work, main_path_wavefronts

    native.reset_launches()
    t0 = time.perf_counter()
    scene = build_e1m1_scene(dev, "bvh")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    lo, hi = gate_band("e1m1_128")
    gate = render_frame(scene, "e1m1", GATE_RES, GATE_RES, BOUNCES, 1, 16)
    launches = dict(native.launches)
    meta, arrays, _ = scene
    print(f"e1m1 bvh scene build on card: {build_s:.3f} s ({arrays.bvh_a.shape[0]} nodes, "
          f"max_leaf {meta.max_leaf})")
    print(_frame_line(f"e1m1 bvh gate frame {GATE_RES}x{GATE_RES} bounces={BOUNCES} spp=16 "
                      f"band=[{lo:.6f}, {hi:.6f}] (CPU anchor)", gate))
    print(f"e1m1 bvh launches during build+frame: {launches}")
    _check_frame(gate, GATE_RES * GATE_RES, ("gather_cols", "gather_bilinear", "bvh_isect",
                                             "bvh_anyhit"))
    if not lo <= gate.mean <= hi:
        raise AssertionError(f"e1m1 bvh {GATE_RES}^2 mean {gate.mean} outside e1m1_128 "
                             f"[{lo}, {hi}]")
    _check_no_syncs("e1m1 bvh gate frame", scene, "e1m1", GATE_RES, 1)
    walls = {"bvh": [], "cluster": []}
    for name, sc in (("bvh", scene), ("cluster", e1m1_scene), ("cluster", e1m1_scene),
                     ("bvh", scene)):  # in turns: the host drifts within a call
        fr = render_frame(sc, "e1m1", WIDTH, HEIGHT, BOUNCES, 1, MT_E1M1_STEPS)
        walls[name].append(fr.ms_per_step)
        print(_frame_line(f"e1m1 {WIDTH}^2 1-spp step through {name}", fr))
    print(f"e1m1 {WIDTH}^2 1-spp step, mean of two turns: bvh {sum(walls['bvh']) / 2:.3f} ms, "
          f"cluster {sum(walls['cluster']) / 2:.3f} ms")

    bvh = BvhArrays(arrays.bvh_lo, arrays.bvh_hi, arrays.bvh_a, arrays.bvh_b, arrays.tri_order)
    pos, ml = arrays.positions, meta.max_leaf
    cl = CL.ClusterArrays(tris=e1m1_scene[1].cl_tris, clb=e1m1_scene[1].cl_clb,
                          scb=e1m1_scene[1].cl_scb)
    waves = main_path_wavefronts(scene, "e1m1", WIDTH, HEIGHT)
    ro, rd, t_far, t_short = _bounce_rays(dev, scene)
    sets = {"camera": waves["primary"], "bounce-1": waves["bounce"],
            "seeded bounce": (ro, rd, 0.0, t_far)}
    rows = {"bvh_isect": {}, "bvh_anyhit": {}}
    err = 0.0
    for which, args in sets.items():
        out, work = bvh_work(bvh, pos, *args, ml, False)
        err = max(err, _check_mt(f"bvh_isect [e1m1 {which}]", MT.bvh_isect(bvh, pos, *args, ml),
                                 out))
        print(f"bvh_isect [e1m1 {which}] walk: {work}")
        if which == "bounce-1":
            timed = _mt_time(f"bvh_isect time [e1m1 {which}]",
                             lambda: MT.bvh_isect(bvh, pos, *args, ml),
                             lambda: MT.bvh_isect_plain(bvh, pos, *args, ml), work, args, False)
            rows["bvh_isect"].update(_row(0.0, *timed))
            k4 = _timing(lambda: CL.cluster_isect(cl, *args))
            rows["bvh_isect"]["k4_same_rays_ms"] = k4["ms"]
            print(f"K4 cluster_isect on the same rays: {_fmt(k4)}")
    rows["bvh_isect"]["max_abs_err"] = err
    aerr = 0.0
    for which, args in (("NEE", waves["shadow"]), ("seeded bounce", (ro, rd, 0.0, t_short))):
        out, work = bvh_work(bvh, pos, *args, ml, True)
        aerr = max(aerr, _check_mt(f"bvh_anyhit [e1m1 {which}]",
                                   MT.bvh_anyhit(bvh, pos, *args, ml), out))
        print(f"bvh_anyhit [e1m1 {which}] walk: {work}")
        if which == "NEE":
            timed = _mt_time(f"bvh_anyhit time [e1m1 {which}]",
                             lambda: MT.bvh_anyhit(bvh, pos, *args, ml),
                             lambda: MT.bvh_anyhit_plain(bvh, pos, *args, ml), work, args, True)
            rows["bvh_anyhit"].update(_row(aerr, *timed))
            k5 = _timing(lambda: CL.cluster_anyhit(cl, *args))
            rows["bvh_anyhit"]["k5_same_rays_ms"] = k5["ms"]
            print(f"K5 cluster_anyhit on the same rays: {_fmt(k5)}")
    rows["bvh_anyhit"]["max_abs_err"] = aerr

    sub = slice(0, MT_BRUTE_LANES)
    bro, brd = V3(*(c[sub] for c in ro)), V3(*(c[sub] for c in rd))
    extra = {}
    for name, kernel, plain, tf, anyhit in (
            ("brute_isect", MT.brute_isect, MT.brute_isect_plain, t_far[sub], False),
            ("brute_anyhit", MT.brute_anyhit, MT.brute_anyhit_plain, t_short[sub], True)):
        e = _check_mt(f"{name} [e1m1 seeded bounce, {MT_BRUTE_LANES} lanes]",
                      kernel(pos, bro, brd, 0.0, tf), plain(pos, bro, brd, 0.0, tf))
        timed = _mt_time(f"{name} time [e1m1, {MT_BRUTE_LANES} lanes]",
                         lambda: kernel(pos, bro, brd, 0.0, tf),
                         lambda: plain(pos, bro, brd, 0.0, tf),
                         brute_work(pos, bro, brd, 0.0, tf, anyhit), (bro, brd, 0.0, tf), anyhit)
        extra[name] = {f"e1m1_{key}": v for key, v in _row(e, *timed).items()
                       if not key.startswith("library")}
    check_small_frame("e1m1", scene, _scene_to(scene, "cpu"))
    return rows, extra, {"e1m1_bvh": launches}, scene


def check_mt_tie_soup(dev) -> dict:
    """Both families on a soup of coincident triangles in different chunks
    and leaves (cluster_check.tie_soup, the C++ builder's tree), rays
    aimed at them with ~10% dead lanes: bit for bit on every lane."""
    import numpy as np
    import torch

    from pim_tpu_torch.geom import bvh as B
    from pim_tpu_torch.math.vec3 import V3
    from pim_tpu_torch.render import intersect as MT
    from pim_tpu_torch.tools.cluster_check import aimed_rays, tie_soup

    soup, base = tie_soup(MT_TIE_DISTINCT, MT_TIE_COPIES, seed=12)
    tree = B.build_bvh(soup)
    print(f"MT tie soup: {MT_TIE_DISTINCT} triangles x {MT_TIE_COPIES} copies, "
          f"{len(tree.node_a)} nodes, depth {B.validate_bvh(tree, soup)}")
    ro, rd, t_far = aimed_rays(base, MT_TIE_LANES, seed=13)
    t_short = np.where(t_far > 0.0, np.random.default_rng(14).uniform(
        0.5, 15.0, MT_TIE_LANES), 0.0).astype(np.float32)

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    pos, bvh = cuda(soup), B.BvhArrays(*(cuda(x) for x in tree))
    ro, rd, t_far, t_short = V3(*(cuda(c) for c in ro)), V3(*(cuda(c) for c in rd)), \
        cuda(t_far), cuda(t_short)
    return {
        "brute_isect": _check_mt("brute_isect [tie soup]", MT.brute_isect(pos, ro, rd, 0.0, t_far),
                                 MT.brute_isect_plain(pos, ro, rd, 0.0, t_far)),
        "brute_anyhit": _check_mt("brute_anyhit [tie soup]",
                                  MT.brute_anyhit(pos, ro, rd, 0.0, t_short),
                                  MT.brute_anyhit_plain(pos, ro, rd, 0.0, t_short)),
        "bvh_isect": _check_mt("bvh_isect [tie soup]", MT.bvh_isect(bvh, pos, ro, rd, 0.0, t_far),
                               MT.bvh_isect_plain(bvh, pos, ro, rd, 0.0, t_far)),
        "bvh_anyhit": _check_mt("bvh_anyhit [tie soup]",
                                MT.bvh_anyhit(bvh, pos, ro, rd, 0.0, t_short),
                                MT.bvh_anyhit_plain(bvh, pos, ro, rd, 0.0, t_short)),
    }


def run_mt_shell(smi: str) -> dict:
    """One shell frame each after `pt_backend brute` (Cornell) and
    `pt_backend bvh` (e1m1): finite, nonzero, the scene on that backend,
    its kernels launched.  Returns the launches."""
    import shutil

    import torch

    from pim_tpu_torch.core import cvars as cv

    out_dir = os.path.join(ROOT, "build", "mt_shell")
    shutil.rmtree(out_dir, ignore_errors=True)  # this phase's own outputs only
    os.makedirs(out_dir)
    cwd = os.getcwd()
    os.chdir(out_dir)
    launches = {}
    try:
        cv.cv_basedir.set(os.path.join(ROOT, "data"))
        for path, backend, load in (
                ("cornell_brute_shell", "brute", "cornell_box; teleport -4 0 4; lookat 0 -1 0"),
                ("e1m1_bvh_shell", "bvh", "mapload e1m1; teleport -2.5 1.7 -2.5; lookat 6 1 6")):
            eng, launches[path] = _run_engine(
                f"{path} {MT_SHELL_RES}^2", MT_SHELL_RES,
                f"pt_backend {backend}; pt_max_bounces {BOUNCES}; {load}; pt_trace 1; wait 1; "
                "pt_trace 0; quit", smi)
            img = eng.render.buffers.color
            mean = float(img.mean())
            print(f"{path}: backend {eng.render.meta.backend}, {eng.render.meta.tri_count} tris, "
                  f"{eng.render.sample_count} samples, mean {mean:.6f}")
            if eng.render.meta.backend != backend:
                raise AssertionError(f"pt_backend {backend} built a {eng.render.meta.backend} "
                                     "scene")
            if not bool(torch.isfinite(img).all()) or not mean > 0.0:
                raise AssertionError(f"the {path} frame is not finite and nonzero")
            _check_counts("the shell", launches[path], path)
    finally:
        cv.cv_pt_backend.set("auto")
        os.chdir(cwd)
    return launches


def run_mt(dev, e1m1_scene, smi: str) -> tuple:
    """Phase 10, the Moller-Trumbore backends; returns (kernel rows, the
    launches of their paths)."""
    check_bvh_builds(e1m1_scene[1].positions.cpu().numpy())
    rows, launches = run_cornell_brute(dev)
    e1m1_rows, extra, e1m1_launches, _ = run_e1m1_bvh(dev, e1m1_scene)
    rows.update(e1m1_rows)
    launches.update(e1m1_launches)
    for name, err in check_mt_tie_soup(dev).items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    for name, more in extra.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], more["e1m1_max_abs_err"])
        rows[name].update(more)
    launches.update(run_mt_shell(smi))
    print(f"MT kernels [{smi}]: " + "; ".join(
        f"{n} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, plain {r['plain_ms']:.3f})"
        for n, r in rows.items()))
    return rows, launches


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
    print(f"device memory copy rate: {_copy_rate(dev) / 1e12:.3f} TB/s (the bounds assume "
          f"{HBM_BYTES_PER_S / 1e12:.2f}; the same model of card has differed between machines)")

    t0 = time.perf_counter()
    kernels, cornell_launches, cornell_cpu = run_cornell(dev)
    print(f"cornell phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    e1m1_kernels, e1m1_launches, e1m1_scene, main_idx = run_e1m1(dev)
    print(f"e1m1 phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_kernels, train_launches = run_training(dev, cornell_cpu, e1m1_scene, main_idx)
    print(f"training phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    shell_launches, probe = run_shell(dev, e1m1_scene, cornell_cpu, smi)
    print(f"shell phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bake_launches = run_bakes(dev, e1m1_scene, cornell_cpu, smi)
    print(f"bakes phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    par_launches = run_parallel(dev, e1m1_scene, smi)
    print(f"parallel phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    measure_launches = run_measurement(dev, e1m1_scene, smi)
    print(f"measurement phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mt_kernels, mt_launches = run_mt(dev, e1m1_scene, smi)
    print(f"Moller-Trumbore phase: {time.perf_counter() - t0:.1f} s")
    # K3 runs on both paths: its row keeps the Cornell times and adds the
    # e1m1 tri table's; its error is the larger of the two checks
    e1m1_k3 = e1m1_kernels.pop("gather_cols")
    kernels.update(e1m1_kernels)
    kernels.update(train_kernels)
    kernels.update(mt_kernels)
    k3 = kernels["gather_cols"]
    k3["max_abs_err"] = max(k3["max_abs_err"], e1m1_k3.pop("max_abs_err"))
    k3.update({f"e1m1_{key}": v for key, v in e1m1_k3.items()})
    kernels["dense_isect"]["max_abs_err"] = max(kernels["dense_isect"]["max_abs_err"],
                                                probe["max_abs_err"])
    by_path = {"cornell": cornell_launches, "e1m1": e1m1_launches, **train_launches,
               **shell_launches, **bake_launches, **par_launches, **measure_launches,
               **mt_launches}
    launches = {name: {p: by_path[p][name] for p in ps} for name, ps in PATHS.items()}
    for name, counts in launches.items():
        for p, count in counts.items():
            if count <= 0:
                raise AssertionError(f"kernel {name} was not launched on the {p} main path")

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": sum(launches[name].values()),
         "launches_by_path": launches[name], **kernels[name]}
        for name in CORNELL_KERNELS + E1M1_KERNELS + TRAIN_KERNELS + MT_KERNELS + BSDF_KERNELS
        + SKY_KERNELS + RNG_KERNELS + MEDIA_KERNELS]}
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
