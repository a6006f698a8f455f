"""K1 and K2 timed on seeded random rays and on the Cornell main path's own
rays, on a CUDA device.

    python -m pim_tpu_torch.tools.dense_variants [--sweep] [--out FILE]

Builds the Cornell scene on the card and records, with
`dense_check.main_path_calls`, the K1 and K2 calls of sample 0 of one
512^2, 10-bounce serving step (K1: the primary rays, then one call a
bounce; K2: one NEE shadow-ray call a bounce), and with
`dense_check.bake_calls` K2's light-grid bake call of a Cornell build.
Beside them it takes `dense_check.random_rays`, 262,144 seeded rays inside
the box, with t_far 1e6 (K1) or 3 (K2), and for K2 `dense_check.wide_scene`
(8,192 distinct rows, 32,768 rays).  On each it holds the wrapper bit
for bit against the plain version and times it (device ms a call:
DEVICE_RUNS calls queued behind a GPU sleep, the median of BATCHES).  With
`--sweep` it also launches K2 at every warp_below of SWEEP through the C
interface (0: one ray a thread in every tile; 513: one ray a warp), each
held against the plain version and timed.  It prints the ptxas registers
of the tree's dense kernels first.

It drives only the package's wrappers and plain versions, so it also times
an older tree of the package, for a comparison of two trees in turns in one
run on the card: run it as a file with that tree first on the path,

    PYTHONPATH=OLD_TREE python pim_tpu_torch/tools/dense_variants.py

It loads tools/dense_check.py from beside this file, whichever tree of the
package that file's helpers then import (`--sweep` needs a tree whose
dense_kernels has `anyhit_launch`).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import time

import torch

SWEEP = (0, 8, 16, 32, 64, 128, 256, 513)  # K2 warp_below values timed with --sweep


def _dense_check():
    """tools/dense_check.py of this file's tree, loaded by its path."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dense_check.py")
    spec = importlib.util.spec_from_file_location("dense_check", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ptxas(log: str) -> list:
    """The ptxas lines (entry functions, spills, registers) of
    dense_isect.cu in a build log."""
    part = log.split("== dense_isect.cu", 1)[-1].split("\n== ", 1)[0]
    return [ln.strip() for ln in part.splitlines()
            if any(w in ln for w in ("Compiling", "spill", "registers"))]


def main(argv=None) -> None:
    from pim_tpu_torch import native
    from pim_tpu_torch.app import build_cornell_scene
    from pim_tpu_torch.math.vec3 import V3
    from pim_tpu_torch.render import dense_kernels as dk
    from pim_tpu_torch.tools.cluster_check import same_bits
    from pim_tpu_torch.tools.fetch_variants import queued_ms

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true", help="time K2 at every warp_below of SWEEP")
    ap.add_argument("--out", default=None, help="JSON file for every number")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dense_variants: no CUDA device is available")
    dc = _dense_check()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, dk.__file__)
    ptxas = _ptxas(native.build_info().log)
    for ln in ptxas:
        print(f"  ptxas: {ln}")
    t0 = time.perf_counter()
    scene = build_cornell_scene(dev)
    calls = dc.main_path_calls(scene)
    torch.cuda.synchronize()
    print(f"Cornell build and sample 0 of a serving step: {time.perf_counter() - t0:.1f} s; "
          f"K1 calls {len(calls['isect'])}, K2 calls {len(calls['anyhit'])}")
    tris12 = scene[1].tris12
    ro, rd, t_far = dc.random_rays(dev)
    k1_cases = [("random", tris12, ro, rd, 0.0, t_far)]
    k1_cases += [(f"main {i}", *call) for i, call in enumerate(calls["isect"])]
    k2_cases = [("random", tris12, ro, rd, 0.0, torch.where(t_far > 0.0, 3.0, 0.0))]
    k2_cases += [(f"main {i}", *call) for i, call in enumerate(calls["anyhit"])]
    k2_cases += [(f"bake {i}", *call) for i, call in enumerate(dc.bake_calls(dev))]
    rows, wro, wrd, wtf = (torch.from_numpy(x).to(dev) for x in dc.wide_scene(8192, 32768, 31))
    k2_cases += [("8192 distinct rows", rows, V3(*wro), V3(*wrd), 0.0, wtf)]

    result = {"device": smi, "torch": torch.__version__, "tree": dk.__file__, "ptxas": ptxas,
              "k1": [], "k2": []}
    for label, rows, o, d, t_near, tf in k1_cases:
        got = dk.dense_isect(rows, o, d, t_near, tf)
        same = same_bits(got, dk.dense_isect_plain(rows, o, d, t_near, tf))
        live = int((torch.as_tensor(tf, device=dev).expand(o.x.shape[0]) > 0.0).sum())
        ms = queued_ms(lambda: dk.dense_isect(rows, o, d, t_near, tf))
        row = dict(case=label, n=o.x.shape[0], live=live, bitwise_equal=same, ms=ms)
        print(f"K1 {label}: {row['n']} rays, {live} live; bitwise equal {same}; "
              f"{statistics.median(ms):.4f} ms {ms}")
        if not same:
            raise AssertionError(f"K1 {label} differs from its plain version")
        result["k1"].append(row)
    for label, rows, o, d, t_near, tf in k2_cases:
        plain = dk.dense_anyhit_plain(rows, o, d, t_near, tf)
        same = same_bits((dk.dense_anyhit(rows, o, d, t_near, tf),), (plain,))
        live = int((torch.as_tensor(tf, device=dev).expand(o.x.shape[0]) > 0.0).sum())
        ms = queued_ms(lambda: dk.dense_anyhit(rows, o, d, t_near, tf))
        row = dict(case=label, n=o.x.shape[0], live=live, bitwise_equal=same, ms=ms)
        print(f"K2 {label}: {row['n']} rays, {live} live; bitwise equal {same}; "
              f"{statistics.median(ms):.4f} ms {ms}")
        if not same:
            raise AssertionError(f"K2 {label} differs from its plain version")
        if args.sweep:
            row["sweep"] = {}
            for wb in SWEEP:
                eq = same_bits((dk.anyhit_launch(rows, o, d, t_near, tf, wb),), (plain,))
                ms = queued_ms(lambda: dk.anyhit_launch(rows, o, d, t_near, tf, wb))
                row["sweep"][wb] = {"equal": eq, "ms": ms}
                print(f"  warp_below {wb:3d}: bitwise equal {eq}; {statistics.median(ms):.4f} ms "
                      f"{ms}")
                if not eq:
                    raise AssertionError(f"K2 {label}: warp_below {wb} differs from plain")
        result["k2"].append(row)
    for key in ("k1", "k2"):
        main_rows = [r for r in result[key] if r["case"].startswith("main")]
        result[f"{key}_main_ms_sum"] = sum(statistics.median(r["ms"]) for r in main_rows)
        print(f"{key.upper()} all {len(main_rows)} main-path calls of sample 0: "
              f"{result[f'{key}_main_ms_sum']:.4f} ms")
    if args.sweep:
        main_rows = [r for r in result["k2"] if r["case"].startswith("main")]
        result["k2_sweep_main_ms_sum"] = {
            wb: sum(statistics.median(r["sweep"][wb]["ms"]) for r in main_rows) for wb in SWEEP}
        for wb, total in result["k2_sweep_main_ms_sum"].items():
            print(f"K2 warp_below {wb:3d}: all {len(main_rows)} main-path calls {total:.4f} ms")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
