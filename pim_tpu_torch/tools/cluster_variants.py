"""K4 and K5 timed on the e1m1 main path's own rays, on a CUDA device.

    python -m pim_tpu_torch.tools.cluster_variants [--sweep] [--out FILE]

Builds the e1m1 scene on the card, times the light-grid bake BAKES times
more, then takes the rays that one 512^2, 1-bounce, 1-spp step of its bench
camera hands the cluster wrappers, in raysort's order (the primary and
bounce-1 closest hits, the NEE shadow rays at the primary hits:
`cluster_check.main_path_wavefronts`), and the first chunk of the bake's
shadow rays (K5, ~4.2M rays).  On each it holds the wrapper bit for bit
against the plain version on CHECK_LANES lanes (`cluster_check.against_plain`,
as chip_smoke.py does) and times the wrapper (device ms a call:
DEVICE_RUNS calls queued behind a GPU sleep, the median of BATCHES).  With
`--sweep` it also launches every LANE_LOOP_MIN of SWEEP through the C
interface (`cluster_check.launcher`), holds each bit for bit against the
wrapper on every lane and times it.

It drives only the package's wrappers and the plain versions, so it also
times an older tree of the package, for a comparison of two trees in turns
in one run on the card: run it as a file with that tree first on the path
(no `--sweep` there),

    PYTHONPATH=OLD_TREE python pim_tpu_torch/tools/cluster_variants.py

It loads tools/cluster_check.py from beside this file, whichever tree of the
package that file's helpers then import.
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

CHECK_LANES = 4096
BATCHES = 3
BAKES = 2  # light-grid bakes timed on the host clock
SWEEP = (1, 4, 8, 12, 16, 20, 24, 28, 33)  # 33: never lane by lane


def _cluster_check():
    """tools/cluster_check.py of this file's tree, loaded by its path."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cluster_check.py")
    spec = importlib.util.spec_from_file_location("cluster_check", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def queued_ms(fn, batches: int = BATCHES) -> list:
    from pim_tpu_torch.tools.gather_variants import queued_ms as one

    return sorted(one(fn) for _ in range(batches))


def main(argv=None) -> None:
    from pim_tpu_torch.app import build_e1m1_scene
    from pim_tpu_torch.render import cluster as CL
    from pim_tpu_torch.render.scene import bake_light_grid

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true", help="time every LANE_LOOP_MIN of SWEEP")
    ap.add_argument("--out", default=None, help="JSON file for every number")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("cluster_variants: no CUDA device is available")
    cc = _cluster_check()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, CL.__file__)
    t0 = time.perf_counter()
    scene = build_e1m1_scene(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bake_s = []
    for _ in range(BAKES):
        t0 = time.perf_counter()
        bake_light_grid(scene[0], scene[1])
        torch.cuda.synchronize()
        bake_s.append(time.perf_counter() - t0)
    print(f"e1m1 build {build_s:.3f} s; light-grid bake again {bake_s} s")
    result = {"device": smi, "build_s": build_s, "bake_s": bake_s, "waves": {}}
    cl = CL.ClusterArrays(tris=scene[1].cl_tris, clb=scene[1].cl_clb, scb=scene[1].cl_scb)
    waves = cc.main_path_wavefronts(scene)
    with cc.recorded_calls() as calls:
        bake_light_grid(scene[0], scene[1])
    waves["bake"] = calls["anyhit"][0]
    for name, rays in waves.items():
        anyhit = name in ("shadow", "bake")
        wrap = CL.cluster_anyhit if anyhit else CL.cluster_isect
        got, same, _ = cc.against_plain(cl, rays, anyhit, CHECK_LANES)
        ms = queued_ms(lambda: wrap(cl, *rays))
        row = {"n": rays[0].x.shape[0], "plain_equal": same, "ms": statistics.median(ms),
               "ms_range": [ms[0], ms[-1]]}
        print(f"{name} ({'K5' if anyhit else 'K4'}, {row['n']} rays): wrapper bitwise equal to "
              f"plain on {CHECK_LANES} lanes: {same}; {row['ms']:.4f} ms device "
              f"[{ms[0]:.4f}, {ms[-1]:.4f}]")
        if not same:
            raise AssertionError(f"{name}: the wrapper differs from the plain version")
        if args.sweep:
            row["sweep"] = {}
            for k in SWEEP:
                run = cc.launcher(anyhit, cl, *rays, k)
                eq = cc.same_bits(run(), got)
                ms = queued_ms(run)
                row["sweep"][k] = {"equal": eq, "ms": statistics.median(ms),
                                   "ms_range": [ms[0], ms[-1]]}
                print(f"  lane_loop_min {k:2d}: bitwise equal {eq}; {statistics.median(ms):.4f} "
                      f"ms [{ms[0]:.4f}, {ms[-1]:.4f}]")
                if not eq:
                    raise AssertionError(f"{name}: lane_loop_min {k} differs from the wrapper")
        result["waves"][name] = row
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
