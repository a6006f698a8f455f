"""Calibrate the PyTorch port's pt_gate bands (pim_tpu_torch/render/pt_gate_bands.json).

A mirror of tools/calibrate_pt_gate.py with the same pooling, writing the
port's own band file.  It renders a gated scene through the JAX package's
`RenderSystem` on the CPU for each seed at each resolution and snapshots the
luminance stddev and the buffer mean at every sample-count tier.  The band
of a tier pools every (seed, resolution) run:

  maxstddev = max(sd)   * (1 + rel) + 6*sigma(sd)
  meanlo    = min(mean) * (1 - rel) - 6*sigma(mean)
  meanhi    = max(mean) * (1 + rel) + 6*sigma(mean)

with rel = 2%.  The runs are the JAX package's: the reference the port is
held to.  The tool lives outside pim_tpu_torch/ because it imports pim_tpu,
which no module of the port may do; the port only reads the file it writes.

Scenes, as the shell's regression commands set them up:
  cornell -- pt_test's config (cornell_box boxes; teleport -4 0 4;
             lookat 0 -1 0; exp_manual 1; exp_evoffset 5)
  e1m1    -- scripts/pt_test_e1m1.cmd's (mapload e1m1 from data/e1m1/glTF,
             teleport -2.5 1.7 -2.5, lookat 6 1 6; the sky baked from the
             sun and atmosphere cvars)

    python tools/calibrate_torch_pt_gate.py --scene e1m1 \
        --res 128 --tiers 8,16 --seeds 3
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")  # the bands are CPU runs, whatever the host has

from pim_tpu.core import cvars as cv  # noqa: E402
from pim_tpu.geom.cornell import build_cornell_box  # noqa: E402
from pim_tpu.geom.gltf import load_gltf_scene  # noqa: E402
from pim_tpu.render.render_system import RenderSystem  # noqa: E402

REL = 0.02
BANDS_PATH = os.path.join(ROOT, "pim_tpu_torch", "render", "pt_gate_bands.json")
CAMERAS = {
    "cornell": ((-4.0, 0.0, 4.0), (0.0, -1.0, 0.0)),
    "e1m1": ((-2.5, 1.7, -2.5), (6.0, 1.0, 6.0)),
}


def default_seeds(count: int):
    return [0x9E3779B9] + [1000003 * (i + 1) for i in range(count - 1)]


def _setup_scene(rs, scene: str) -> None:
    if scene == "cornell":
        rs.entities, rs.pool = build_cornell_box("boxes")
    elif scene == "e1m1":
        path = os.path.join(ROOT, "data", "e1m1", "glTF", "e1m1.gltf")
        rs.entities, rs.pool = load_gltf_scene(path)
    else:
        raise SystemExit(f"unknown scene '{scene}'")
    eye, target = CAMERAS[scene]
    rs.camera.reset()
    rs.camera.position = np.asarray(eye, np.float32)
    rs.camera.look_at(list(target))


def run_seeds(scene: str, res: int, seeds, tiers):
    """[(seed, {tier: (stddev, mean)})] for every seed at one resolution,
    one progressive run per seed through the reference's RenderSystem."""
    cv.cv_pt_trace.set(True)
    cv.cv_exp_manual.set(True)
    cv.cv_exp_evoffset.set(5.0)
    cv.cv_pt_denoise.set(False)
    cv.cv_pt_media.set(False)
    # the bands are per sample: pt_spp > 1 draws a batch under the
    # batch-start light pdf, which would need bands of its own
    cv.cv_pt_spp.set(1)
    rs = RenderSystem(width=res, height=res)
    _setup_scene(rs, scene)
    top = max(tiers)
    results = []
    for seed in seeds:
        cv.cv_pt_seed.set(int(seed))
        out = {}
        t0 = time.perf_counter()
        # the first update notices the new seed and restarts the accumulation
        for frame in range(1, top + 1):
            rs.update()
            assert rs.sample_count == frame, (rs.sample_count, frame)
            if frame in tiers:
                out[frame] = (rs.stddev(), float(np.asarray(rs.buffers.color).mean()))
        print(f"{scene} res={res} seed={seed:#x}: {top} frames in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        results.append((seed, out))
    return results


def pool_band(scene: str, tier: int, runs) -> dict:
    sds = np.array([r["stddev"] for r in runs])
    means = np.array([r["mean"] for r in runs])
    return {
        "scene": scene,
        "min_samples": tier,
        "maxstddev": float(sds.max() * (1 + REL) + 6 * sds.std()),
        "meanlo": float(means.min() * (1 - REL) - 6 * means.std()),
        "meanhi": float(means.max() * (1 + REL) + 6 * means.std()),
    }


def calibrate(scene: str, resolutions, tiers, seeds):
    """(entries, calibration record) of one scene."""
    tiers = sorted(tiers)
    runs = {t: [] for t in tiers}
    for res in resolutions:
        for seed, snap in run_seeds(scene, res, seeds, set(tiers)):
            for t, (sd, mean) in snap.items():
                runs[t].append({"res": res, "seed": seed, "stddev": sd, "mean": mean})
                print(f"res={res} seed={seed:#x} n={t}: stddev={sd:.6f} mean={mean:.6f}",
                      flush=True)
    entries = [pool_band(scene, t, runs[t]) for t in tiers]
    record = {
        "device": "cpu",
        "package": "pim_tpu",
        "resolutions": list(resolutions),
        "seeds": [hex(s) for s in seeds],
        "rel_margin": REL,
        "runs": {str(t): runs[t] for t in tiers},
    }
    return entries, record


def merge(path: str, scene: str, entries, record) -> dict:
    """Replace `scene`'s entries and calibration record in the band file."""
    data = {"entries": [], "calibrations": {}}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    data["entries"] = [e for e in data.get("entries", []) if e.get("scene") != scene] + entries
    data.setdefault("calibrations", {})[scene] = record
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
    return data


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="cornell", choices=sorted(CAMERAS))
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--res", default="128")
    ap.add_argument("--tiers", default="8,16")
    ap.add_argument("--out", default=BANDS_PATH)
    args = ap.parse_args(argv)
    entries, record = calibrate(args.scene, [int(r) for r in args.res.split(",")],
                                [int(t) for t in args.tiers.split(",")],
                                default_seeds(args.seeds))
    merge(args.out, args.scene, entries, record)
    print(f"wrote {args.out}")
    for e in entries:
        print(e)


if __name__ == "__main__":
    main()
