"""Derive the PyTorch port's Cornell lightmap band
(pim_tpu_torch/render/bake_bands.json) from the JAX package on the CPU.

It packs Cornell "boxes" at 4 texels/m (the shell's `lm_density` default:
a 256^2 atlas) and runs `pim_tpu.render.lightmap.bake_step` over the whole
atlas, 10 bounces (the shell's `pt_max_bounces` default), for 64 passes,
three times: from bake frame 0, 64 and 128.  The bake keys its RNG by
(texel, frame), so the three runs are independent samples.  Each run's
number is the mean of `lightmap_irradiance` over the live texels and the
three channels.  The band pools them:

  mean = the mean of the runs' means
  half = max(1% of mean, 6 * sigma), sigma = the runs' sample standard
         deviation (the spread of one run, which is what a check of one
         bake is held to)

chip_smoke.py bakes 64 passes on the card through the port's shell
(`lm_gen 1`) and requires its mean inside [mean - half, mean + half].  The
tool lives outside pim_tpu_torch/ because it imports pim_tpu, which no
module of the port may do.  About 3 minutes on an 8-core CPU:

    python tools/calibrate_torch_bake_band.py
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

jax.config.update("jax_platforms", "cpu")  # the band is a CPU run, whatever the host has

from pim_tpu.geom.cornell import build_cornell_box  # noqa: E402
from pim_tpu.geom.entities import flatten  # noqa: E402
from pim_tpu.render import lightmap as lm  # noqa: E402
from pim_tpu.render.scene import build_scene  # noqa: E402

BANDS_PATH = os.path.join(ROOT, "pim_tpu_torch", "render", "bake_bands.json")
DENSITY = 4.0
BOUNCES = 10
PASSES = 64
STARTS = (0, 64, 128)
REL = 0.01
SIGMAS = 6.0


def pool_band(means) -> dict:
    """{"mean", "half", "sigma"} of the runs' means (see the module doc)."""
    m = np.asarray(means, np.float64)
    center = float(m.mean())
    sigma = float(m.std(ddof=1))
    return {"mean": center, "half": max(REL * center, SIGMAS * sigma), "sigma": sigma}


def live_mean_irradiance(pack) -> float:
    """The mean of lightmap_irradiance over the live texels and channels."""
    irr = np.asarray(lm.lightmap_irradiance(pack, pack.normal.T), np.float64)
    live = np.asarray(pack.sample_counts) > 0
    return float(irr[live].mean())


def run(start: int, passes: int = PASSES, bounces: int = BOUNCES, density: float = DENSITY):
    """The live-texel mean irradiance after `passes` bake passes of the
    whole Cornell atlas, from bake frame `start`."""
    ents, pool = build_cornell_box("boxes")
    meta, arrays, lights = build_scene(ents, pool)
    flat = flatten(ents)
    pack = lm.pack_lightmaps(flat.positions, flat.normals, texels_per_meter=density)
    size = int(pack.size)  # bake_step returns the pack's fields as arrays
    for frame in range(start, start + passes):
        pack = lm.bake_step(meta, arrays, lights, pack, frame, max_bounces=bounces)
    jax.block_until_ready(pack.probes)
    return live_mean_irradiance(pack), meta.backend, size, int((pack.sample_counts > 0).sum())


def calibrate(starts=STARTS, passes: int = PASSES) -> dict:
    runs = []
    for start in starts:
        t0 = time.perf_counter()
        mean, backend, size, live = run(start, passes)
        runs.append({"start_frame": start, "mean": mean})
        print(f"run from frame {start}: mean irradiance {mean:.6f} over {live} live texels "
              f"of a {size}^2 atlas ({time.perf_counter() - t0:.1f} s, backend {backend})",
              flush=True)
    band = pool_band([r["mean"] for r in runs])
    return {
        "cornell_lightmap": {
            **band,
            "metric": "mean of lightmap_irradiance over live texels and channels",
            "scene": "cornell_box boxes", "texels_per_meter": DENSITY, "atlas": size,
            "live_texels": live, "bounces": BOUNCES, "passes": passes,
            "device": "cpu", "package": "pim_tpu", "backend": backend,
            "runs": runs,
            "derivation": (f"tools/calibrate_torch_bake_band.py: mean of the runs' means "
                           f"+- max({REL:.0%}, {SIGMAS:g} x their sample std)"),
        }
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=BANDS_PATH)
    args = ap.parse_args(argv)
    data = calibrate()
    with open(args.out, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}: {json.dumps({k: data['cornell_lightmap'][k] for k in ('mean', 'half')})}")


if __name__ == "__main__":
    main()
