"""The absolute anchor of the port's e1m1 gate (`e1m1_128` in
pim_tpu_torch/render/gate_bands.json).

The JAX package renders the e1m1 bench frame on the CPU with
`build_scene(backend="auto")`, which is the `bvh` intersector there: 128^2,
10 bounces, 16 spp, for each of three seeds (sample ids seed * 4096 + s).
The band is the mean of the three seed means +- max(1%, 6 sigma), sigma
being the standard error of that mean.  `chip_smoke.py` renders the same
frame through the port on the card and fails outside the band.

    python -c "import tests.test_torch_e1m1_anchor as a; a.print_band()"

prints the band from a fresh render (about 10 minutes on 8 CPU cores).
The slow test renders it again and holds each seed mean to the committed
one at rtol 1e-4 (XLA:CPU versions may order a few sums differently).
"""

import json
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANDS = os.path.join(ROOT, "pim_tpu_torch", "render", "gate_bands.json")
RES = 128
BOUNCES = 10
SPP = 16
SEEDS = (1, 2, 3)


def anchor_means():
    """The three seed means of the JAX CPU render of the e1m1 frame."""
    import jax
    import jax.numpy as jnp

    from pim_tpu.core import rng
    from pim_tpu.geom.gltf import load_gltf_scene
    from pim_tpu.render.camera import Camera, DofInfo, camera_arrays, generate_primary_rays
    from pim_tpu.render.integrator import trace_rays
    from pim_tpu.render.scene import build_scene
    from pim_tpu.render.sky import bake_sky_cubemap, earth_atmosphere

    ents, pool = load_gltf_scene(os.path.join(ROOT, "data", "e1m1", "glTF", "e1m1.gltf"))
    sun_dir = np.array([0.35, 0.82, 0.45], np.float32)
    sun_dir /= np.linalg.norm(sun_dir)
    sky = np.asarray(bake_sky_cubemap(earth_atmosphere(), sun_dir, 3800.0, 32, 8))
    meta, arrays, lights = build_scene(ents, pool, backend="auto", sky=sky)
    assert meta.backend == "bvh", meta.backend
    cam = Camera(position=np.array([-2.5, 1.7, -2.5], np.float32))
    cam.look_at([6.0, 1.0, 6.0])
    ca = camera_arrays(cam, DofInfo(autofocus=False), RES, RES)
    n = RES * RES

    @jax.jit
    def step(sample_idx):
        state = rng.make_state(jnp.arange(n, dtype=jnp.uint32), sample_idx)
        state, ro, rd = generate_primary_rays(ca, RES, RES, state)
        return trace_rays(meta, arrays, lights, ro, rd, state, BOUNCES).color

    means = []
    for seed in SEEDS:
        acc = sum(np.asarray(step(jnp.uint32(seed * 4096 + s)), np.float64)
                  for s in range(SPP))
        means.append(float(np.mean(acc)) / SPP)
    return means


def band_from_means(means):
    m = np.asarray(means, np.float64)
    center = float(m.mean())
    sigma = float(m.std(ddof=1) / np.sqrt(len(m)))
    return {
        "kind": "absolute(cpu-framework anchor)",
        "source": "pim_tpu build_scene(backend='auto') = bvh on the CPU, "
                  "tests/test_torch_e1m1_anchor.py",
        "res": RES, "bounces": BOUNCES, "spp": SPP, "seeds": list(SEEDS),
        "seed_means": [float(x) for x in m],
        "mean": center, "half": max(0.01 * center, 6.0 * sigma), "seed_sigma": sigma,
    }


def print_band():
    print(json.dumps({"e1m1_128": band_from_means(anchor_means())}, indent=1))


@pytest.mark.slow
def test_e1m1_anchor_matches_committed_band():
    with open(BANDS) as f:
        band = json.load(f)["e1m1_128"]
    means = anchor_means()
    np.testing.assert_allclose(means, band["seed_means"], rtol=1e-4)
    fresh = band_from_means(means)
    assert abs(fresh["mean"] - band["mean"]) <= 1e-4 * band["mean"]
