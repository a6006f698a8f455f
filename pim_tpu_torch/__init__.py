"""pim_tpu_torch — the PyTorch + CUDA port of the `pim_tpu` path tracer.

The JAX package `pim_tpu` is the reference; this package mirrors its module
layout and function names so each counterpart is easy to find.  It imports
`torch` and numpy, never `jax`, and nothing of the JAX package: the host
modules it shares with it (entities, meshes, materials, the glTF helpers,
the cvar registry) are its own copies.

It renders the reference bench's two frames: the Cornell box on the dense
intersector and the e1m1 map on the cluster intersector, with atlas
textures, normal maps, glass, the sky and auto-exposure, and trains through
them (render/diff.py):
  core/                rng (counter-based per-ray RNG, bit-exact with
                       pim_tpu), the cvar registry, name hashing
  math/                vec3, sampling, grid, dist1d, brdf, geometry, color
  geom/                entities, meshes, materials and the texture pool,
                       cornell, glTF import (host numpy)
  render/              dense_kernels (K1/K2), cluster (K4/K5), gather_kernel
                       (K3 and its backward), table_gather (K6, K7 and K7's
                       backward), raysort, fetch, scene, camera, surface,
                       sky, bsdf, lights, integrator, exposure, diff
  native.py            nvcc build + ctypes binding of csrc/*.cu
  app.py               the frame entry point (python -m pim_tpu_torch.app)
  tools/perf_table.py  where one step's time goes on the card (torch.profiler)
  tools/vml_first_call.py  how often a first CPU vector-math call goes wrong

Its numbers come from the benchmark, `python3 -m pimbench.run --workload
<cell> --seconds 45 --trace <0|1>`; a profile of one step from `python -m
pim_tpu_torch.tools.perf_table`.

Every kernel has a plain PyTorch version beside it.  A wrapper runs the
plain version only for tensors on the CPU; for CUDA tensors it launches the
hand-written kernel or raises.
"""

import torch

__version__ = "0.1.0"

# Torch's CPU build computes float sqrt, exp, log and the like through MKL's
# vector math library (VML), which sets itself up on its first call.  When
# that first call is split across torch's intra-op threads (more than 2048
# elements on two or more threads), the share of a thread other than the
# caller can come out of a low-accuracy kernel, with relative errors up to
# ~3e-4 (tools/vml_first_call.py counts how often).  One call on a single
# element runs on the calling thread alone and sets VML up before any split
# call, so the plain CPU path gives the same values in every process.
torch.sqrt(torch.ones(1))
