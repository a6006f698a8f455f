"""pim_tpu_torch — the PyTorch + CUDA port of the `pim_tpu` path tracer.

The JAX package `pim_tpu` is the reference; this package mirrors its module
layout and function names so each counterpart is easy to find.  It imports
`torch` and numpy, and never `jax`.  Of the JAX package it imports only the
jax-free host modules `pim_tpu.geom.{entities,material,mesh,gltf}` (entities,
meshes, materials, world-space flattening, glTF parsing helpers) and
`pim_tpu.core.{cvar,cvars}` (the settings registry).

It renders the reference bench's two frames: the Cornell box on the dense
intersector and the e1m1 map on the cluster intersector, with atlas
textures, normal maps, glass, the sky and auto-exposure:
  core/rng.py          counter-based per-ray RNG (bit-exact with pim_tpu)
  math/                vec3, sampling, grid, dist1d, brdf, geometry, color
  geom/                cornell, glTF import, the texture pool (host numpy)
  render/              dense_kernels (K1/K2), cluster (K4/K5), gather_kernel
                       (K3), table_gather (K6), raysort, fetch, scene, camera,
                       surface, sky, bsdf, lights, integrator, exposure
  native.py            nvcc build + ctypes binding of csrc/*.cu
  app.py               the frame entry point (python -m pim_tpu_torch.app)
  tools/prof_frame.py  where one step's time goes on the card (torch.profiler)

Every kernel has a plain PyTorch version beside it.  A wrapper runs the
plain version only for tensors on the CPU; for CUDA tensors it launches the
hand-written kernel or raises.
"""

__version__ = "0.1.0"
