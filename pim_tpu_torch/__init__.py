"""pim_tpu_torch — the PyTorch + CUDA port of the `pim_tpu` path tracer.

The JAX package `pim_tpu` is the reference; this package mirrors its module
layout and function names so each counterpart is easy to find.  It imports
`torch` and numpy, and never `jax`.  Of the JAX package it imports only the
jax-free host modules `pim_tpu.geom.{entities,material,mesh}` (entities,
meshes, materials, world-space flattening).

Slice 1 (this package today) is the Cornell frame on the dense intersector:
  core/rng.py          counter-based per-ray RNG (bit-exact with pim_tpu)
  math/                vec3, sampling, grid, dist1d, brdf, geometry
  geom/                cornell, the texture pool (host numpy)
  render/              dense_kernels (K1/K2), gather_kernel (K3), fetch,
                       scene, camera, surface, bsdf, lights, integrator
  native.py            nvcc build + ctypes binding of csrc/*.cu
  app.py               the frame entry point (python -m pim_tpu_torch.app)
  tools/prof_frame.py  where one step's time goes on the card (torch.profiler)

Every kernel has a plain PyTorch version beside it.  A wrapper runs the
plain version only for tensors on the CPU; for CUDA tensors it launches the
hand-written kernel or raises.
"""

__version__ = "0.1.0"
