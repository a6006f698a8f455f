"""Host-side scene pipeline of the port (numpy): the Cornell box and the
texture pool.

Entities, meshes, materials and world-space flattening are the JAX
package's own jax-free host modules, `pim_tpu.geom.{entities,material,
mesh}`, imported as they are.  `pim_tpu.geom.cornell` is not: it imports
`pim_tpu.render.camera`, which imports jax.
"""
