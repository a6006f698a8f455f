"""Host-side scene pipeline of the port (numpy): entities and their
world-space flattening, meshes, materials and the texture pool, the Cornell
box and the glTF import.  The entity, mesh and material modules are the
port's own copies of the JAX package's jax-free host modules.
"""
