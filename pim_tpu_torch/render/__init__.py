"""Rendering pipeline of the port: kernels, scene, camera, shading,
lights and the wavefront integrator (dense Cornell path)."""
