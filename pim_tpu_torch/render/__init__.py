"""Rendering pipeline of the port: kernels, scene, camera, shading,
lights, sky, exposure and the wavefront integrator."""
