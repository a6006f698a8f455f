"""Math library of the port: SoA vectors, sampling, grid, dist1d, BRDF."""
