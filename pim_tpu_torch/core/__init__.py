"""Core runtime pieces of the port: the per-ray RNG, the cvar registry and
name hashing."""
