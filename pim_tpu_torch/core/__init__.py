"""Core runtime pieces of the port (today: the per-ray RNG)."""
