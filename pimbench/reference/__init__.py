"""The plain reference that decides `correct`.

`frozen/` is a frozen copy of the port's plain PyTorch path (its modules
as of the benchmark's first version, every kernel wrapper reduced to its
plain version, the BVH built by numpy): it imports nothing of the port.
The modules beside it build the configuration's scene again from the same
raw inputs, re-run what the check samples, and compare.  `compare.py`
holds the comparisons."""
