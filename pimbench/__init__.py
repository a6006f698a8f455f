"""The benchmark of the PyTorch and CUDA port (`pim_tpu_torch`) on an NVIDIA GPU.

    python3 -m pimbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of `BENCHMARK.json` names a configuration (`configs/<name>.json`: a
scene, its camera, resolution and bounces) and a traffic mix
(`traffic/<name>.json`: the parameters that `drivers/<driver>.py` reads).
A per-layer metric `<base>.<kind>` is read by `metrics/<base>.py` from the
traced window.  The harness finds each of these files by name, so a later
change adds a cell, a scene, a mix or a metric by adding files and entries.

The plain reference that decides `correct` lives under `reference/`: a
frozen copy of the port's plain PyTorch path (`reference/frozen/`, every
kernel replaced by its plain version) driven by `reference/*.py`.  Nothing
here imports JAX or the JAX package, and nothing under `reference/` imports
the port.
"""
