"""pim_tpu_torch runs with JAX unavailable.

The check runs in a subprocess whose `sys.modules["jax"]` and
`sys.modules["ml_dtypes"]` are None, so any import of either (direct or
through another module) raises there.  Of the JAX package, only the
jax-free host modules `pim_tpu.geom.{entities,material,mesh}` (and the
packages and `core.guid` they pull in) may be imported."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_MODULES = {"pim_tpu.geom.entities", "pim_tpu.geom.material", "pim_tpu.geom.mesh"}

_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["ml_dtypes"] = None
import torch
torch.set_num_threads(2)
import pim_tpu_torch
from pim_tpu_torch import app, native
from pim_tpu_torch.core import rng
from pim_tpu_torch.geom import cornell, material
from pim_tpu_torch.math import brdf, dist1d, geometry, grid, sampling, vec3
from pim_tpu_torch.render import (bsdf, camera, dense_kernels, fetch, gather_kernel,
                                  integrator, lights, scene, surface)
from pim_tpu_torch.tools import prof_frame
sc = app.build_cornell_scene("cpu")
fr = app.render_frame(sc, 8, 8, 2, 1, 1)
assert fr.buffers.color.shape == (64, 3) and bool(torch.isfinite(fr.buffers.color).all())
assert fr.rays > 0
allowed = {"pim_tpu", "pim_tpu.core", "pim_tpu.core.guid", "pim_tpu.geom",
           "pim_tpu.geom.entities", "pim_tpu.geom.material", "pim_tpu.geom.mesh"}
bad = sorted(m for m in sys.modules
             if m.startswith("jax.") or m.startswith("ml_dtypes.")
             or (m == "pim_tpu" or m.startswith("pim_tpu.")) and m not in allowed)
assert not bad, bad
print("NOJAX_OK", fr.mean)
"""


def test_port_imports_and_renders_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NOJAX_OK" in res.stdout


def _imported_modules(path):
    """Every module an `import` statement of the file names (at any depth)."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module in ("pim_tpu", "pim_tpu.geom"):  # names are modules
                yield from (f"{node.module}.{a.name}" for a in node.names)
            else:
                yield node.module


def test_no_jax_or_other_pim_tpu_import_in_sources():
    pkg = os.path.join(ROOT, "pim_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    offenders = [(os.path.relpath(path, ROOT), mod)
                 for path in files for mod in _imported_modules(path)
                 if mod.split(".")[0] in ("jax", "ml_dtypes", "pim_tpu")
                 and mod not in HOST_MODULES]
    assert not offenders, offenders
