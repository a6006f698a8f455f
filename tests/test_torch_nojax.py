"""pim_tpu_torch runs with JAX unavailable.

The check runs in a subprocess whose `sys.modules["jax"]` and
`sys.modules["ml_dtypes"]` are None, so any import of either (direct or
through another module) raises there.  No module of the JAX package may be
imported at all: the port keeps its own copies of the host modules it needs
(entities, meshes, materials, the glTF helpers, the cvar registry) and of
the gate bands.  The port loads the e1m1 glTF there too, so its texture
pool needs no `ml_dtypes`, the Cornell frame renders through each
backend (the MT ones build their BVH with the C++ builder), its engine
shell runs a media pt_test and the
bakes (lm_gen, r_refl_gen, probe_bake, probe_report, a checkpoint), the
scale-out layer (parallel/, tools/scaling_worker.py) runs a one-rank
`dryrun_multichip`, and the measurement modules (bench.py, tools/perf_table,
ab_sort, bench_cluster, scaling_bench, overlap_ab, corr_check,
grad_eps_sweep, and devtime, their shared device timer) import."""

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["ml_dtypes"] = None
import torch
torch.set_num_threads(2)
import pim_tpu_torch
from pim_tpu_torch import app, bench, native
from pim_tpu_torch.core import cmd, console, crate, cvar, cvars, guid, profiler, rng, timesys
from pim_tpu_torch.geom import bvh, cornell, entities, gltf, maps, material, mesh
from pim_tpu_torch.math import (brdf, color, cubic_fit, dist1d, geometry, grid, noise, sampling,
                                sh, sphgauss, vec3)
from pim_tpu_torch.render import (bsdf, camera, cluster, cubemap, dense_kernels, denoise,
                                  exposure, fetch, gather_kernel, diff, integrator, intersect,
                                  lightmap,
                                  lights, media, probes, raysort, render_system, scene,
                                  screenshot, sky, surface, table_gather)
from pim_tpu_torch.parallel import dist, dryrun, shard
from pim_tpu_torch.tools import (ab_sort, bake_e1m1_lightmap, bench_cluster, corr_check,
                                 devtime, grad_eps_sweep, mt_check, overlap_ab, perf_table,
                                 prof_frame, scaling_bench, scaling_worker, vml_first_call)
sc = app.build_cornell_scene("cpu")
fr = app.render_frame(sc, "cornell", 8, 8, 2, 1, 1)
assert fr.buffers.color.shape == (64, 3) and bool(torch.isfinite(fr.buffers.color).all())
assert fr.rays > 0
for backend in ("brute", "bvh"):  # the MT backends, the C++ BVH builder
    fr = app.render_frame(app.build_cornell_scene("cpu", backend), "cornell", 8, 8, 2, 1, 1)
    assert bool(torch.isfinite(fr.buffers.color).all()) and fr.mean > 0
dryrun.dryrun_multichip(1, "cpu")
ents, pool = gltf.load_gltf_scene(app.E1M1_GLTF)
atlas, rec = pool.pack()
assert atlas.shape == (128, 256, 4) and rec.shape == (71, 4) and ents.count > 0
assert exposure.ExposureParams.from_cvars().max_cdf > 0
import os, tempfile
os.chdir(tempfile.mkdtemp())
eng = app.Engine(width=8, height=8, device="cpu")
eng.init()
assert eng.run("pt_max_bounces 2; pt_media 1; pt_test -frames 2 -nogate") == 0
assert eng.render.meta.media_enabled and len(os.listdir("screenshots")) == 3
cubemap.get_registry().add("default", 4, device="cpu")
eng = app.Engine(width=8, height=8, device="cpu")
eng.init()
assert eng.run("cornell_box; pt_max_bounces 2; pt_media 0; lm_density 0.5; lm_gen 1; "
               "r_refl_gen 1; pt_trace 1; wait 1; probe_bake -samples 64; probe_report; "
               "ckpt_save nojax; quit") == 0
assert int((eng.render.lm_pack.sample_counts > 1).sum()) > 0 and "camera" in eng.render.probes
bad = sorted(m for m in sys.modules
             if m.startswith("jax.") or m.startswith("ml_dtypes.")
             or m == "pim_tpu" or m.startswith("pim_tpu."))
assert not bad, bad
print("NOJAX_OK", fr.mean)
"""


def test_port_imports_and_renders_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NOJAX_OK" in res.stdout


_DYNAMIC_IMPORTS = ("import_module", "__import__")


def _dynamic_import_target(call):
    """The module a call of `importlib.import_module` or `__import__` names:
    its first argument when that is a string literal, else "<computed>" (a
    name built at run time could be any package, so it is refused too)."""
    func = call.func
    name = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", None)
    if name not in _DYNAMIC_IMPORTS or not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    return "<computed>"


def _imported_modules(path):
    """Every module an `import` statement or a dynamic import call of the
    file names (at any depth)."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module in ("pim_tpu", "pim_tpu.geom", "pim_tpu.core"):  # names are modules
                yield from (f"{node.module}.{a.name}" for a in node.names)
            else:
                yield node.module
        elif isinstance(node, ast.Call):
            target = _dynamic_import_target(node)
            if target is not None:
                yield target


def test_no_jax_or_other_pim_tpu_import_in_sources():
    pkg = os.path.join(ROOT, "pim_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    offenders = [(os.path.relpath(path, ROOT), mod)
                 for path in files for mod in _imported_modules(path)
                 if mod.split(".")[0] in ("jax", "ml_dtypes", "pim_tpu", "<computed>")]
    assert not offenders, offenders


def test_the_source_scan_sees_dynamic_imports(tmp_path):
    """The scan above also reads `importlib.import_module` and `__import__`
    calls, so a module cannot reach the JAX package by a name in a string."""
    src = tmp_path / "probe.py"
    src.write_text("import importlib\n"
                   "PKG = 'pim_tpu'\n"
                   "a = importlib.import_module('jax.numpy')\n"
                   "b = importlib.import_module(f'{PKG}.render.render_system')\n"
                   "c = __import__('pim_tpu.core.cvars')\n"
                   "d = importlib.import_module('json')\n")
    assert list(_imported_modules(str(src))) == [
        "importlib", "jax.numpy", "<computed>", "pim_tpu.core.cvars", "json"]


def test_gate_bands_are_the_reference_bands():
    """The port's copies of the JAX package's bench bands equal them, key by
    key, so the two files cannot drift apart."""
    with open(os.path.join(ROOT, "pim_tpu", "render", "bench_gate_bands.json")) as fh:
        ref = json.load(fh)
    with open(os.path.join(ROOT, "pim_tpu_torch", "render", "gate_bands.json")) as fh:
        own = json.load(fh)
    for name in ("cornell512", "e1m1_512"):
        copy = {k: v for k, v in own[name].items() if k != "copied_from"}
        assert copy == ref[name], name
        assert "pim_tpu/render/bench_gate_bands.json" in own[name]["copied_from"]
