"""Nothing the benchmark runs imports JAX or the JAX package, and nothing
under reference/ imports the port.  Top-level module names are compared
whole: `pim_tpu_torch` begins with `pim_tpu` and is not it."""

import ast
import importlib
import os
import subprocess
import sys

import pytest

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
FORBIDDEN = {"jax", "jaxlib", "flax", "pim_tpu"}


def _imported_tops(path: str):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(top: str):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources(PKG):
        bad = set(_imported_tops(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(PKG, "reference")):
        assert "pim_tpu_torch" not in set(_imported_tops(path)), path


def test_loaded_modules_of_a_run_and_of_the_reference():
    """The modules a run loads (harness, drivers, readers, the port) and,
    in a process of its own, those the reference loads."""
    code = """
import sys
import pimbench.run, pimbench.faults, pimbench.hooks, pimbench.trace, pimbench.syncwatch
import pimbench.drivers.render, pimbench.drivers.train, pimbench.drivers.bake
for m in ('kernels_per_step', 'shading_ms_per_step', 'isect_roofline', 'gather_roofline',
          'device_idle_share', 'scene_build_s'):
    __import__('pimbench.metrics.' + m)
import pim_tpu_torch.render.render_system, pim_tpu_torch.render.diff, pim_tpu_torch.render.lightmap
print(sorted({m.split('.')[0] for m in sys.modules}))
"""
    ref = """
import sys
import pimbench.reference.render, pimbench.reference.train, pimbench.reference.bake
import pimbench.reference.frozen.render.diff, pimbench.reference.frozen.render.lightmap
print(sorted({m.split('.')[0] for m in sys.modules}))
"""
    for src, also in ((code, set()), (ref, {"pim_tpu_torch"})):
        out = subprocess.run([sys.executable, "-c", src], cwd=REPO, capture_output=True,
                             text=True, check=True).stdout
        tops = set(eval(out.strip().splitlines()[-1]))
        assert not tops & (FORBIDDEN | also), tops & (FORBIDDEN | also)


def test_the_run_refuses_a_process_that_loaded_jax(monkeypatch):
    from pimbench import run

    monkeypatch.setitem(sys.modules, "jax", sys)
    monkeypatch.setitem(sys.modules, "pim_tpu.render", sys)
    assert run.forbidden_modules() == ["jax", "pim_tpu"]
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.delitem(sys.modules, "pim_tpu.render")
    monkeypatch.setitem(sys.modules, "pim_tpu_torch_like", sys)
    assert run.forbidden_modules() == []


def test_a_module_loaded_by_the_check_withholds_the_result(root, capsys, monkeypatch):
    """JAX loaded while the reference checks the run (after the window)
    still stops the result line."""
    import types

    from pimbench.drivers import render
    from pimbench.tests.conftest import run_cell

    check = render.Render.check

    def check_loading_jax(self, *a, **k):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return check(self, *a, **k)

    monkeypatch.setattr(render.Render, "check", check_loading_jax)
    rc, line, err = run_cell(root, "cornell-render", capsys, "--trace", "0")
    assert rc != 0 and line is None
    assert "['jax']" in err


FROZEN_MODULES = sorted(
    os.path.relpath(p, REPO)[:-3].replace(os.sep, ".")
    for p in _sources(os.path.join(PKG, "reference", "frozen")))


@pytest.mark.parametrize("module", FROZEN_MODULES)
def test_every_frozen_module_imports(module):
    """Each module of the frozen copy imports (a dangling import, such as one
    of a module the copy left out, fails here)."""
    importlib.import_module(module)
