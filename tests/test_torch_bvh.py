"""The port's BVH builders against the JAX package's, bit for bit.

`geom.bvh.build_bvh_numpy` against `pim_tpu.geom.bvh.build_bvh_numpy`, and
the port's C++ builder (csrc/bvh_builder.cpp through
`native.build_bvh_native`) against `pim_tpu.native.build_bvh_native`, on
this host (both compiled with g++ -O3 -march=native, so the trees are the
same code's on the same CPU): the soups of tests/test_native_bvh.py (1, 2,
5, 33, 500 and 2,000 random triangles, 64 identical ones, the empty scene)
and the Cornell "boxes" and "spheres" soups.  `validate_bvh` holds each
tree and returns its depth (boxes 11, spheres 21).  The two builders' trees
differ (their partitions order triangles differently) but have the same
node count.  A tree deeper than the walk's stack is refused, a failed
compile raises, and processes that build the library at once share one
build."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from pim_tpu import native as jnative
from pim_tpu.geom import bvh as jbvh
from pim_tpu.geom.cornell import build_cornell_box as jax_cornell
from pim_tpu.geom.entities import flatten
from pim_tpu_torch import native
from pim_tpu_torch.geom import bvh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _soup(n_tris: int, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = rng.uniform(-4, 4, (n_tris, 1, 3)).astype(np.float32)
    offs = rng.uniform(-0.4, 0.4, (n_tris, 3, 3)).astype(np.float32)
    return (base + offs).reshape(-1, 3)


def _positions(name: str) -> np.ndarray:
    if name == "identical64":
        return np.tile(_soup(1), (64, 1))
    if name == "empty":
        return np.zeros((0, 3), np.float32)
    if name in ("boxes", "spheres"):
        return flatten(jax_cornell(name)[0]).positions
    n = int(name)
    return _soup(n, seed=5 if n == 2000 else n)


SOUPS = ("1", "2", "5", "33", "500", "2000", "identical64", "empty", "boxes", "spheres")
DEPTHS = {"boxes": 11, "spheres": 21}


def _jax_native():
    """The JAX package's native builder library.  Its loader compiles into
    its own source directory with a thread lock only (ROADMAP F9), so a
    process that raced another worker's compile retries the load."""
    for _ in range(5):
        if jnative.load() is not None:
            return
        jnative._load_failed = False
        time.sleep(1.0)
    raise AssertionError("pim_tpu.native.load() kept failing")


def _assert_same(got: bvh.BvhArrays, want):
    for name, a, b in zip(bvh.BvhArrays._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("name", SOUPS)
def test_numpy_builder_matches_reference(name):
    pos = _positions(name)
    got = bvh.build_bvh_numpy(pos)
    _assert_same(got, jbvh.build_bvh_numpy(pos))
    depth = bvh.validate_bvh(got, pos)
    assert depth == DEPTHS.get(name, depth) and 1 <= depth <= bvh.STACK_DEPTH


@pytest.mark.parametrize("name", SOUPS)
def test_native_builder_matches_reference(name):
    _jax_native()
    pos = _positions(name)
    got = native.build_bvh_native(pos)
    _assert_same(got, jnative.build_bvh_native(pos))
    depth = bvh.validate_bvh(got, pos)
    assert depth == DEPTHS.get(name, depth)
    assert len(got.node_a) == len(bvh.build_bvh_numpy(pos).node_a)


def test_build_bvh_prefers_the_native_builder():
    pos = _positions("500")
    _assert_same(bvh.build_bvh(pos), native.build_bvh_native(pos))
    _assert_same(bvh.build_bvh(pos, prefer_native=False), bvh.build_bvh_numpy(pos))
    _assert_same(bvh.build_bvh(pos, max_leaf=2), native.build_bvh_native(pos, 2))


def test_build_bvh_refuses_a_tree_deeper_than_the_stack(monkeypatch):
    pos = _positions("spheres")
    monkeypatch.setattr(bvh, "STACK_DEPTH", 20)
    for prefer_native in (True, False):
        with pytest.raises(ValueError, match="depth 21"):
            bvh.build_bvh(pos, prefer_native=prefer_native)


def test_a_failed_compile_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ("-fno-such-flag",))
    monkeypatch.setattr(native, "_bvh_lib", None)
    with pytest.raises(RuntimeError, match="g..? failed"):
        bvh.build_bvh(_positions("5"))


_BUILD = """
import sys
from pim_tpu_torch import native
native.BUILD_ROOT = sys.argv[1]
print(native.build_bvh_builder())
print(len(native.build_bvh_native([[0, 0, 0], [1, 0, 0], [0, 1, 0]]).node_a))
"""


def test_processes_building_at_once_share_one_build(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in outs]
    assert len({o.split()[0] for o, _ in outs}) == 1 and all(o.split()[1] == "1" for o, _ in outs)
    (build,) = os.listdir(tmp_path)
    assert sorted(os.listdir(tmp_path / build)) == [".lock", native.BVH_LIB_NAME]
