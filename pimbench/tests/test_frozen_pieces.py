"""The benchmark's frozen copies and its own arithmetic on small inputs:
the device attribution and idle gaps of a trace, the gather and ray bytes,
the sync watch, the reference's plain cluster walk."""

import json

import numpy as np
import pytest
import torch

from pimbench import hooks, trace
from pimbench.metrics import device_idle_share, gather_roofline, isect_roofline
from pimbench.metrics import kernels_per_step, shading_ms_per_step
from pimbench.metrics.peaks import HBM_BYTES_PER_S


def _ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def synthetic_trace(path):
    """A window [0, 100) us on the host: a bsdf kernel, an intersection
    kernel, a copy and a kernel the harness launches after the program
    returned, each under its own Python stack; idle from 40 to 70 us while
    the host is in lights.py."""
    events = [
        _ev(trace.WINDOW_SPAN, "user_annotation", 0, 100),
        _ev("pimbench/run.py(1): main", "python_function", 0, 100),
        _ev("pim_tpu_torch/render/integrator.py(9): trace_rays", "python_function", 1, 90),
        _ev("pim_tpu_torch/render/bsdf.py(5): scatter", "python_function", 2, 8),
        _ev("cudaLaunchKernel", "cuda_runtime", 3, 1, correlation=1),
        _ev("pim_tpu_torch/render/cluster.py(7): cluster_isect", "python_function", 12, 8),
        _ev("cudaLaunchKernel", "cuda_runtime", 13, 1, correlation=2),
        _ev("pim_tpu_torch/render/lights.py(3): sample", "python_function", 38, 40),
        _ev("cudaMemcpyAsync", "cuda_runtime", 80, 1, correlation=4),
        _ev("cudaLaunchKernel", "cuda_runtime", 95, 1, correlation=3),
        _ev("elementwise_kernel", "kernel", 5, 10, tid=7, correlation=1),
        _ev("cluster_isect_kernel", "kernel", 20, 20, tid=7, correlation=2),
        _ev("Memcpy DtoD", "gpu_memcpy", 70, 10, tid=7, correlation=4),
        _ev("harness_kernel", "kernel", 96, 2, tid=7, correlation=3),
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_attribution_busy_and_gaps(tmp_path):
    p = str(tmp_path / "t.json")
    synthetic_trace(p)
    t = trace.reduce(p, "render", 2)
    groups = {e.name: e.group for e in t.device}
    assert groups == {"elementwise_kernel": "shading", "cluster_isect_kernel": "isect",
                      "Memcpy DtoD": "loop", "harness_kernel": "harness"}
    # busy: [5, 15) + [20, 40) + [70, 80) + [96, 98) = 42 us of 100
    assert t.busy_s == pytest.approx(42e-6)
    assert t.window_s == pytest.approx(100e-6)
    assert device_idle_share.read(t, "render") == pytest.approx(58.0)
    assert shading_ms_per_step.read(t, "render") == pytest.approx(10e-3 / 2)
    assert kernels_per_step.read(t, "render") == pytest.approx(1.0)  # the harness's left out
    gaps = dict(t.breakdown()["idle_gaps"])
    assert gaps["pim_tpu_torch/render/lights.py(3): sample"] == pytest.approx(30e-6)
    assert sum(gaps.values()) == pytest.approx(58e-6)
    ops = dict(t.breakdown()["device_ops"])
    assert ops["cluster_isect_kernel"] == pytest.approx(20e-6)


def test_classify_priority_and_harness():
    assert trace.classify(("pim_tpu_torch/render/integrator.py(1): f",
                           "pim_tpu_torch/render/table_gather.py(2): g")) == "gather"
    assert trace.classify(("pimbench/drivers/render.py(3): step",)) == "harness"
    assert trace.classify(("pimbench/reference/frozen/render/bsdf.py(1): f",)) == "harness"
    assert trace.classify(()) == "other"


def test_union_of_overlapping_intervals():
    busy, gaps = trace.union_us([(0, 10), (5, 20), (30, 40), (35, 36)], 0, 50)
    assert busy == 30 and gaps == [(20, 30), (40, 50)]


def test_gather_bytes():
    table = torch.zeros((4, 10))
    idx = torch.tensor([0, 3, 3, -1, 10, 9], dtype=torch.int32)
    # 6 indices read, columns {0, 3, 9} of 4 floats, a [4, 6] output
    assert gather_roofline.call_bytes("K3", (table, idx)) == 6 * 4 + 3 * 16 + 4 * 6 * 4
    g = torch.zeros((4, 6))
    assert gather_roofline.call_bytes("K3-bwd", (g, idx, 10)) == 4 * 6 * 4 + 6 * 4 + 3 * 16
    planes = torch.zeros((3, 10))
    idx2 = torch.tensor([[0, 12], [5, 5]], dtype=torch.int32)   # 12 clips to 9
    assert gather_roofline.call_bytes("K7", (planes, idx2)) == 4 * 4 + 3 * 12 + 3 * 4 * 4
    gk = torch.zeros((3, 2, 2))
    assert gather_roofline.call_bytes("K7-bwd", (gk, idx2, 10)) == 3 * 4 * 4 + 4 * 4 + 3 * 12
    corners = torch.zeros((12, 10))
    valid = torch.tensor([[True, False], [True, True]])
    # 4 queries of idx, tx, ty, valid; columns {0, 5} of 4 corners x 3 channels
    assert gather_roofline.call_bytes("K6", (corners, idx2, None, None, valid)) == (
        4 * 13 + 2 * 48 + 3 * 4 * 4)
    assert gather_roofline.touched_bytes(torch.tensor([2, 2, 7]), 8) == 16


def test_ray_bytes_are_the_same_for_every_backend():
    """The four intersectors recorded on the same rays count the same
    bytes: only the live rays' inputs and hits count."""
    from pim_tpu_torch.geom.cornell import build_cornell_box
    from pim_tpu_torch.math.vec3 import V3
    from pim_tpu_torch.render import scene as S

    ents, pool = build_cornell_box("boxes")
    g = torch.Generator().manual_seed(1)
    n = 64
    ro = V3(*(torch.rand(n, generator=g) * 2 - 1 for _ in range(3)))
    d = torch.randn(3, n, generator=g)
    d = d / d.norm(dim=0)
    rd = V3(d[0].contiguous(), d[1].contiguous(), d[2].contiguous())
    t_far = torch.where(torch.arange(n) % 4 == 0, 0.0, 1e30)
    totals = {}
    for backend in ("dense", "cluster", "brute", "bvh"):
        meta, arrays, _ = S.build_scene(ents, pool, "cpu", backend=backend)
        with hooks.recording() as calls:
            S.scene_intersect(meta, arrays, ro, rd, 0.0, t_far)
            S.scene_occluded(meta, arrays, ro, rd, 0.0, t_far)
        assert [(k, m) for k, m, _ in calls.rays] == [("closest", n), ("any", n)]
        totals[backend] = sum(isect_roofline.call_bytes(k, m, tf) for k, m, tf in calls.rays)
    assert set(totals.values()) == {48 * (40 + 36)}


def test_isect_roofline_share():
    class T:
        calls = hooks.Calls(rays=[("closest", 100, 1e30), ("any", 100, 0.0)])

        def group_seconds(self, group):
            return 1e-6 if group == "isect" else 0.0
    share = isect_roofline.read(T(), "render")
    assert share == pytest.approx(100.0 * (100 * 40 / HBM_BYTES_PER_S) / 1e-6)


def test_sync_watch_counts_by_site():
    from pimbench import syncwatch

    syncs = {"count": 0, "at": {}}
    for site in ("a.py:1", "a.py:1", "b.py:2"):
        syncwatch.note_sync(syncs, site)
    assert syncs == {"count": 3, "at": {"a.py:1": 2, "b.py:2": 1}}
    with syncwatch.sync_watch(torch.device("cpu"), syncs):
        pass
    assert syncs["count"] == 3


def test_the_reference_walk_equals_the_frozen_plain_walk():
    """The reference's pair walk gives the frozen plain K4/K5 results bit
    for bit, on a soup of 2,000 triangles and rays with dead, finite and
    open t_far."""
    from pimbench.reference.frozen.math.vec3 import V3
    from pimbench.reference.frozen.render import cluster as CL

    rs = np.random.default_rng(3)
    centers = rs.uniform(-5, 5, (2000, 1, 3))
    pos = (centers + rs.normal(0, 0.4, (2000, 3, 3))).reshape(-1, 3).astype(np.float32)
    cl = CL.ClusterArrays(*(torch.from_numpy(np.asarray(a)) for a in CL.build_clusters(pos)))
    n = 500
    o = torch.from_numpy(rs.uniform(-6, 6, (n, 3)).astype(np.float32))
    d = torch.from_numpy(rs.normal(size=(n, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    ro = V3(*(o[:, k].contiguous() for k in range(3)))
    rd = V3(*(d[:, k].contiguous() for k in range(3)))
    tf = torch.from_numpy(rs.choice([0.0, 3.0, 1e30], n).astype(np.float32))
    for t_far in (tf, 1e30):
        a = CL.cluster_isect_plain(cl, ro, rd, 1e-4, t_far)
        b = CL.cluster_isect_pairs(cl, ro, rd, 1e-4, t_far)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert int((a[1] >= 0).sum()) > 50
        assert torch.equal(CL.cluster_anyhit_plain(cl, ro, rd, 1e-4, t_far),
                           CL.cluster_anyhit_pairs(cl, ro, rd, 1e-4, t_far))
