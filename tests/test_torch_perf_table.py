"""pim_tpu_torch/tools/perf_table.py on the CPU: the attribution of a
synthetic Chrome trace (python_function, launch and kernel events linked by
correlation), the subsystem list against the port's files, the checks, and
a CPU profile of a 16^2 Cornell step."""

import os
import re

import pytest
import torch

from pim_tpu_torch.app import build_cornell_scene
from pim_tpu_torch.tools import perf_table, prof_frame

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN = (7, 70)    # (pid, tid) of the host thread with the Python frames
OTHER_T = (7, 71)  # a thread without Python frames


def _frame(name, ts, dur, key=MAIN):
    return {"ph": "X", "cat": "python_function", "name": name, "pid": key[0], "tid": key[1],
            "ts": ts, "dur": dur}


def _launch(corr, ts, key=MAIN, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "pid": key[0], "tid": key[1],
            "ts": ts, "dur": 1.0, "args": {"correlation": corr}}


def _kernel(name, corr, dur):
    args = {} if corr is None else {"correlation": corr}
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7, "ts": 1000.0,
            "dur": dur, "args": args}


def _synthetic():
    """The step: trace_rays [0, 100) calls the NEE [10, 50), whose shadow
    ray reaches K2's wrapper [18, 28), and the BSDF [60, 90), which draws
    from the RNG [62, 67).  Launches: K2 in its wrapper (1), a torch op of
    the NEE (2), one in the RNG under the BSDF (3), one of the loop's glue
    (4), one on a thread without frames at ts 70 (5: the main thread's
    stack there, the BSDF), one after every frame (6), a driver launch of
    K4 in its wrapper (7); a kernel with no correlation, a memcpy and a
    memset."""
    ev = [
        _frame("pim_tpu_torch/render/integrator.py(200): trace_rays", 0.0, 100.0),
        _frame("pim_tpu_torch/render/lights.py(227): nee_light_strategy", 10.0, 40.0),
        _frame("pim_tpu_torch/render/scene.py(209): scene_occluded", 15.0, 20.0),
        _frame("pim_tpu_torch/render/dense_kernels.py(214): dense_anyhit", 18.0, 10.0),
        _frame("<built-in method mul of type object at 0x1>", 40.0, 2.0),
        _frame("pim_tpu_torch/render/bsdf.py(50): bsdf_sample", 60.0, 30.0),
        _frame("pim_tpu_torch/core/rng.py(101): next_f32", 62.0, 5.0),
        _frame("pim_tpu_torch/render/cluster.py(321): cluster_isect", 92.0, 5.0),
        _launch(1, 20.0), _launch(2, 41.0), _launch(3, 63.0), _launch(4, 55.0),
        _launch(5, 70.0, OTHER_T), _launch(6, 150.0), _launch(7, 93.0, cat="cuda_driver"),
        _kernel("dense_anyhit_kernel", 1, 5.0),
        _kernel("void at::native::vectorized_elementwise_kernel<mul>", 2, 3.0),
        _kernel("void at::native::vectorized_elementwise_kernel<and>", 3, 2.0),
        _kernel("void at::native::vectorized_elementwise_kernel<where>", 4, 1.5),
        _kernel("void at::native::reduce_kernel", 5, 4.0),
        _kernel("void at::native::index_elementwise_kernel", 6, 0.5),
        _kernel("cluster_isect_kernel", 7, 7.0),
        _kernel("void orphan_kernel", None, 0.25),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "pid": 0, "tid": 8,
         "ts": 0.0, "dur": 0.75},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "pid": 0, "tid": 8, "ts": 0.0,
         "dur": 0.125},
        {"ph": "M", "name": "thread_name", "pid": 7, "tid": 70, "args": {"name": "python"}},
    ]
    return ev


def test_kernels_go_to_their_subsystems_by_priority():
    rows = perf_table.attribute_device(_synthetic())
    got = {name: sub for name, sub, _ in rows}
    assert got == {
        "dense_anyhit_kernel": "intersect",  # the kernel row leads nee-light
        "void at::native::vectorized_elementwise_kernel<mul>": "nee-light",
        "void at::native::vectorized_elementwise_kernel<and>": "bsdf",  # bsdf before rng
        "void at::native::vectorized_elementwise_kernel<where>": "integrator-glue",
        "void at::native::reduce_kernel": "bsdf",  # the main thread's stack at ts 70
        "void at::native::index_elementwise_kernel": perf_table.OTHER,  # outside every frame
        "cluster_isect_kernel": "intersect",
        "void orphan_kernel": perf_table.OTHER,  # no launch to follow
        "Memcpy DtoH": perf_table.COPIES,
        "Memset": perf_table.COPIES,
    }


def test_rows_sum_to_the_timeline():
    ev = _synthetic()
    rows = perf_table.attribute_device(ev)
    timeline_us = sum(e["dur"] for e in ev if e.get("cat") in ("kernel", "gpu_memcpy",
                                                                "gpu_memset"))
    s = perf_table.summarize(rows)
    assert s["ms"] == pytest.approx(timeline_us / 1e3, rel=1e-12)
    assert sum(ms for _, ms, _ in s["subsystems"].values()) == pytest.approx(s["ms"], rel=1e-12)
    assert sum(share for _, _, share in s["subsystems"].values()) == pytest.approx(1.0)
    assert s["other_share"] == pytest.approx(0.75 / timeline_us, rel=1e-12)
    assert perf_table.port_kernel_subsystems(rows) == {
        "K2 dense_anyhit": {"intersect": 1}, "K4 cluster_isect": {"intersect": 1}}


def test_host_ops_self_time_by_stack():
    ev = _synthetic() + [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "pid": 7, "tid": 70, "ts": 40.5,
         "dur": 1.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::where", "pid": 7, "tid": 70, "ts": 52.0,
         "dur": 4.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "pid": 7, "tid": 70, "ts": 53.0,
         "dur": 1.5},
    ]
    rows = perf_table.attribute_host(ev)
    assert sorted(rows) == sorted([("aten::mul", "nee-light", 1.0),
                                   ("aten::where", "integrator-glue", 2.5),
                                   ("aten::empty", "integrator-glue", 1.5)])


def test_every_subsystem_names_a_file_of_the_port():
    pkg = os.path.join(ROOT, "pim_tpu_torch")
    files = [os.path.relpath(os.path.join(d, f), ROOT)
             for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    for label, pattern in perf_table.SUBSYSTEMS:
        for alternative in pattern.pattern.split("|"):
            assert any(re.search(alternative, f) for f in files), (label, alternative)


def test_check_refuses_a_short_sum_and_a_lost_kernel():
    good = {"path": "p", "sum_rel_diff": 0.004, "device_ms": 1.0, "profiler_device_ms": 1.004,
            "port_kernels": {"K1 dense_isect": {"intersect": 12}}}
    perf_table.check(good)
    with pytest.raises(AssertionError, match="sum to"):
        perf_table.check(dict(good, sum_rel_diff=0.02))
    with pytest.raises(AssertionError, match="port kernels"):
        perf_table.check(dict(good, port_kernels={"K3 gather_cols": {"other": 1,
                                                                     "table-gather": 4}}))


def test_cpu_profile_of_a_cornell_step_leaves_little_in_other(tmp_path):
    """The host ops of a 16^2, 10-bounce, 1-spp Cornell step profiled on the
    CPU with stacks: under 10% of their self time falls to 'other'."""
    dev = torch.device("cpu")
    step = prof_frame.frame_step("cornell", build_cornell_scene(dev), dev, 1, 10, 16, 16)
    step(0)
    events, _, _ = perf_table.traced_step(step, 1, dev, str(tmp_path / "cornell.trace.json"))
    s = perf_table.summarize(perf_table.attribute_host(events))
    assert s["ms"] > 0.0
    assert s["other_share"] < 0.10, s["subsystems"]
    assert {"intersect", "nee-light", "bsdf", "table-gather"} <= set(s["subsystems"])
