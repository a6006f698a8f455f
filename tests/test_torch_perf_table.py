"""pim_tpu_torch/tools/perf_table.py on the CPU: the attribution of a
synthetic Chrome trace (python_function, launch and kernel events linked by
correlation), the busy share of synthetic windows, the subsystem list
against the port's files, the checks, and a CPU profile of a 16^2 Cornell
step."""

import json
import os
import re
import types

import pytest
import torch

from pim_tpu_torch.app import build_cornell_scene
from pim_tpu_torch.tools import perf_table

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


def _window(ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": perf_table.WINDOW, "pid": 7,
            "tid": 70, "ts": ts, "dur": dur}


def _device(cat, ts, dur, tid=7):
    return {"ph": "X", "cat": cat, "name": "k", "pid": 0, "tid": tid, "ts": ts, "dur": dur}


@pytest.mark.parametrize("device,busy", [
    # two streams overlap: the union, not the sum of their times (0.8)
    ([_device("kernel", 110.0, 40.0), _device("kernel", 130.0, 40.0, tid=8)], 0.6),
    # a gap between kernels, and a kernel inside another's interval
    ([_device("kernel", 100.0, 20.0), _device("kernel", 105.0, 5.0),
      _device("kernel", 180.0, 20.0)], 0.4),
    # kernels straddling the window's edges count only inside it
    ([_device("kernel", 50.0, 80.0), _device("kernel", 190.0, 70.0)], 0.4),
    # no kernel in the window: the ones before and after it do not count
    ([_device("kernel", 0.0, 90.0), _device("kernel", 200.0, 50.0)], 0.0),
    # copies and sets keep the device busy too
    ([_device("gpu_memcpy", 120.0, 10.0), _device("gpu_memset", 150.0, 15.0),
      _device("gpu_user_annotation", 100.0, 100.0)], 0.25),
])
def test_busy_share_is_the_union_of_device_events_in_the_window(device, busy):
    ev = [_window(100.0, 100.0)] + device + [_frame("a.py(1): f", 0.0, 300.0)]
    got, window_ms = perf_table.busy_share(ev)
    assert got == pytest.approx(busy, abs=1e-12)
    assert window_ms == pytest.approx(0.1, rel=1e-12)
    with pytest.raises(RuntimeError, match="spans in the trace"):
        perf_table.busy_share(device)


def test_device_time_leaves_out_the_window_span():
    """On the card the WINDOW span has a device-side copy in key_averages
    whose device time covers the step's kernels."""
    def avg(key, us, count, device=torch.autograd.DeviceType.CUDA):
        return types.SimpleNamespace(key=key, self_device_time_total=us, count=count,
                                     device_type=device)

    avgs = [avg(perf_table.WINDOW, 900.0, 1), avg("dense_isect_kernel", 300.0, 11),
            avg("Memcpy DtoH", 20.0, 2), avg("aten::mul", 0.0, 40, torch.autograd.DeviceType.CPU),
            avg(perf_table.WINDOW, 0.0, 1, torch.autograd.DeviceType.CPU)]
    kernels, ms, count = perf_table.device_time(avgs)
    assert [e.key for e in kernels] == ["dense_isect_kernel", "Memcpy DtoH"]
    assert ms == pytest.approx(0.32, rel=1e-12) and count == 13


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


def test_cpu_profile_of_a_cornell_step_leaves_little_in_other(tmp_path, monkeypatch):
    """The path of a 16^2, 10-bounce Cornell step profiled on the CPU with
    stacks: the traced window is found (no device event, so busy 0), and the
    step's torch ops, each at the subsystem of the stack around its start
    (the stacks that name a launched kernel's subsystem on the card), leave
    under 10% of their time in 'other'."""
    monkeypatch.setattr(perf_table, "WIDTH", 16)
    monkeypatch.setattr(perf_table, "HEIGHT", 16)
    dev = torch.device("cpu")
    r = perf_table.run_path("cornell", build_cornell_scene(dev), dev,
                            trace_dir=str(tmp_path))
    perf_table.check(r)
    assert r["busy_share"] == 0.0 and r["window_ms"] > 0.0 and r["device_events"] == 0
    assert (r["width"], r["bounces"], r["train"], r["media"]) == (16, 10, False, False)
    with open(tmp_path / "cornell.trace.json") as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    stacks = perf_table.stacks_at(perf_table.python_frames(events),
                                  [((e["pid"], e["tid"]), e["ts"]) for e in ops])
    s = perf_table.summarize([(e["name"], perf_table.classify(st), e["dur"])
                              for e, st in zip(ops, stacks)])
    assert s["ms"] > 0.0
    assert s["other_share"] < 0.10, s["subsystems"]
    assert {"intersect", "nee-light", "bsdf", "table-gather"} <= set(s["subsystems"])
