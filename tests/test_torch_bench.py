"""pim_tpu_torch/bench.py on the CPU, held against the JAX package's
bench.py: the Cornell step at a small size (both modules' constants made
small the same way), the gates, and the JSON line of `main`.

The Cornell step's mean of step means must agree with bench.py's within
2%, test_torch_frame.py's mean rule (the JAX package traces Cornell with
its CPU `brute` backend, the port with K1's plain version)."""

import importlib.util
import json
import os

import jax
import pytest
import torch

import pim_tpu.core.compile_cache as jcompile_cache
from pim_tpu_torch import bench, native

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(WIDTH=16, HEIGHT=16, MAX_BOUNCES=2, SPP_PER_STEP=2, WARMUP=1, ITERS=2)


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jbench(monkeypatch):
    mod = _jax_bench()
    for name, value in SMALL.items():
        monkeypatch.setattr(mod, name, value)
    # bench.py binds ITERS and WARMUP as _measure's defaults
    monkeypatch.setattr(mod._measure, "__defaults__", (SMALL["ITERS"], SMALL["WARMUP"]))
    monkeypatch.setattr(jcompile_cache, "enable_compile_cache", lambda: None)
    return mod


@pytest.fixture
def small(monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setattr(bench, name, value)


def test_bench_cornell_matches_jax(jbench, small):
    mrays, step_s, mean, launches, syncs = bench._bench_cornell(torch.device("cpu"))
    j_mrays, j_step_s, j_mean = jbench._bench_cornell()
    jax.clear_caches()
    assert mrays > 0.0 and step_s > 0.0 and j_mrays > 0.0
    assert abs(mean - j_mean) <= 0.02 * abs(j_mean), (mean, j_mean)
    # CPU tensors run the plain versions, which count no launch
    assert set(launches) == set(native.launches) and not any(launches.values())
    assert syncs == {"count": 0, "at": {}}


def _inside(tag):
    band = bench._band(tag)
    return band["mean"], band["half"]


@pytest.mark.parametrize("tag", ["cornell512", "e1m1_128", "e1m1_512"])
def test_check_gate(tag):
    mean, half = _inside(tag)
    assert bench._check_gate(tag, mean) == "ok"
    assert bench._check_gate(tag, mean + 0.9 * half) == "ok"
    assert bench._check_gate(tag, mean + 1.1 * half).startswith("FAIL")
    assert bench._check_gate(tag, mean - 1.1 * half).startswith("FAIL")


def test_check_gate_without_a_band():
    assert bench._check_gate("no_such_band", 1.0) == "uncalibrated"


def _fake_runs(monkeypatch, cornell_mean, e1m1=None):
    zeros = {k: 0 for k in native.launches}
    none = {"count": 0, "at": {}}
    monkeypatch.setattr(bench, "_bench_cornell",
                        lambda dev: (3.5, 0.25, cornell_mean, zeros, none))
    gate_mean = _inside("e1m1_128")[0]

    def run_e1m1(dev):
        if e1m1 is not None:
            raise e1m1
        return 1.5, 0.3, 81552, "cluster", 8.4, gate_mean, zeros, none

    monkeypatch.setattr(bench, "_bench_e1m1", run_e1m1)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_main_line_has_the_keys_of_bench_py(monkeypatch, capsys, jbench):
    _fake_runs(monkeypatch, _inside("cornell512")[0])
    assert bench.main(["--device", "cpu"]) == 0
    line = _last_json(capsys)
    monkeypatch.setattr(jbench, "_bench_cornell", lambda: (3.5, 0.25, _inside("cornell512")[0]))
    monkeypatch.setattr(jbench, "_bench_e1m1",
                        lambda: (1.5, 0.3, 81552, "cluster", _inside("e1m1_512")[0]))
    jbench.main()
    want = _last_json(capsys)
    assert set(line) == set(want)
    assert set(want["extra"]) <= set(line["extra"])
    assert line["metric"] == want["metric"] and line["unit"] == want["unit"] == "Mrays/s"
    assert line["value"] == 3.5 and line["vs_baseline"] == round(3.5 / bench.BASELINE_MRAYS, 4)
    extra = line["extra"]
    assert extra["gate"] == "ok" and extra["e1m1_backend"] == "cluster"
    assert extra["device"] == "cpu" and extra["power_limit"] is None
    assert set(extra["launches"]) == {"cornell", "e1m1"}


def test_failed_gate_exits_1(monkeypatch, capsys):
    mean, half = _inside("cornell512")
    _fake_runs(monkeypatch, mean + 2.0 * half)
    assert bench.main(["--device", "cpu"]) == 1
    gate = _last_json(capsys)["extra"]["gate"]
    assert gate["cornell512"].startswith("FAIL") and gate["e1m1_128"] == "ok"


def test_e1m1_failure_exits_1_with_its_error(monkeypatch, capsys):
    _fake_runs(monkeypatch, _inside("cornell512")[0], e1m1=RuntimeError("no e1m1 here"))
    assert bench.main(["--device", "cpu"]) == 1
    extra = _last_json(capsys)["extra"]
    assert "no e1m1 here" in extra["e1m1_error"] and extra["gate"] == "ok"
    assert "e1m1_mrays_per_s" not in extra
