"""The data-parallel train cell (`drivers/train_dp.py`): its configuration
is e1m1's with a layout, its cell loads with four cards, the benchmark
keeps its four-card cells few, and the driver runs on a two-rank world of
CPU processes (gloo) at a tiny size on Cornell: correct, with the reduce's
span and counter read; not correct with the gradient all-reduce planted
out; and ended non-zero at once when a worker exits early.  Each run is a
process of its own (`python -m pimbench.drivers.train_dp --device cpu`),
so that its world and its workers end with it."""

import json
import os
import subprocess
import sys
import time

import pytest

from pimbench import cell as C
from pimbench.drivers import train_dp
from pimbench.metrics import allreduce_roofline
from pimbench.tests.conftest import REPO, tiny_root

CELL = "e1m1-train-4chip"
TINY = "cornell-train-4chip"
SEED = 3000000019


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_the_configuration_is_e1m1s_scene_and_frame():
    with open(os.path.join(REPO, "pimbench", "configs", "e1m1.json")) as f:
        e1m1 = json.load(f)
    with open(os.path.join(REPO, "pimbench", "configs", "e1m1-dp4.json")) as f:
        dp4 = json.load(f)
    for key in ("scene", "backend", "camera", "width", "height", "bounces", "exposure"):
        assert dp4[key] == e1m1[key], key
    assert dp4["reduced"] == [] and dp4["layout"]["ranks"] == 4


def test_the_cell_loads_with_four_cards():
    cell = C.load(CELL)
    assert cell.chips == 4 and cell.config["name"] == "e1m1-dp4"
    assert cell.traffic["driver"] == "train_dp" and cell.traffic["ranks"] == 4
    train = C.traffic_file("train")
    assert {k: v for k, v in cell.traffic["limits"].items() if k != "rank_gap"} == train["limits"]
    for key in ("bounces", "sky_steps", "learning_rate", "set_up_steps", "trace_steps",
                "perturb"):
        assert cell.traffic[key] == train[key], key
    assert {m["name"] for m in cell.end_to_end} == {"train_step_ms", "setup_s"}
    assert {"allreduce_ms_per_step.train", "allreduce_roofline.train",
            "reduce_host_ms_per_step.train"} <= {m["name"] for m in cell.per_layer}


def test_four_card_cells_stay_few():
    cells = _bench()["workloads"]
    four = [w["name"] for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4), four


def test_a_program_without_the_sharded_step_fails_at_once(monkeypatch):
    """The parent of the data-parallel step: the run exits at set-up, before
    a worker is spawned."""
    import torch

    from pim_tpu_torch.render import diff

    def make_train_step(meta, width, height, max_bounces=3, sky_steps=16,
                        learning_rate=2e-2, trainable=None):
        raise AssertionError("not reached")

    monkeypatch.setattr(diff, "make_train_step", make_train_step)
    monkeypatch.setattr(train_dp, "World", None)
    with pytest.raises(SystemExit, match="no mesh"):
        train_dp.setup(C.load(CELL), SEED, torch.device("cpu"))


@pytest.fixture(scope="module")
def dp_root(tmp_path_factory):
    """The tiny root with the data-parallel traffic on Cornell over two
    CPU ranks."""
    r = tiny_root(str(tmp_path_factory.mktemp("dp")))
    path = os.path.join(r, "pimbench", "traffic", "train-4chip.json")
    with open(path) as f:
        tr = json.load(f)
    tr.update(ranks=2, set_up_steps=2)
    with open(path, "w") as f:
        json.dump(tr, f)
    bench = json.load(open(os.path.join(r, "BENCHMARK.json")))
    bench["workloads"].append({"name": TINY, "config": "cornell", "traffic": "train-4chip",
                               "chips": 4, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY)
    json.dump(bench, open(os.path.join(r, "BENCHMARK.json"), "w"))
    return r


def _run(root, *args, plant=None, timeout=600):
    """(exit code, last stdout line as a dict or None, stderr, seconds) of
    one CPU run of the tiny cell in a process of its own."""
    cmd = [sys.executable, "-m", "pimbench.drivers.train_dp", "--device", "cpu",
           "--root", root]
    if plant:
        cmd += ["--plant", plant]
    cmd += ["--", "--workload", TINY, "--seed", str(SEED), "--seconds", "0.5", *args]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=timeout)
    secs = time.perf_counter() - t0
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    line = None
    if lines:
        try:
            line = json.loads(lines[-1])
        except ValueError:
            pass
    return res.returncode, line, res.stderr, secs


def test_the_driver_runs_on_two_cpu_ranks_and_is_correct(dp_root):
    rc, line, err, _ = _run(dp_root, "--trace", "0")
    assert rc == 0, err[-4000:]
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    assert set(line["metrics"]) == {"train_step_ms", "setup_s"}
    assert line["checks"]["rank_gap"] == {"value": 0.0, "limit": 0.0}
    assert "# world: 2 ranks, all-reduces on gloo" in err


@pytest.fixture(scope="module")
def traced(dp_root):
    return _run(dp_root, "--trace", "1")


def test_a_traced_run_reads_the_reduce(traced):
    rc, line, err, _ = traced
    assert rc == 0, err[-4000:]
    assert line["correct"] is True, line["checks"]
    # gloo on the CPU launches no NCCL kernel: the device metrics read nothing
    assert "reduce_host_ms_per_step.train" in line["metrics"]
    assert line["metrics"]["reduce_host_ms_per_step.train"]["value"] > 0.0
    assert not {"allreduce_ms_per_step.train", "allreduce_roofline.train"} & set(line["metrics"])


def test_the_reduce_counter_equals_the_roofline_bytes(traced):
    import torch

    from pim_tpu_torch.render import diff
    from pimbench import scenes

    rc, _, err, _ = traced
    assert rc == 0, err[-4000:]
    counters = json.loads(err.split("# counters: ", 1)[1].splitlines()[0])
    cfg = json.load(open(os.path.join(REPO, "pimbench", "configs", "cornell.json")))
    cfg.update(width=8, height=8)
    meta, arrays, _ = scenes.build(cfg, torch.device("cpu"), "program")
    params = diff.extract_params(meta, arrays, scenes.camera(cfg, "program"))
    shapes = [tuple(p.shape) for p in params]
    assert counters["reduce.calls"] == 7  # six groups and the loss, one traced step
    assert counters["reduce.bytes"] == allreduce_roofline.reduce_bytes(shapes)
    e1m1 = 2 * 208 * 4 + 4 * 128 * 256 + 9  # E1M1's groups: 132,745 floats
    assert allreduce_roofline.reduce_bytes([(208, 4), (208, 4), (4, 128 * 256), (3,), (3,),
                                            (3,)]) == 4 * (e1m1 + 1)


def test_the_gradient_all_reduce_left_out_is_not_correct(dp_root):
    rc, line, err, _ = _run(dp_root, "--trace", "0", plant="reduce_left_out")
    assert rc == 0, err[-4000:]
    assert line["correct"] is False
    failed = {n for n, c in line["checks"].items() if not c["value"] <= c["limit"]}
    assert {"grad_gap", "rank_gap"} <= failed, line["checks"]


def test_a_worker_that_exits_early_ends_the_run(dp_root):
    rc, line, err, secs = _run(dp_root, "--trace", "0", plant="worker_exits",
                               timeout=train_dp.WORLD_TIMEOUT_S + 300)
    assert rc != 0 and line is None
    assert "rank 1 exited" in err or "Connection" in err or "closed" in err, err[-4000:]
    assert secs < train_dp.WORLD_TIMEOUT_S, secs
