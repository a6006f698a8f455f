"""Each traffic driver runs at a tiny size on the CPU with the kernels'
plain versions, its result line has the contract's keys, and a cell made of
new files only is found without editing a file."""

import json
import os
import sys

import pytest

from pimbench import cell as C
from pimbench.tests.conftest import run_cell

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", ["cornell-render", "cornell-train", "cornell-bake"])
@pytest.mark.parametrize("trace", ["0", "1"])
def test_each_driver_runs_and_is_correct(root, capsys, workload, trace):
    rc, line, err = run_cell(root, workload, capsys, "--trace", trace)
    assert rc == 0, err
    keys = list(line)
    assert keys[:5] == CONTRACT_KEYS
    assert keys[-1] == "checks"
    assert set(keys) <= set(CONTRACT_KEYS) | {"breakdown", "checks"}
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    assert line["attempted"] > 0
    cell = C.load(workload, root)
    wanted = cell.per_layer if trace == "1" else cell.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in wanted}
    if trace == "0":
        assert set(line["metrics"]) == {m["name"] for m in wanted}
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    # every compared number is printed beside its limit, last on stderr
    tail = [ln for ln in err.splitlines() if ln.strip()][-len(line["checks"]):]
    assert all(ln.startswith("# check ") and " limit " in ln for ln in tail)


def test_the_e1m1_configuration_renders(tmp_path, capsys, monkeypatch):
    """e1m1 at 8x8 through the render driver.  Its bake traces the whole
    1,048,576-texel pack and its training step takes minutes through the
    plain kernels, so those two run on the card alone.  Its light grid is a
    uniform one on both sides here, since the CPU cannot bake e1m1's (8.3
    million shadow rays through the plain any hit)."""
    import torch

    from pim_tpu_torch.render import scene as S
    from pimbench.reference.frozen.render import scene as RS
    from pimbench.tests.conftest import tiny_root

    r = tiny_root(str(tmp_path))

    def uniform_grid(meta, arrays, side=S):
        g, e = meta.grid_len, max(meta.emissive_count, 1)
        dev = arrays.tri_table.device
        pdf = torch.ones((g, e), dtype=torch.float32, device=dev)
        d = side.dist1d.bake(pdf)
        return torch.ones((g,), dtype=torch.bool, device=dev), side.LightState(
            pdf=d.pdf, cdf=d.cdf, integral=d.integral, sum=d.sum,
            live=torch.zeros((g, e), dtype=torch.int64, device=dev))

    monkeypatch.setattr(S, "bake_light_grid", uniform_grid)
    monkeypatch.setattr(RS, "bake_light_grid", lambda m, a: uniform_grid(m, a, RS))
    bench = json.load(open(os.path.join(r, "BENCHMARK.json")))
    bench["workloads"] = [w for w in bench["workloads"] if w["config"] == "e1m1"]
    json.dump(bench, open(os.path.join(r, "BENCHMARK.json"), "w"))
    rc, line, err = run_cell(r, "e1m1-render", capsys, "--trace", "0", seconds=0.1)
    assert rc == 0, err
    assert line["correct"] is True, line["checks"]


def test_a_cell_of_new_files_is_found(tmp_path, monkeypatch):
    """A new configuration file, a new traffic file (data only) and a new
    metric reader are found by name; no file of the benchmark changes."""
    import pimbench.metrics
    from pimbench.tests.conftest import tiny_root

    r = tiny_root(str(tmp_path / "root"))
    with open(os.path.join(r, "pimbench", "traffic", "render.json")) as f:
        tr = json.load(f)
    tr["spp"] = 2
    with open(os.path.join(r, "pimbench", "traffic", "render_2spp.json"), "w") as f:
        json.dump(tr, f)
    with open(os.path.join(r, "pimbench", "configs", "cornell.json")) as f:
        cfg = json.load(f)
    cfg["camera"]["position"] = [-3.0, 0.5, 4.0]
    with open(os.path.join(r, "pimbench", "configs", "cornell_side.json"), "w") as f:
        json.dump(cfg, f)
    readers = tmp_path / "readers"
    readers.mkdir()
    (readers / "steps_traced.py").write_text("def read(t, kind):\n    return t.steps\n")
    monkeypatch.setattr(pimbench.metrics, "__path__", list(pimbench.metrics.__path__)
                        + [str(readers)])
    bench = json.load(open(os.path.join(r, "BENCHMARK.json")))
    bench["configs"].append({"name": "cornell_side", "source": "https://example.org",
                             "file": "pimbench/configs/cornell_side.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "cornell_side-render_2spp", "config": "cornell_side",
                               "traffic": "render_2spp", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("cornell_side-render_2spp")
    bench["per_layer"].append({"name": "steps_traced.render", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "render_msamples_per_s",
                               "workloads": ["cornell_side-render_2spp"]})
    json.dump(bench, open(os.path.join(r, "BENCHMARK.json"), "w"))
    cell = C.load("cornell_side-render_2spp", r)
    assert cell.config["camera"]["position"] == [-3.0, 0.5, 4.0]
    assert cell.traffic["spp"] == 2
    assert [m["name"] for m in cell.per_layer] == ["scene_build_s", "steps_traced.render"]
    reader, kind = C.reader("steps_traced.render")
    assert kind == "render" and reader.read(type("T", (), {"steps": 3})(), kind) == 3
    assert sys.modules["pimbench.metrics.steps_traced"] is reader
