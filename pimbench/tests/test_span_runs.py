"""`--trace 1` runs of the Cornell cells at a tiny size on the CPU report the
metrics of the stackless pass (pimbench/spans.py) in the cells their
`workloads` name, beside the stack pass's, and stay correct after its
extra steps; the program's tracing is off again when the run ends."""

import pytest

from pimbench import cell as C
from pimbench.tests.conftest import run_cell

SPAN_METRICS = ("host_ms_per_step", "live_ray_share", "live_texel_share",
                "device_idle_share_spans", "sort_ms_per_step")


@pytest.mark.parametrize("workload", ["cornell-render", "cornell-train", "cornell-bake"])
def test_the_stackless_pass_reports_its_metrics(root, capsys, workload):
    from pim_tpu_torch.core import profiler

    rc, line, err = run_cell(root, workload, capsys, "--trace", "1")
    assert rc == 0, err
    assert line["correct"] is True, line["checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    cell = C.load(workload, root)
    wanted = {m["name"] for m in cell.per_layer if m["name"].split(".")[0] in SPAN_METRICS}
    # Cornell has no ray sort: its sort_ms_per_step reads nothing
    want = {n for n in wanted if not n.startswith("sort_ms_per_step")}
    assert want and set(line["metrics"]) & wanted == want
    assert 0.0 < line["metrics"][f"live_ray_share.{cell.traffic['driver']}"]["value"] <= 100.0
    assert "# stackless pass: " in err and "# bounce.live: [" in err
    assert not profiler.tracing() and profiler.counters() == {}


def test_trace_cost_times_every_mode(root, capsys):
    import json

    from pim_tpu_torch.core import profiler
    from pimbench import trace_cost

    assert trace_cost.main(["--workload", "cornell-render", "--seed", "4000000007",
                            "--steps", "1", "--rounds", "1", "--root", root], device="cpu") == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line["ms_per_step"]) == {"off_before", "on_before", "stackless", "stack",
                                        "off_after", "on_after"}
    assert all(v > 0 for v in line["ms_per_step"].values())
    assert not profiler.tracing()
