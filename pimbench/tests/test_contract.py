"""BENCHMARK.json keeps to the benchmark contract's form: its keys, the
characters of every name and unit, the lengths, the links between cells,
configurations and metrics, and each configuration file's `reduced`."""

import json
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_form():
    path = os.path.join(REPO, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    b = json.load(open(path))
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                              for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    assert len(configs) == len(b["configs"]) and 1 <= len(configs) <= 24
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        cfg = json.load(open(os.path.join(REPO, c["file"])))
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells) and 1 <= len(cells) <= 24
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(REPO, "pimbench", "traffic", w["traffic"] + ".json"))
    assert set(configs) == {w["config"] for w in b["workloads"]}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in ("host_clock",
                                                                      "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and _line(m["layer"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            reported = e2e[m["moves"]].get("workloads", cells)
            assert w in cells and w in reported, (m["name"], w)
        layers.setdefault(m["layer"], set()).add(m["name"].split(".")[0])
        assert os.path.exists(os.path.join(REPO, "pimbench", "metrics",
                                           m["name"].split(".")[0] + ".py"))
    for w in cells:
        reported = [m for m in b["end_to_end"] if w in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(w in m.get("workloads", cells) for m in b["per_layer"])
