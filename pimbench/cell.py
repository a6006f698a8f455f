"""Finding a cell's parts by name: its entry in BENCHMARK.json, its
configuration file, its traffic file, the driver that file names and the
readers of its per-layer metrics.  Nothing here knows a cell, a scene, a
mix or a metric by name."""

from __future__ import annotations

import importlib
import json
import os
import re
from dataclasses import dataclass

PKG = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(PKG)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents
    end_to_end: list      # this cell's end-to-end metric entries
    per_layer: list       # this cell's per-layer metric entries


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, root: str = CHECKOUT) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json (a KeyError names a
    cell that is not there)."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    traffic = traffic_file(w["traffic"], root)
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    per_layer = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if workload in m["workloads"]:
                per_layer.append(m)
        elif m["moves"] in {e["name"] for e in e2e}:
            per_layer.append(m)
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer)


def traffic_file(name: str, root: str = CHECKOUT) -> dict:
    """The parameters of traffic mix `name`: `pimbench/traffic/<name>.json`
    under `root` (a mix is data; its `driver` names the code that runs it)."""
    if not NAME.match(name):
        raise ValueError(f"traffic name {name!r}")
    with open(os.path.join(root, "pimbench", "traffic", f"{name}.json")) as f:
        return json.load(f)


def driver(name: str):
    """The driver module `pimbench.drivers.<name>`."""
    if not re.match(r"^[a-z_][a-z0-9_]*$", name):
        raise ValueError(f"driver name {name!r}")
    return importlib.import_module(f"pimbench.drivers.{name}")


def reader(metric: str):
    """(reader module, kind) of per-layer metric `metric`: the module
    `pimbench.metrics.<base>` for a name `<base>` or `<base>.<kind>`."""
    base, _, kind = metric.partition(".")
    if not re.match(r"^[a-z_][a-z0-9_]*$", base):
        raise ValueError(f"metric name {metric!r}")
    return importlib.import_module(f"pimbench.metrics.{base}"), kind
