"""Shared set-up of the benchmark's CPU tests: a benchmark root at a tiny
size (the committed BENCHMARK.json, configuration and traffic files, with
the resolution and bounces cut and the check's samples made small), run
through `pimbench.run.main` on the CPU with the kernels' plain versions."""

import json
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tiny_root(dst: str) -> str:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    os.makedirs(os.path.join(dst, "pimbench", "configs"))
    os.makedirs(os.path.join(dst, "pimbench", "traffic"))
    for c in bench["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        cfg.update(width=8, height=8, bounces=2)
        with open(os.path.join(dst, c["file"]), "w") as f:
            json.dump(cfg, f)
    for name in os.listdir(os.path.join(REPO, "pimbench", "traffic")):
        with open(os.path.join(REPO, "pimbench", "traffic", name)) as f:
            tr = json.load(f)
        tr.update({k: 16 for k in ("check_pixels", "check_texels") if k in tr})
        tr["warmup_steps"] = 1 if "warmup_steps" in tr else None
        tr = {k: v for k, v in tr.items() if v is not None}
        if tr["driver"] == "train":
            tr["set_up_steps"] = 2
        with open(os.path.join(dst, "pimbench", "traffic", name), "w") as f:
            json.dump(tr, f)
    # the CPU cannot bake e1m1's light grid, so the tiny root runs every
    # traffic on Cornell and e1m1's cells only where a test asks
    bench["workloads"] += [
        {"name": f"cornell-{t}", "config": "cornell", "traffic": t, "chips": 1, "why": "test"}
        for t in ("train", "bake")]
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "train_step_ms":
            m["workloads"].append("cornell-train")
        if "workloads" in m and m["name"] == "bake_mtexels_per_s":
            m["workloads"].append("cornell-bake")
    for m in bench["per_layer"]:
        if m["name"].endswith(".train"):
            m["workloads"].append("cornell-train")
        if m["name"].endswith(".bake"):
            m["workloads"].append("cornell-bake")
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


@pytest.fixture(scope="session")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("bench")))


def run_cell(root: str, workload: str, capsys, *extra, seed: int = 3000000017,
             seconds: float = 0.5):
    """(exit code, the last stdout line as a dict or None, stderr) of one
    CPU run."""
    from pimbench import run

    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                   *extra], root=root, device="cpu")
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), err


@pytest.fixture
def restore_program():
    """Undo the faults a test plants in the port's modules."""
    from pim_tpu_torch.render import diff, integrator, lightmap, render_system
    saved = [(m, dict(vars(m))) for m in (diff, integrator, lightmap, render_system)]
    yield
    for m, d in saved:
        for k, v in d.items():
            setattr(m, k, v)
