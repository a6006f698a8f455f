"""The e1m1 entry point on the CPU: `python -m pim_tpu_torch.app --scene
e1m1 --device cpu` at 8^2, 1 bounce runs the plain versions of every kernel
(no launch is counted) through the cluster backend, the atlas, the sky and
the exposure pass, and prints the report lines.

The light-grid bake of the full map is 867 cells x 600 emissives x 16
shadow rays, far too many for the plain any-hit on a CPU, so this test
replaces `bake_light_grid` with every cell active and uniform light pdfs;
the bake itself is held against the reference on a small map in
test_torch_map_frame.py and runs on the card in chip_smoke.py.
"""

import torch

from pim_tpu_torch import app, native
from pim_tpu_torch.math import dist1d
from pim_tpu_torch.render import scene

torch.set_num_threads(2)


def _uniform_light_grid(meta, arrays):
    g, e = meta.grid_len, meta.emissive_count
    dev = arrays.tri_table.device
    baked = dist1d.bake(torch.ones((g, e), dtype=torch.float32, device=dev))
    return torch.ones((g,), dtype=torch.bool, device=dev), scene.LightState(
        pdf=baked.pdf, cdf=baked.cdf, integral=baked.integral, sum=baked.sum,
        live=torch.zeros((g, e), dtype=torch.int64, device=dev))


def test_app_e1m1_on_cpu_runs_plain_path(monkeypatch, capsys):
    monkeypatch.setattr(scene, "bake_light_grid", _uniform_light_grid)
    before = dict(native.launches)
    app.main(["--scene", "e1m1", "--device", "cpu", "--width", "8", "--height", "8",
              "--bounces", "1", "--steps", "2"])
    assert native.launches == before
    lines = dict(ln.split(": ", 1) for ln in capsys.readouterr().out.splitlines())
    assert set(lines) == {"image mean", "luminance_stddev", "rays traced", "ms/step", "Mrays/s",
                          "exposure", "launches"}
    assert float(lines["image mean"]) > 0 and float(lines["rays traced"]) >= 2 * 64
    assert 0 < float(lines["exposure"]) < float("inf")
    assert lines["launches"] == " ".join(f"{k}=0" for k in native.launches)
    assert "cluster_isect=0" in lines["launches"] and "gather_bilinear=0" in lines["launches"]


def test_e1m1_scene_on_cpu_takes_the_cluster_backend(monkeypatch):
    monkeypatch.setattr(scene, "bake_light_grid", _uniform_light_grid)
    meta, arrays, _ = app.build_e1m1_scene("cpu")
    assert (meta.tri_count, meta.mat_count, meta.emissive_count) == (81552, 208, 600)
    assert meta.backend == "cluster" and not meta.sort_rays   # sorting is for the card
    assert meta.textured and meta.has_normal_maps and meta.has_sky and meta.has_refractive
    assert tuple(arrays.sky.shape) == (6, 32, 32, 3) and tuple(arrays.sky_corners.shape) == (
        12, 6 * 32 * 32)
    assert tuple(arrays.atlas_corners.shape) == (16, 128 * 256)
