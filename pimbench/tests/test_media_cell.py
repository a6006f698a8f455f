"""The cornell-media cell at 8x8 on the CPU (the media marches' plain form
on both sides): both modes end correct, the trace reports the media
metrics it can read here (the counters' scatter share; no CUDA kernel
runs, so the roofline and the media kernels' device time read nothing),
and the reference sees a program that renders without the medium."""

import pytest

from pimbench.tests.conftest import run_cell

SEED = 3000000029


@pytest.mark.parametrize("trace", ["0", "1"])
def test_cornell_media_runs_and_is_correct(root, capsys, trace):
    rc, line, err = run_cell(root, "cornell-media", capsys, "--trace", trace, seed=SEED)
    assert rc == 0, err
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    assert set(line["checks"]) == {"pixels_off", "accum_gap", "grid_gap"}
    if trace == "0":
        assert {"render_msamples_per_s", "render_step_ms_p90", "setup_s"} == set(line["metrics"])
    else:
        share = line["metrics"]["media_scatter_share.render"]["value"]
        assert 0.0 < share < 100.0
        assert "media_roofline.render" not in line["metrics"]


def test_a_program_without_the_medium_fails_the_check(root, capsys, monkeypatch):
    """The scene built in vacuum: the reference's medium sets it apart."""
    import dataclasses

    from pim_tpu_torch.render import integrator, render_system

    def vacuum(meta, *a, **k):
        return integrator.trace_rays(dataclasses.replace(meta, media_enabled=False), *a, **k)

    monkeypatch.setattr(render_system, "trace_rays", vacuum)
    rc, line, err = run_cell(root, "cornell-media", capsys, "--trace", "0", seed=SEED)
    assert rc == 0, err
    assert line["correct"] is False
    assert line["checks"]["pixels_off"]["value"] > line["checks"]["pixels_off"]["limit"]
