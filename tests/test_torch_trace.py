"""The port's tracing (`pim_tpu_torch/core/profiler.py`): with it off the
spans open no range and the counters make no tensor; on or off, a render
step, a bake pass and a train step give the same bits; under a profiler
the spans nest as the program does; the counters count lanes."""

import json

import pytest
import torch

from pim_tpu_torch.app import bench_camera, build_cornell_scene
from pim_tpu_torch.core import profiler
from pim_tpu_torch.geom.cornell import build_cornell_box
from pim_tpu_torch.geom.entities import flatten
from pim_tpu_torch.render import diff, lightmap
from pim_tpu_torch.render.render_system import trace_samples

W = H = 8
BOUNCES = 3
SPP = 2


@pytest.fixture(scope="module")
def scene():
    return build_cornell_scene("cpu")


@pytest.fixture(scope="module")
def pack():
    flat = flatten(build_cornell_box("boxes")[0])
    return lightmap.pack_lightmaps(flat.positions, flat.normals, 1.0, device="cpu")


@pytest.fixture(autouse=True)
def untraced():
    """Every test starts and ends with tracing off and no counters."""
    profiler.set_tracing(False)
    profiler.reset_counters()
    yield
    profiler.set_tracing(False)
    profiler.reset_counters()


def _render(scene):
    return trace_samples(scene, bench_camera("cornell", W, H), W, H, BOUNCES, SPP, 0)


def _bake(scene, pack):
    return lightmap.bake_step(*scene, pack, 7, max_bounces=2)


def _train(scene):
    meta, arrays, lights = scene
    cam = bench_camera("cornell", W, H)
    params = diff.extract_params(meta, arrays, cam)
    target = torch.zeros((W * H, 3))
    init, step = diff.make_train_step(meta, W, H, 2, learning_rate=2e-2)
    opt = init(params)
    loss, params, opt = step(params, opt, arrays, lights, cam, target, 5)
    return [loss] + [p.detach() for p in params] + [p.grad for p in params]


def _traced(fn, *args):
    profiler.set_tracing(True)
    try:
        return fn(*args)
    finally:
        profiler.set_tracing(False)


def _raise(*_a, **_k):
    raise AssertionError("reached with tracing off")


def test_spans_off_open_no_range_and_counters_make_no_tensor(scene, pack, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(profiler, "count", _raise)
    with profiler.span("pt.x"):
        pass
    assert profiler.span("pt.x") is profiler.span("pt.y")  # one shared context
    _render(scene)
    _bake(scene, pack)
    _train(scene)
    assert profiler.counters() == {}


def test_count_is_a_no_op_untraced():
    profiler.count("a", 3)
    profiler.count("b", torch.ones(3))
    assert profiler.counters() == {}


def test_counters_add_and_read_back():
    profiler.set_tracing(True)
    profiler.count("n", 3)
    profiler.count("n", torch.tensor(4))
    profiler.count("v", torch.tensor([1, 2]))
    profiler.count("v", torch.tensor([1, 1, 5]))
    profiler.count("i", 2)
    assert profiler.counters() == {"n": 7, "v": [2, 3, 5], "i": 2}
    profiler.reset_counters()
    assert profiler.counters() == {}


@pytest.mark.parametrize("what", ["render", "bake", "train"])
def test_tracing_changes_no_bit(scene, pack, what):
    run = {"render": lambda: list(_render(scene)), "bake": lambda: list(_bake(scene, pack)),
           "train": lambda: _train(scene)}[what]
    off = run()
    on = _traced(run)
    assert len(off) == len(on)
    for a, b in zip(off, on):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def _annotations(fn, tmp_path):
    """[(start, end, name)] of the pt.* ranges of one traced call under a
    CPU profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _traced(fn)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"].startswith("pt."))


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_render_spans_nest(scene, tmp_path):
    ann = _annotations(lambda: _render(scene), tmp_path)
    by = {}
    for a in ann:
        by.setdefault(a[2], []).append(a)
    assert len(by["pt.trace"]) == 1
    assert len(by["pt.primary"]) == SPP
    assert len(by["pt.bounce"]) == SPP * BOUNCES
    trace = by["pt.trace"][0]
    assert all(_inside(b, trace) for b in by["pt.bounce"])
    # every bounce traces its continuation: pt.trace > pt.bounce > pt.isect
    assert all(any(_inside(i, b) for i in by["pt.isect"]) for b in by["pt.bounce"])
    for name in ("pt.shadow", "pt.nee", "pt.bsdf", "pt.surface", "pt.segment", "pt.fetch",
                 "pt.gather"):
        assert by[name] and all(any(_inside(s, b) for b in by["pt.primary"] + by["pt.bounce"])
                                for s in by[name]), name
    assert all(any(_inside(s, n) for n in by["pt.nee"]) for s in by["pt.shadow"])


def test_train_step_shows_its_phases(scene, tmp_path):
    ann = _annotations(lambda: _train(scene), tmp_path)
    by = {}
    for a in ann:
        by.setdefault(a[2], []).append(a)
    (step,) = by["pt.train"]
    for phase in ("pt.train.params", "pt.train.forward", "pt.train.backward", "pt.train.adam"):
        assert len(by[phase]) == 1 and _inside(by[phase][0], step), phase
    assert _inside(by["pt.train.params"][0], by["pt.train.forward"][0])
    assert by["pt.train.forward"][0][1] <= by["pt.train.backward"][0][0]
    assert by["pt.train.backward"][0][1] <= by["pt.train.adam"][0][0]


def test_span_stats_take_the_parent_chain(scene):
    prof = profiler.get_profiler()
    with profiler.profile("Pt_Trace"):
        _traced(lambda: _render(scene))
    assert prof.stats["Pt_Trace/pt.trace"].calls >= 1
    assert prof.stats["Pt_Trace/pt.trace/pt.bounce"].calls >= SPP * BOUNCES
    assert prof.stats["Pt_Trace/pt.trace/pt.bounce/pt.nee/pt.shadow"].calls >= SPP * BOUNCES


def test_render_counters(scene):
    _traced(lambda: _render(scene))
    c = profiler.counters()
    live = c["bounce.live"]
    assert len(live) == BOUNCES + 1 and live[0] == W * H * SPP
    assert all(a >= b for a, b in zip(live, live[1:]))
    # every segment's live lanes are the closest-hit calls' live lanes
    assert c["isect.live"] == sum(live) and c["isect.lanes"] == W * H * SPP * (BOUNCES + 1)
    for k in ("isect", "shadow"):
        assert 0 < c[f"{k}.live"] <= c[f"{k}.lanes"], k


def test_bake_counts_the_live_texels(scene, pack):
    _traced(lambda: _bake(scene, pack))
    c = profiler.counters()
    n = pack.position.shape[1]
    assert c["bake.lanes"] == n
    assert c["bake.live"] == int((pack.sample_counts > 0).sum()) < n
    assert c["bounce.live"][0] == n
    for k in ("isect", "shadow"):
        assert c[f"{k}.live"] <= c[f"{k}.lanes"], k
