"""The benchmark's reduction of the stackless pass by the program's spans
(`pimbench/spans.py`), on a hand-built Chrome trace, and its readers."""

import pytest

from pimbench import spans
from pimbench.metrics import (device_idle_share_spans, host_ms_per_step, live_ray_share,
                              live_texel_share, sort_ms_per_step)

MAIN = (1, 1)
SIDE = (1, 2)   # a second host thread (autograd's device thread)
GPU = (0, 7)


def _x(cat, name, ts, dur, th, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": th[0],
         "tid": th[1]}
    if args:
        e["args"] = args
    return e


def _launch(corr, ts, th, kernel, k_ts, k_dur):
    return [_x("cuda_runtime", "cudaLaunchKernel", ts, 2, th, correlation=corr),
            _x("kernel", kernel, k_ts, k_dur, GPU, correlation=corr)]


def trace():
    """Window [0, 1000] on the main thread: pt.trace [10, 500] holding
    pt.bounce [20, 300] holding pt.isect [30, 100] holding pt.sort [40, 50];
    pt.accumulate [600, 690].  Kernels: k_isect launched in pt.isect, k_sort
    in pt.sort, k_bounce in pt.bounce, cat between the spans, k_acc in
    pt.accumulate, k_side from the second thread while the main thread is
    in pt.bounce."""
    ev = [_x("user_annotation", spans.WINDOW_SPAN, 0, 1000, MAIN),
          _x("user_annotation", "pt.trace", 10, 490, MAIN),
          _x("user_annotation", "pt.bounce", 20, 280, MAIN),
          _x("user_annotation", "pt.isect", 30, 70, MAIN),
          _x("user_annotation", "pt.sort", 40, 10, MAIN),
          _x("user_annotation", "pt.accumulate", 600, 90, MAIN),
          _x("user_annotation", "Optimizer.step", 610, 5, MAIN),    # not a pt.* span
          _x("gpu_user_annotation", "pt.trace", 100, 200, GPU)]     # the device's copy
    ev += _launch(1, 35, MAIN, "k_isect", 100, 10)
    ev += _launch(2, 45, MAIN, "k_sort", 110, 20)
    ev += _launch(3, 200, MAIN, "k_bounce", 200, 40)
    ev += _launch(4, 550, MAIN, "cat", 550, 10)
    ev += _launch(5, 650, MAIN, "k_acc", 650, 50)
    ev += _launch(6, 250, SIDE, "k_side", 260, 20)
    return ev


@pytest.fixture
def s():
    return spans.reduce(trace(), 2, {"bounce.live": [8, 5], "isect.lanes": 16,
                                     "isect.live": 12, "shadow.lanes": 8, "shadow.live": 4,
                                     "bake.lanes": 10, "bake.live": 1})


def test_kernels_take_the_innermost_span(s):
    b = s.by_span
    assert b["pt.sort"].device_self_us == 20 and b["pt.sort"].kernels == 1
    assert b["pt.isect"].device_self_us == 10 and b["pt.isect"].kernels_self == 1
    assert b["pt.accumulate"].device_self_us == 50
    assert s.harness_ops == {"cat": [10.0, 1]}
    assert set(b) == {"pt.trace", "pt.bounce", "pt.isect", "pt.sort", "pt.accumulate"}


def test_a_launch_on_another_thread_takes_the_main_threads_span(s):
    # k_bounce 40 + k_side 20, launched while the main thread is in pt.bounce
    assert s.by_span["pt.bounce"].device_self_us == 60
    assert s.by_span["pt.bounce"].kernels_self == 2


def test_self_time_is_inclusive_minus_the_children(s):
    b = s.by_span
    assert b["pt.isect"].device_us == 30 and b["pt.isect"].kernels == 2
    assert b["pt.bounce"].device_us == 90 and b["pt.trace"].device_us == 90
    assert b["pt.trace"].device_self_us == 0
    assert b["pt.bounce"].host_us == 280 and b["pt.bounce"].host_self_us == 280 - 70
    assert b["pt.isect"].host_self_us == 70 - 10
    assert b["pt.trace"].host_self_us == 490 - 280
    for st in b.values():
        assert st.device_self_us <= st.device_us and st.host_self_us <= st.host_us
    assert s.top_host_us == 490 + 90


def test_idle_gaps_go_to_the_span_open_at_their_start(s):
    # device busy [100,130] [200,240] [260,280] [550,560] [650,700]
    assert s.busy_us == 30 + 40 + 20 + 10 + 50
    assert s.gaps == {"harness": 100 + 90 + 300, "pt.bounce": 70 + 20 + 270}
    assert sum(s.gaps.values()) + s.busy_us == s.window_us == 1000


def test_device_time_is_conserved(s):
    self_sum = sum(st.device_self_us for st in s.by_span.values())
    assert self_sum + s.harness_device_us() == s.device_us == 150


def test_the_readers(s):
    class T:
        pass

    t = T()
    t.spans = s
    assert host_ms_per_step.read(t, "render") == pytest.approx(580 / 2 / 1e3)
    assert live_ray_share.read(t, "render") == pytest.approx(100.0 * 16 / 24)
    assert live_texel_share.read(t, "bake") == pytest.approx(10.0)
    assert device_idle_share_spans.read(t, "render") == pytest.approx(100.0 * (1 - 150 / 1000))
    assert sort_ms_per_step.read(t, "render") == pytest.approx(20 / 2 / 1e3)


def test_report_prints_every_table(s, capsys):
    import sys

    spans.report(s, out=sys.stdout)
    out = capsys.readouterr().out
    for word in ("pt.bounce", "idle gaps by span", "bounce.live: [8, 5]", "counters:",
                 "device time in pt.* spans: 0.140 of 0.150 ms (93.333%)"):
        assert word in out, word


def test_no_pass_without_a_harness_run_or_without_tracing(monkeypatch):
    """A reader called outside the harness's main, or over a program
    without the tracing switch (an older tree), reads nothing and runs no
    pass."""
    from pim_tpu_torch.core import profiler

    class T:
        pass

    assert spans.of(T()) is None
    assert host_ms_per_step.read(T(), "render") is None
    assert live_ray_share.read(T(), "render") is None
    monkeypatch.delattr(profiler, "set_tracing")
    assert not spans.program_traces()
    monkeypatch.setattr(spans, "_harness_run", lambda: (None, None))
    assert spans.of(T()) is None
    assert sort_ms_per_step.read(T(), "bake") is None


def test_the_window_must_be_there():
    with pytest.raises(RuntimeError, match="expected 1"):
        spans.reduce([e for e in trace() if e["name"] != spans.WINDOW_SPAN], 1)
