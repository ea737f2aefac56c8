"""The harness's arithmetic: the window rate, the p95 of frame times, the
roofline's bytes, and what a profiled window reads as busy, idle and by
whom launched."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from vxbench import harness, stats, trace

HOME = harness.HOME


def test_rate_and_p95_with_a_stall():
    frames = [0.030] * 399 + [0.500]  # one stalled frame of 400
    assert stats.ms_per_sample(sum(frames), len(frames)) == pytest.approx(1000 * (0.030 * 399 + 0.5) / 400)
    assert stats.p95_ms(frames) == pytest.approx(30.0)
    frames = [0.030] * 380 + [0.500] * 20  # 5% stalled: the p95 sits on the edge
    assert 30.0 < stats.p95_ms(frames) <= 500.0
    frames = [0.030] * 370 + [0.500] * 30
    assert stats.p95_ms(frames) == pytest.approx(500.0)


def _frame(index, mode="default", traced=True):
    return harness.Frame(index, mode, 0.0, 0.01, 0.03, traced)


def test_camera_leg_roofline_pairs_each_frames_camera_call_with_its_bytes():
    """Bytes and time of the same calls: each frame's first call of the
    mode's sample leg, with the lanes in the box, the LUT and the field's
    reachable bricks; the bounce's calls count neither."""
    roof = harness.reader(HOME, "camera_leg_roofline")
    leg = "void dda_leg_sample_kernel(float const*)"
    w = trace.Window(host_ops=False, frames=[_frame(7), _frame(8)], ops=[
        trace.Op(leg, 1000.0, 1200.0, False, True), trace.Op(leg, 1300.0, 1700.0, False, True),  # frame 8
        trace.Op(leg, 0.0, 100.0, False, True), trace.Op(leg, 150.0, 450.0, False, True),  # frame 7
        trace.Op("void dda_leg_shadow_kernel(float const*)", 300.0, 400.0, False, True),
        trace.Op("elementwise_kernel", 500.0, 900.0, True, True)], start=0.0, end=2000.0)
    run = SimpleNamespace(windows=[w], in_box={7: 1_000_000, 8: 500_000}, field_bytes={"default": 10**8})
    bytes_ = 1_500_000 * 90 + 2 * (128 * 16 + 10**8)
    assert roof.read(run) == pytest.approx(100.0 * (bytes_ / 3.35e12) / 300e-6)
    w.ops = w.ops[1:]  # three calls for two frames: not told apart by frame
    assert roof.read(run) is None
    assert roof.read(SimpleNamespace(windows=[], in_box={}, field_bytes={})) is None


def test_busy_idle_and_launch_counts_of_a_window():
    ops = [trace.Op("a", 10.0, 20.0, True, True), trace.Op("b", 15.0, 30.0, False, True),
           trace.Op("Memcpy DtoD", 40.0, 50.0, True, False), trace.Op("c", 70.0, 80.0, True, True)]
    w = trace.Window(frames=[_frame(1), _frame(2)], ops=ops, start=0.0, end=100.0)
    quiet = trace.Window(frames=w.frames, ops=ops, start=0.0, end=80.0, host_ops=False)
    assert w.busy_s() == pytest.approx((20 + 10 + 10) / 1e6)
    untraced = [harness.Frame(9, "default", 0.0, 0.01, 40e-6, False)]
    run = SimpleNamespace(windows=[w, quiet], frames=untraced + w.frames)
    # 40 us busy over the quiet window's two frames, 40 us a frame before them
    assert harness.reader(HOME, "idle_share").read(run) == pytest.approx(50.0)
    assert harness.reader(HOME, "launches_per_sample").read(run) == pytest.approx(1.5)
    assert harness.reader(HOME, "aten_ms_per_sample").read(run) == pytest.approx(1000 * (10 + 10 + 10) / 1e6 / 2)
    assert harness.reader(HOME, "kernel_ms_per_sample").read(run) == pytest.approx(1000 * 15 / 1e6 / 2)
    host = [SimpleNamespace(time_range=SimpleNamespace(start=0.0, end=12.0), name="aten::mul"),
            SimpleNamespace(time_range=SimpleNamespace(start=31.0, end=60.0), name="aten::cat")]
    gaps = trace.idle_gaps(w, host)
    assert [g[0] for g in gaps] == ["aten::mul", "host: no op", "aten::cat", "host: no op"]
    assert [round(g[1] * 1e6) for g in gaps] == [10, 10, 20, 20]
    assert trace.top(gaps, 2) == [["host: no op", pytest.approx(30e-6)], ["aten::cat", pytest.approx(20e-6)]]


def test_enqueue_leaves_the_traced_frames_out():
    frames = [_frame(1, traced=False), _frame(2, traced=True)]
    frames[1].enqueue_s = 9.0
    assert harness.reader(HOME, "enqueue_ms").read(SimpleNamespace(frames=frames)) == pytest.approx(10.0)


def test_idle_share_weighs_each_modes_host_time_as_the_traced_frames():
    """The spec cell's traced frames hold its modes in another mix than its
    untraced frames: each mode's fenced time counts by its traced frames."""
    untraced = [harness.Frame(i, "default", 0.0, 0.01, 40e-6, False) for i in range(30)]
    untraced += [harness.Frame(i, "no_dda", 0.0, 0.01, 120e-6, False) for i in range(10)]
    traced = [_frame(1, "default"), _frame(2, "no_dda")]
    quiet = trace.Window(frames=traced, ops=[trace.Op("a", 0.0, 80.0, True, True)], start=0.0, end=200.0,
                         host_ops=False)
    run = SimpleNamespace(windows=[quiet], frames=untraced + traced)
    # 40 us busy a traced frame against (40 + 120) / 2 us a frame fenced
    assert harness.reader(HOME, "idle_share").read(run) == pytest.approx(50.0)
    quiet.frames = [_frame(1, "raymarch")]  # a traced mode with no untraced frame
    assert harness.reader(HOME, "idle_share").read(run) is None
