"""The readers of the path tracer's later bounces (later_bounce_ms_per_sample,
later_bounce_launches_per_sample) on hand-built staged windows: the device
ms and the kernels under vx::bounce.later a frame, and no value where no
frame was staged or no op lies under the span (a program without it, or
frames of one bounce)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from vxbench import harness, stages

HOME = harness.HOME
NAMES = ["later_bounce_ms_per_sample", "later_bounce_launches_per_sample"]
PATH = ("vx::render_frame", "vx::trace_path")
LATER = PATH + ("vx::bounce.later",)


def _frame(index):
    return harness.Frame(index, "default", 0.0, 0.01, 0.03, True)


def _op(name, start, end, spans, kernel=True):
    return stages.SpanOp(name, start, end, True, kernel, spans)


def _staged():
    """Two windows of one and two frames: 3 frames in all."""
    w1 = stages.SpanWindow(frames=[_frame(10)], start=0.0, end=1000.0, ops=[
        _op("void dda_leg_sample_kernel(float const*)", 0.0, 100.0, PATH + ("vx::sample_leg", "vx::leg")),
        _op("void dda_leg_sample_kernel(float const*)", 100.0, 160.0, LATER + ("vx::sample_leg", "vx::leg")),
        _op("elementwise_kernel", 160.0, 200.0, LATER + ("vx::nee", "vx::env")),
        _op("Memset (Device)", 200.0, 205.0, LATER + ("vx::scatter", "vx::rng"), kernel=False)])
    w2 = stages.SpanWindow(frames=[_frame(20), _frame(21)], start=0.0, end=2000.0, ops=[
        _op("elementwise_kernel", 0.0, 300.0, PATH + ("vx::escape",)),
        _op("reduce_kernel", 300.0, 700.0, LATER + ("vx::escape",)),
        _op("void dda_leg_shadow_kernel(float const*)", 700.0, 900.0, LATER + ("vx::nee", "vx::shadow_leg", "vx::leg")),
        _op("Memcpy HtoD (Pageable -> Device)", 900.0, 901.0, ("vx::render_frame", "vx::operands"), kernel=False)])
    return stages.Staged([w1, w2], [])


def _read(name, staged):
    return harness.reader(HOME, name).read(SimpleNamespace(stages=staged))


def test_the_ms_and_the_kernels_under_the_later_bounces_a_frame():
    staged = _staged()
    assert _read("later_bounce_ms_per_sample", staged) == pytest.approx((60 + 40 + 5 + 400 + 200) / 1000 / 3)
    assert _read("later_bounce_launches_per_sample", staged) == pytest.approx(4 / 3)  # the set is no kernel


@pytest.mark.parametrize("name", NAMES)
def test_no_value_without_staged_frames_or_the_span(name):
    assert _read(name, None) is None
    assert _read(name, stages.Staged([], [])) is None
    staged = _staged()
    for w in staged.windows:
        w.ops = [o for o in w.ops if "vx::bounce.later" not in o.spans]  # frames of one bounce, or the parent
    assert _read(name, staged) is None

