"""The readers of the program's stages (vxbench/stages.py): each new reader
on synthetic windows whose ops carry the program's spans, the harness's
own readers unchanged by spans on the ops, and what a profile's events
give each op, sync and window."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from vxbench import harness, stages, trace

HOME = harness.HOME
FRAME = ("vx::render_frame",)
RNG = FRAME + ("vx::camera", "vx::rng")
ENV = FRAME + ("vx::trace_path", "vx::nee", "vx::env")
LEG = FRAME + ("vx::trace_path", "vx::sample_leg", "vx::leg")
SHADE_LEG = FRAME + ("vx::shade", "vx::shadow_leg", "vx::leg")


def _frame(index, mode="default"):
    return harness.Frame(index, mode, 0.0, 0.01, 0.03, True)


def _op(name, start, end, spans=(), aten=True, kernel=True):
    return stages.SpanOp(name, start, end, aten, kernel, spans)


def _staged():
    """Two windows of one and two frames: 3 frames in all."""
    w1 = stages.SpanWindow(frames=[_frame(10)], start=0.0, end=1000.0, ops=[
        _op("elementwise_kernel", 0.0, 100.0, RNG),
        _op("elementwise_kernel", 100.0, 150.0, RNG),
        _op("Memcpy HtoD (Pageable -> Device)", 150.0, 151.0, FRAME + ("vx::operands",), kernel=False),
        _op("gather_f32_kernel", 200.0, 260.0, ENV, aten=False),
        _op("void dda_leg_sample_kernel(float const*)", 300.0, 500.0, LEG, aten=False),
        _op("void tile_march_sample_kernel(float const*)", 500.0, 600.0, LEG, aten=False),
        _op("Memcpy HtoD (Pageable -> Device)", 700.0, 701.0, (), kernel=False)],  # the harness's, outside
        syncs=[("cudaStreamSynchronize", FRAME + ("vx::shade",)), ("cudaDeviceSynchronize", ())],
        counters={"dda_leg_sample": {"calls": 1, "lanes": 50, "steps": 1000}})
    w2 = stages.SpanWindow(frames=[_frame(20, "no_dda"), _frame(21, "no_dda")], start=0.0, end=2000.0, ops=[
        _op("elementwise_kernel", 0.0, 300.0, RNG),
        _op("Memset (Device)", 300.0, 310.0, RNG, kernel=False),
        _op("reduce_kernel", 400.0, 1000.0, FRAME + ("vx::shade",)),
        _op("void track_leg_shadow_kernel(float const*)", 1000.0, 1400.0, SHADE_LEG, aten=False),
        _op("Memcpy HtoD (Pageable -> Device)", 1400.0, 1401.0, FRAME + ("vx::camera",), kernel=False)],
        syncs=[("cudaStreamSynchronize", FRAME + ("vx::trace_path",))],
        counters={"track_leg_shadow": {"calls": 2, "lanes": 10, "steps": 3000}})
    setup = [("vx::ingest.parse", None, None, 0, 2_500_000_000), ("vx::ingest.scan", None, None, 0, 10**9),
             ("vx::grid.upload", None, None, 0, 10**8)]
    return stages.Staged([w1, w2], setup)


def _read(name, staged):
    return harness.reader(HOME, name).read(SimpleNamespace(stages=staged))


def test_each_new_reader_on_windows_whose_ops_carry_spans():
    staged = _staged()
    assert _read("rng_ms_per_sample", staged) == pytest.approx((100 + 50 + 300 + 10) / 1000 / 3)
    assert _read("rng_launches_per_sample", staged) == pytest.approx(3 / 3)  # the set is no kernel
    assert _read("env_ms_per_sample", staged) == pytest.approx(60 / 1000 / 3)
    assert _read("shade_ms_per_sample", staged) == pytest.approx((600 + 400) / 1000 / 3)
    assert _read("host_syncs_per_sample", staged) == pytest.approx(2 / 3)  # the fence outside the frame left out
    assert _read("uploads_per_sample", staged) == pytest.approx(2 / 3)
    # the DDA and tracking legs' kernels over their steps; the raymarch leg's kernel is not counted
    assert _read("leg_ns_per_step", staged) == pytest.approx(1000 * (200 + 400) / (1000 + 3000))
    assert _read("ingest_parse_s", staged) == pytest.approx(2.5)


def test_new_readers_without_stages():
    """No Staged (a program without spans, a run without a card), no frames,
    no gradient shading, no ZIP: no value."""
    names = ["rng_ms_per_sample", "rng_launches_per_sample", "env_ms_per_sample", "shade_ms_per_sample",
             "host_syncs_per_sample", "uploads_per_sample", "leg_ns_per_step", "ingest_parse_s"]
    assert all(_read(name, None) is None for name in names)
    empty = stages.Staged([], [])
    assert all(_read(name, empty) is None for name in names)
    staged = _staged()
    for w in staged.windows:
        w.ops = [o for o in w.ops if "vx::shade" not in o.spans]
        w.counters = {}
    staged.setup_spans = staged.setup_spans[1:]
    assert _read("shade_ms_per_sample", staged) is None
    assert _read("leg_ns_per_step", staged) is None
    assert _read("ingest_parse_s", staged) is None


def _plain(window):
    """The window with trace.Op records, as the harness builds them."""
    ops = [trace.Op(o.name, o.start, o.end, o.aten, o.kernel) for o in window.ops]
    return trace.Window(frames=window.frames, ops=ops, start=window.start, end=window.end,
                        host_ops=window.host_ops)


@pytest.mark.parametrize("name", ["aten_ms_per_sample", "launches_per_sample", "kernel_ms_per_sample",
                                  "idle_share", "camera_leg_roofline"])
def test_existing_readers_read_the_same_with_spans_on_the_ops(name):
    staged = _staged()
    quiet = []
    for w in staged.windows:
        q = stages.SpanWindow(frames=w.frames, ops=w.ops, start=w.start, end=w.end, host_ops=False)
        quiet.append(q)
    windows = staged.windows + quiet
    untraced = [harness.Frame(i, mode, 0.0, 0.01, 0.004, False) for i in range(5) for mode in ("default", "no_dda")]
    frames = untraced + [f for w in staged.windows for f in w.frames]
    extra = dict(in_box={10: 1000, 20: 500, 21: 700}, field_bytes={"default": 10**6, "no_dda": 10**6})
    with_spans = SimpleNamespace(windows=windows, frames=frames, **extra)
    without = SimpleNamespace(windows=[_plain(w) for w in windows], frames=frames, **extra)
    got = harness.reader(HOME, name).read(with_spans)
    assert got is not None and got == harness.reader(HOME, name).read(without)


def _event(name, start, end, parent=None, device=False, id_=0, **extra):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end), cpu_parent=parent,
                           device_type=DeviceType.CUDA if device else DeviceType.CPU, id=id_, **extra)


def test_a_profiles_events_give_each_op_its_spans():
    """Each device op carries the vx:: spans above its launching runtime
    call; a span's range on the device is no op; blocking calls keep their
    spans; a gap inside a stage is labelled by it."""
    frame = _event("vx::render_frame", 100.0, 400.0)
    rng = _event("vx::rng", 110.0, 200.0, frame)
    add = _event("aten::add", 120.0, 130.0, rng)
    launch_add = _event("cudaLaunchKernel", 121.0, 125.0, add, id_=7)
    leg = _event("vx::leg", 250.0, 300.0, frame)
    launch_leg = _event("cudaLaunchKernel", 251.0, 255.0, leg, id_=8)
    sync = _event("cudaStreamSynchronize", 260.0, 290.0, leg)
    fence = _event("cudaDeviceSynchronize", 410.0, 420.0)
    pads = [_event("void spin_kernel(long)", float(t), t + 1.0, device=True) for t in range(trace.PAD + 1)]
    pads += [_event("void spin_kernel(long)", 1000.0 + t, 1001.0 + t, device=True) for t in range(trace.PAD)]
    ops = [_event("vectorized_elementwise_kernel", 140.0, 150.0, device=True, id_=7),
           _event("dda_leg_sample_kernel", 260.0, 270.0, device=True, id_=8),
           _event("vx::render_frame", 140.0, 270.0, device=True, is_user_annotation=True)]
    events = [frame, rng, add, launch_add, leg, launch_leg, sync, fence] + pads + ops
    w = stages.read(events, [_frame(1)], {"dda_leg_sample_kernel": 1})
    assert [(o.name, o.spans, o.aten) for o in w.ops] == [
        ("vectorized_elementwise_kernel", ("vx::render_frame", "vx::rng"), True),
        ("dda_leg_sample_kernel", ("vx::render_frame", "vx::leg"), False)]
    assert w.syncs == [("cudaStreamSynchronize", ("vx::render_frame", "vx::leg")), ("cudaDeviceSynchronize", ())]
    assert w.annotations == 1
    assert ("vx::rng", pytest.approx(110e-6)) in w.gaps  # from the add's end, inside vx::rng, to the leg
    assert w.stage_gaps == [("no span", pytest.approx(107e-6)), ("vx::rng", pytest.approx(110e-6)),
                            ("vx::leg", pytest.approx(730e-6))]
    assert stages.read(events, [_frame(1)], {"dda_leg_sample_kernel": 2}) is None  # a lost record


def test_no_stages_without_spans_in_the_program_or_a_card(monkeypatch):
    from volxel_tpu_torch.utils import profiling

    run = SimpleNamespace(windows=[trace.Window(frames=[_frame(1)], ops=[], start=0.0, end=1.0)])
    monkeypatch.setattr(stages.torch.cuda, "is_available", lambda: False)
    assert stages.of(run) is None and run.stages is None
    monkeypatch.setattr(stages.torch.cuda, "is_available", lambda: True)
    monkeypatch.delattr(profiling, "spans")
    assert stages.measure(run) is None
