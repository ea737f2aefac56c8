"""The port's spans and counters (utils/profiling.py) on the CPU: off by
default, where each stage of a frame lies and what it nests in, frames
unchanged by them, the later bounces' span and live lanes, the legs'
counter against utils/stepstats' counts, and the ingest's stages."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu_torch import Renderer
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.render import modes
from volxel_tpu_torch.render.ddaleg import DDA_SAMPLE_MAX_STEPS, DDA_TRANSMITTANCE_MAX_STEPS
from volxel_tpu_torch.render.pathtrace import camera_wavefront
from volxel_tpu_torch.render.trackleg import TRACKING_MAX_EVENTS
from volxel_tpu_torch.utils import fixtures, profiling

SIZE = 16

# (span, its parent) that a small frame of each kind holds, besides the
# RNG's and the environment's spans inside these stages
FRAME_SPANS = {
    "default": {("vx::render_frame", None), ("vx::operands", "vx::render_frame"),
                ("vx::camera", "vx::render_frame"), ("vx::rng", "vx::camera"),
                ("vx::premul_majorant", "vx::render_frame"), ("vx::trace_path", "vx::render_frame"),
                ("vx::sample_leg", "vx::trace_path"), ("vx::leg", "vx::sample_leg"), ("vx::rng", "vx::sample_leg"),
                ("vx::escape", "vx::trace_path"), ("vx::env", "vx::escape"), ("vx::nee", "vx::trace_path"),
                ("vx::rng", "vx::nee"), ("vx::env", "vx::nee"), ("vx::shadow_leg", "vx::nee"),
                ("vx::leg", "vx::shadow_leg"), ("vx::scatter", "vx::trace_path"), ("vx::rng", "vx::scatter"),
                ("vx::accumulate", "vx::render_frame")},
    "gradient": {("vx::render_frame", None), ("vx::operands", "vx::render_frame"),
                 ("vx::camera", "vx::render_frame"), ("vx::rng", "vx::camera"),
                 ("vx::premul_majorant", "vx::render_frame"), ("vx::shade", "vx::render_frame"),
                 ("vx::sample_leg", "vx::shade"), ("vx::leg", "vx::sample_leg"), ("vx::shadow_leg", "vx::shade"),
                 ("vx::leg", "vx::shadow_leg"), ("vx::env", "vx::shade"), ("vx::accumulate", "vx::render_frame")},
}


def _volume():
    vol = fixtures.synthetic_ct_volume((32, 32, 32), bits_stored=12)
    return vol.astype(np.float32) / vol.max()


def _renderer(mode="default", **settings):
    r = Renderer(SIZE, SIZE, device="cpu")
    r.restart_from_grid(construct_brick_grid(_volume(), transform=np.eye(4, dtype=np.float32)))
    r.settings.bounces = 1
    for key, value in settings.items():
        setattr(r.settings, key, value)
    r.render_mode = mode
    return r


def _vx_chain(event) -> list:
    """The vx:: spans above a profiler event, innermost first."""
    chain = []
    while event is not None:
        if event.name.startswith("vx::"):
            chain.append(event.name)
        event = event.cpu_parent
    return chain


def test_spans_are_off_by_default():
    """Off, span() is the shared no-op context, whatever its name and
    arguments, and neither spans nor counts are kept."""
    profiling.take_spans(), profiling.take_counts()
    assert profiling.span("vx::a") is profiling.span("vx::b", bounce=1) is profiling._NOOP
    with profiling.span("vx::a"):
        profiling.count("dda_leg_sample", torch.zeros(4, dtype=torch.int32), 8)
    assert profiling.take_spans() == [] and profiling.take_counts() == {}
    with profiling.spans():
        assert profiling.span("vx::a") is not profiling._NOOP
        with profiling.spans(on=False):
            assert profiling.span("vx::a") is profiling._NOOP
    assert profiling.span("vx::a") is profiling._NOOP


def test_span_names_and_args():
    """Spans keep their parent, their arguments as text and their host
    times; no name a profiler gives to ATen ops or the CUDA runtime."""
    profiling.take_spans()
    with profiling.spans():
        with profiling.span("vx::render_frame", frame=7, mode="default"):
            with profiling.span("vx::rng"):
                pass
    (inner, parent, args, t0, t1), outer = profiling.take_spans()
    assert (inner, parent, args) == ("vx::rng", "vx::render_frame", None) and t0 <= t1
    assert outer[:3] == ("vx::render_frame", None, "frame=7 mode=default")
    assert outer[3] <= t0 and t1 <= outer[4]


@pytest.mark.parametrize("kind", ["default", "gradient"])
def test_a_frames_stages_nest_and_hold_every_aten_op(kind):
    """A frame rendered with spans on under the profiler holds every stage
    of its kind with the nesting of FRAME_SPANS, and every ATen op
    launched in render_frame lies under a stage span below it."""
    r = _renderer(gradient_shading=(kind == "gradient"))
    for _ in range(6):  # past the warm-up samples
        r.render_frame()
    profiling.take_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof, profiling.spans():
        r.render_frame()
    pairs = {(name, parent) for name, parent, *_ in profiling.take_spans()}
    assert FRAME_SPANS[kind] <= pairs, FRAME_SPANS[kind] - pairs
    assert all(parent is not None for name, parent in pairs if name != "vx::render_frame")
    events = prof.events()
    assert sum(e.name == "vx::render_frame" for e in events) == 1
    outermost = [e for e in events if e.name.startswith("aten::")
                 and not (e.cpu_parent is not None and e.cpu_parent.name.startswith("aten::"))]
    in_frame = [e for e in outermost if "vx::render_frame" in _vx_chain(e)]
    assert len(in_frame) > 100
    loose = [e.name for e in in_frame if len(_vx_chain(e)) < 2]
    assert not loose, loose


def test_trace_writes_the_stages(tmp_path):
    """trace() turns spans on: an operator's Chrome trace names the stages
    over the ops."""
    r = _renderer()
    with profiling.trace(tmp_path / "trace") as out:
        r.render_frame()
    names = {e.get("name") for e in json.loads((out / "trace.json").read_text())["traceEvents"]}
    assert {"vx::render_frame", "vx::camera", "vx::sample_leg", "vx::leg"} <= names
    assert profiling.span("vx::a") is profiling._NOOP
    profiling.take_spans(), profiling.take_counts()


def _framebuffers_on_and_off(mode, **settings):
    """The framebuffers after the same 7 frames with spans and counters
    off, then on; what they recorded is taken."""
    fbs = []
    for on in (False, True):
        r = _renderer(mode, **settings)
        with profiling.spans(on):
            for _ in range(7):
                fb = r.render_frame().clone()
        fbs.append(fb)
    counts = profiling.take_counts()
    profiling.take_spans(), profiling.take_live_lanes()
    return fbs, counts


@pytest.mark.parametrize("mode", ["default", "no_dda", "raymarch"])
def test_framebuffers_are_equal_with_tracing_on_and_off(mode):
    """Spans and counters change nothing a frame computes: the same frames
    with them on and off give byte-equal framebuffers."""
    fbs, counts = _framebuffers_on_and_off(mode)
    assert counts or mode == "raymarch"
    assert fbs[0].numpy().tobytes() == fbs[1].numpy().tobytes()


@pytest.mark.parametrize("mode", ["default", "no_dda", "raymarch"])
def test_framebuffers_are_equal_with_tracing_on_and_off_at_bounces_3(mode):
    """The later bounces' span and live lanes change nothing either."""
    fbs, counts = _framebuffers_on_and_off(mode, bounces=3)
    assert counts or mode == "raymarch"
    assert fbs[0].numpy().tobytes() == fbs[1].numpy().tobytes()


@pytest.mark.parametrize("bounces", [1, 2, 3])
def test_later_bounces_open_their_span_and_keep_their_live_lanes(bounces):
    """With spans on, vx::bounce.later opens bounces - 1 times a frame,
    inside vx::trace_path, and never at bounces 1; the lanes alive at each
    later bounce's start never rise from one bounce to the next; the legs'
    counter holds the same keys as at one bounce, none for the bounces."""
    r = _renderer(bounces=bounces)
    for _ in range(6):
        r.render_frame()
    profiling.take_spans(), profiling.take_counts(), profiling.take_live_lanes()
    live_at_2 = 0
    for _ in range(3):
        with profiling.spans():
            r.render_frame()
        later = [(parent, args) for name, parent, args, *_ in profiling.take_spans() if name == "vx::bounce.later"]
        assert later == [("vx::trace_path", f"bounce={b}") for b in range(1, bounces)]
        live = profiling.take_live_lanes()
        assert sorted(live) == list(range(1, bounces))
        lanes = [SIZE * SIZE] + [live[b]["lanes"] for b in sorted(live)]
        assert all(c["calls"] == 1 and c["wavefront"] == SIZE * SIZE for c in live.values())
        assert all(a >= b for a, b in zip(lanes, lanes[1:])), lanes
        live_at_2 += live.get(1, {"lanes": 0})["lanes"]
        assert set(profiling.take_counts()) == {"dda_leg_sample", "dda_leg_shadow"}
    assert live_at_2 > 0 or bounces == 1
    with profiling.spans(on=False):
        assert profiling.bounce_span(1, torch.ones(4, dtype=torch.bool)) is profiling._NOOP
    with profiling.spans():
        assert profiling.bounce_span(0, torch.ones(4, dtype=torch.bool)) is profiling._NOOP
    assert profiling.take_live_lanes() == {} and profiling.take_spans() == []


def _legs_on_camera_rays(r, mode):
    """The mode's camera leg on the frame's camera rays, then its shadow leg
    from the hits toward the light, with_stats; returns the two legs' step
    counts, as utils/stepstats' study takes them."""
    config = r._config()._replace(mode=mode)
    grid, params, lut = r._device_grid, r.volume_params(), r._lut
    if mode == "default":
        grid = grid._replace(maj_alpha=modes.build_premul_majorant(grid.maj_mips, params, lut).contiguous())
    inv_view, inv_proj, light = r._camera_operands(config)
    pixels = torch.arange(SIZE * SIZE)
    state, rays = camera_wavefront(config, inv_view, inv_proj, pixels, 5)
    sample_volume, transmittance = modes.get_mode_functions(mode)
    active = torch.ones(pixels.shape, dtype=torch.bool)
    state, hit, t, *_, s_steps = sample_volume(grid, params, lut, rays.origin, rays.direction, state, active,
                                               with_stats=True)
    origin = rays.origin + t[..., None] * rays.direction
    direction = (-light / torch.linalg.norm(light)).expand_as(origin).contiguous()
    state, _, t_steps = transmittance(grid, params, lut, origin, direction, state, hit, with_stats=True)
    return s_steps, t_steps, hit


@pytest.mark.parametrize("mode,legs", [("default", ("dda_leg_sample", "dda_leg_shadow")),
                                       ("no_dda", ("track_leg_sample", "track_leg_shadow"))])
def test_leg_counter_steps_equal_stepstats_counts(mode, legs):
    """The counter's steps of each leg call are the sum of the with_stats
    counts of that call; its lanes those that took a step; nothing is
    counted with spans off."""
    r = _renderer(mode)
    profiling.take_counts()
    _legs_on_camera_rays(r, mode)
    assert profiling.take_counts() == {}
    with profiling.spans():
        s_steps, t_steps, hit = _legs_on_camera_rays(r, mode)
    counts = profiling.take_counts()
    profiling.take_spans()
    assert set(counts) == set(legs)
    for leg, steps in zip(legs, (s_steps, t_steps)):
        assert counts[leg] == {"calls": 1, "lanes": int((steps > 0).sum()), "steps": int(steps.sum())}
    assert counts[legs[0]]["steps"] > 0 and 0 < counts[legs[1]]["lanes"] <= int(hit.sum())


@pytest.mark.parametrize("mode,caps", [("default", (DDA_SAMPLE_MAX_STEPS, DDA_TRANSMITTANCE_MAX_STEPS)),
                                       ("no_dda", (TRACKING_MAX_EVENTS, TRACKING_MAX_EVENTS))])
def test_a_lane_that_does_not_run_returns_its_cap(mode, caps):
    """Lanes that do not run keep the whole cap as their budget or events
    left, so the counter counts them no step."""
    r = _renderer(mode)
    config = r._config()
    grid, params, lut = r._device_grid, r.volume_params(), r._lut
    if mode == "default":
        grid = grid._replace(maj_alpha=modes.build_premul_majorant(grid.maj_mips, params, lut).contiguous())
    inv_view, inv_proj, _ = r._camera_operands(config)
    state, rays = camera_wavefront(config, inv_view, inv_proj, torch.arange(SIZE * SIZE), 5)
    idle = torch.zeros(SIZE * SIZE, dtype=torch.bool)
    sample_volume, transmittance = modes.get_mode_functions(mode)
    with profiling.spans():
        *_, s_steps = sample_volume(grid, params, lut, rays.origin, rays.direction, state, idle, with_stats=True)
        *_, t_steps = transmittance(grid, params, lut, rays.origin, rays.direction, state, idle, with_stats=True)
    counts = profiling.take_counts()
    profiling.take_spans()
    assert not s_steps.any() and not t_steps.any()
    assert all(c == {"calls": 1, "lanes": 0, "steps": 0} for c in counts.values()) and len(counts) == 2


def test_ingest_and_upload_spans():
    """A ZIP's load with spans on holds the ingest's three stages, in
    order, and the grid's upload."""
    vol = fixtures.synthetic_ct_volume((24, 24, 24), bits_stored=12)
    data = fixtures.write_dicom_zip(vol, bits_stored=12)
    r = Renderer(SIZE, SIZE, device="cpu")
    profiling.take_spans()
    with profiling.spans():
        r.restart_from_zip(data)
    names = [name for name, *_ in profiling.take_spans()]
    assert names == ["vx::ingest.parse", "vx::ingest.scan", "vx::ingest.grid", "vx::grid.upload"]
