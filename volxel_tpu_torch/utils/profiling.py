"""Tracing / profiling utilities: the PyTorch counterpart of
volxel_tpu.utils.profiling, with named spans and counters inside the port.

The reference's instrumentation is gl.finish-fenced frame timers
(viewer.ts:1213-1218), ingest wall-clock logs (lib.rs:144-179), and a
device fingerprint. Here:

  * span(name, **args) — a named stage of the program. Off (the default)
    it is one read of a module flag and the shared no-op context. On
    (inside `spans()`), it enters torch.profiler.record_function, so a
    running profiler records the stage on its own clock beside the ATen
    ops and the kernels they launch, and it keeps (name, parent, args, t0,
    t1) on the host's perf_counter_ns clock, which `take_spans()` returns
    (the set-up's stages, where no profiler runs)
  * count(key, left, cap) — the legs' counter: while spans are on, keeps a
    reference to a leg call's per-lane work left of its cap (an output the
    kernel writes anyway); `take_counts()` reduces them, so nothing is
    launched before it is read
  * bounce_span(bounce, active) — the span vx::bounce.later around a
    later bounce of the path tracer; while spans are on it keeps a
    reference to the lanes alive at the bounce's start, which
    `take_live_lanes()` reduces, as take_counts() does the legs'
  * trace() — torch.profiler around a code region, spans on, written as a
    Chrome trace (open it in Perfetto or chrome://tracing)
  * fence_device — wait for a card's queued work; nothing on the CPU

An operator's trace with the stages over the kernels:

    from volxel_tpu_torch.utils import profiling
    with profiling.trace("trace_dir"):
        renderer.render_frame()

The spans, each named `vx::<stage>`:

  vx::render_frame      Renderer.render_frame, the warm-up preview too;
                        args `frame=<index> mode=<mode>`
  vx::operands          the frame's uploads: volume parameters, camera
                        matrices, the pixel index, the framebuffer
  vx::camera            seeded RNG words and jittered camera rays
  vx::premul_majorant   the default mode's premultiplied majorant pyramid
  vx::trace_path        the path tracer's bounce loop
  vx::bounce.later      one iteration of that loop after the first
                        (args `bounce=<i>`); never at bounces 1
  vx::sample_leg        a camera/bounce leg: its setup and the leg
                        (args `bounce=<i>`)
  vx::shadow_leg        a shadow leg toward the light, inside vx::nee or
                        vx::shade (args `bounce=<i>`)
  vx::leg               the leg kernel's call (args `leg=<name>`)
  vx::escape            escaped rays' environment radiance with MIS
  vx::nee               next-event estimation toward the environment
  vx::scatter           russian roulette and the phase-function scatter
  vx::shade             gradient shading: the six density lookups, the
                        legs, Blinn-Phong
  vx::rng               every draw of render/rng.py
  vx::env               every lookup and sample of scene/environment.py
  vx::accumulate        the sample folded into the framebuffer
  vx::grid.upload       the brick grid decoded on the renderer's device
  vx::ingest.parse      a ZIP's entries inflated and parsed as DICOM
  vx::ingest.scan       the slices' pixels, histogram and range
  vx::ingest.grid       the brick grid built from the series

No name starts with `aten::` or `cu`, which profilers give to ATen ops and
to the CUDA runtime's calls. A kernel launched inside a nested span
belongs to every span above it.
"""

from __future__ import annotations

import contextlib
import functools
import tempfile
import threading
import time
from pathlib import Path

import torch

_ON = False  # spans and counters are recorded
_SPANS: list = []  # (name, parent, args, t0_ns, t1_ns) of the spans closed while on
_COUNTS: list = []  # (key, left, cap) of the leg calls made while on
_LIVE: list = []  # (bounce, active) of the later bounces begun while on
_STACK = threading.local()  # each thread's open span names


def fence_device(device) -> None:
    """Wait until the card `device` has run everything queued on it (the
    gl.finish of the reference's timers); a CPU device needs no wait."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Span:
    """An open span while spans are on."""

    __slots__ = ("name", "args", "parent", "t0", "rf")

    def __init__(self, name: str, args: str | None):
        self.name, self.args = name, args

    def __enter__(self):
        stack = getattr(_STACK, "names", None)
        if stack is None:
            stack = _STACK.names = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.rf = torch.profiler.record_function(self.name, self.args)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _STACK.names.pop()
        _SPANS.append((self.name, self.parent, self.args, self.t0, t1))
        return False


_NOOP = contextlib.nullcontext()


def span(name: str, **args):
    """The stage `name` (`vx::<stage>`) around a block: the shared no-op
    context while spans are off, else a record_function range with `args`
    as `key=value` text."""
    if not _ON:
        return _NOOP
    return _Span(name, " ".join(f"{k}={v}" for k, v in args.items()) or None)


def spanned(name: str):
    """A decorator: each call of the function is the span `name`."""

    def wrap(fn):
        @functools.wraps(fn)
        def spanned_call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned_call

    return wrap


@contextlib.contextmanager
def spans(on: bool = True):
    """Record spans and counters inside the block (or, with on=False,
    not); the former state comes back after it."""
    global _ON
    former, _ON = _ON, on
    try:
        yield
    finally:
        _ON = former


def take_spans() -> list:
    """The (name, parent, args, t0_ns, t1_ns) of every span closed while
    on since the last call, in closing order; clears them."""
    out = _SPANS[:]
    del _SPANS[:]
    return out


def count(key: str, left, cap: int) -> None:
    """A leg call's work under `key` (its launch counter's name,
    kernels.LAUNCHES): `left`, the (n,) int tensor of each lane's steps or
    events left of `cap` that the leg returns. Kept while spans are on,
    reduced by take_counts()."""
    if _ON:
        _COUNTS.append((key, left, cap))


def take_counts() -> dict:
    """{key: {"calls", "lanes", "steps"}} over the leg calls counted since
    the last call, and clears them: `steps` is the sum of cap - left over
    every lane (a lane that did not run keeps its cap and counts none),
    `lanes` the lanes that took a step. Launches a reduction a call on the
    leg's device, and waits for it."""
    out: dict = {}
    for key, left, cap in _COUNTS:
        taken = cap - left.to(torch.int64)
        c = out.setdefault(key, {"calls": 0, "lanes": 0, "steps": 0})
        c["calls"] += 1
        c["lanes"] += int((taken > 0).sum())
        c["steps"] += int(taken.sum())
    del _COUNTS[:]
    return out


def bounce_span(bounce: int, active):
    """The span vx::bounce.later (`bounce=<i>`) around iteration `bounce`
    of the path tracer's bounce loop, with `active`, the (n,) bool tensor
    of the lanes alive at its start, kept for take_live_lanes(). The
    shared no-op context at the first bounce and while spans are off."""
    if not _ON or not bounce:
        return _NOOP
    _LIVE.append((bounce, active))
    return span("vx::bounce.later", bounce=bounce)


def take_live_lanes() -> dict:
    """{bounce: {"calls", "lanes", "wavefront"}} over the later bounces
    begun since the last call, and clears them: `lanes` the lanes alive at
    a bounce's start, `wavefront` all the lanes it ran over, each summed
    over its calls. Kept apart from the legs' counter, every key of which
    a reader may sum as leg steps. Launches a reduction a bounce on its
    device, and waits for it."""
    out: dict = {}
    for bounce, active in _LIVE:
        c = out.setdefault(bounce, {"calls": 0, "lanes": 0, "wavefront": 0})
        c["calls"] += 1
        c["lanes"] += int(active.sum())
        c["wavefront"] += active.numel()
    del _LIVE[:]
    return out


@contextlib.contextmanager
def trace(log_dir=None):
    """torch.profiler trace around a code region, the card's kernels
    included where there is a card, with spans on: written to
    `log_dir`/trace.json (a new temporary directory when None). Yields the
    directory."""
    out = Path(log_dir) if log_dir is not None else Path(tempfile.mkdtemp(prefix="volxel_trace_"))
    out.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof, spans():
        yield out
    prof.export_chrome_trace(str(out / "trace.json"))
