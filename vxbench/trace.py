"""A padded profiler window over some frames of the measured window, and
what the harness reads from it.

The window is opened and closed by PAD launches of the empty spin kernel
(torch.cuda._sleep, a device op of PyTorch's own that no render path
launches), and ends in torch.cuda.synchronize(). A profiler that has
recorded a large window can lose the first device records of a later one,
or a run of them, so a window counts only if it recorded every launch of
the program's own kernels that the program's launch counters saw in it,
and more pads than close it (at least one leading pad, so that a lost run
ended before the frames); otherwise frames like them are profiled again
behind twice the leading pads, at most ATTEMPTS times. This is the method
of the repository's chip smoke run (`profile_call`), rebuilt here on
PyTorch's own kernel. The events are read once the measured window has
closed, so that reading them takes none of its time; a window recorded
again then renders frames past the window's end, which the comparison
does not see.

Each traced stretch is profiled twice, one window after the other: once
with the device's activity alone, whose gaps are the device's idle time as
the closed loop leaves it, and once with the host's ops too, whose
per-op records slow the host (so its idle time is not read) and which
tell who launched each kernel. A device kernel counts as launched under
an ATen op when the runtime call that launched it (the profiler gives
both one correlation id) ran inside a host op whose name starts with
"aten::"; every other kernel (launched through the program's own binding,
outside any ATen op) counts as the program's own.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import torch

PAD = 32
ATTEMPTS = 5
PAD_NAME = "spin_kernel"
# the device symbol behind each of the program's launch counters
# (volxel_tpu_torch.kernels.LAUNCHES), as its CUDA sources name them
SYMBOLS = {"dda_leg_sample": "dda_leg_sample_kernel", "dda_leg_shadow": "dda_leg_shadow_kernel",
           "track_leg_sample": "track_leg_sample_kernel", "track_leg_shadow": "track_leg_shadow_kernel",
           "importance_pyramid": "importance_pyramid_kernel", "tonemap": "tonemap_kernel",
           "tile_march_sample": "tile_march_sample_kernel",
           "tile_march_transmittance": "tile_march_transmittance_kernel",
           "tile_march_sums": "tile_march_sums_kernel", "shearwarp_intermediate": "shearwarp_kernel",
           "gather_f32": "gather_f32_kernel", "lookup_transfer": "lookup_transfer_kernel"}


@dataclass
class Op:
    name: str
    start: float  # us, the profiler's clock
    end: float
    aten: bool
    kernel: bool  # a kernel, not a copy or a set


@dataclass
class Window:
    """One profiled stretch of frames."""

    frames: list  # the window's frame records (harness.Frame) it covers
    ops: list  # Op, the device ops between the pads
    start: float  # us: end of the last leading pad
    end: float  # us: start of the first trailing pad
    host_ops: bool = True  # profiled with the host's ops (else the device's activity alone)
    gaps: list = field(default_factory=list)  # (label, seconds) of each idle gap
    attempts: int = 1

    @property
    def wall_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_s(self) -> float:
        """Union of the device ops' intervals, clipped to the window."""
        total, reach = 0.0, self.start
        for op in sorted(self.ops, key=lambda o: o.start):
            s, e = max(op.start, reach), min(op.end, self.end)
            if e > s:
                total += e - s
                reach = e
        return total / 1e6


def _launches():
    from volxel_tpu_torch import kernels

    return {k: v for k, v in kernels.LAUNCHES.items() if k in SYMBOLS}


def _pads(n: int) -> None:
    for _ in range(n):
        torch.cuda._sleep(1)


@dataclass
class Pending:
    """A recorded window whose events are read once the measured window has closed."""

    prof: object
    records: list
    launched: dict
    host_ops: bool
    attempt: int = 1


def record(frames_fn, count: int, host_ops: bool, attempt: int = 1) -> Pending:
    """Profile `frames_fn(count)`, which renders `count` frames and returns
    their records, between PAD << (attempt - 1) leading pads and PAD
    trailing ones, with the host's ops or the device's activity alone."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    before = _launches()
    with profile(activities=activities) as prof:
        _pads(PAD << (attempt - 1))
        records = frames_fn(count)
        _pads(PAD)
        torch.cuda.synchronize()
    launched = {SYMBOLS[k]: n - before[k] for k, n in _launches().items() if n - before[k]}
    return Pending(prof, records, launched, host_ops, attempt)


def profiled(frames_fn, count: int) -> list:
    """Two windows over the next frames: the device's activity alone, then
    with the host's ops."""
    return [record(frames_fn, count, False), record(frames_fn, count, True)]


def finish(pending: list, again) -> list:
    """The Windows of the recorded ones; a window that lost device records
    is recorded again by `again(pending)` (frames like its own, behind
    twice the leading pads), at most ATTEMPTS times. Windows that lost
    records in every attempt are left out."""
    windows = []
    for p in pending:
        window = read(p.prof.events(), p.records, p.launched, p.host_ops)
        while window is None and p.attempt < ATTEMPTS:
            p = again(p)
            window = read(p.prof.events(), p.records, p.launched, p.host_ops)
        if window is not None:
            window.attempts = p.attempt
            windows.append(window)
    return windows


def _under_aten(event) -> bool:
    while event is not None:
        if event.name.startswith("aten::"):
            return True
        event = event.cpu_parent
    return False


def read(events, records, launched: dict, host_ops: bool = True):
    """The Window of one profile's events, or None where it lost records."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type == DeviceType.CPU]
    # the runtime calls that launch device work carry the work's correlation id
    runtime = {e.id: e for e in host if e.name.startswith("cu")}
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    pads = sorted((e for e in device if PAD_NAME in e.name), key=lambda e: e.time_range.start)
    counts = {sym: sum(1 for e in device if sym in e.name) for sym in launched}
    if any(counts[sym] < n for sym, n in launched.items()) or len(pads) <= PAD:
        return None
    others = [e for e in device if PAD_NAME not in e.name]
    if not others:
        return None
    first = min(e.time_range.start for e in others)
    lead = [p for p in pads if p.time_range.end <= first]
    trail = [p for p in pads if p.time_range.start >= first]
    if not lead or not trail:
        return None
    start, end = lead[-1].time_range.end, trail[0].time_range.start
    ops = []
    for e in others:
        aten = host_ops and _under_aten(runtime.get(e.id))
        kernel = not (e.name.startswith("Memcpy") or e.name.startswith("Memset"))
        ops.append(Op(e.name, e.time_range.start, e.time_range.end, aten, kernel))
    window = Window(frames=records, ops=ops, start=start, end=end, host_ops=host_ops)
    labels = [e for e in host if not e.name.startswith("cu")] if host_ops else host
    window.gaps = idle_gaps(window, labels)
    return window


def idle_gaps(window: Window, host_events, min_us: float = 1.0) -> list:
    """Each stretch of the window in which no device op ran, labelled by the
    innermost host op running at its start (or "host: no op" where the host
    was between ops, in Python)."""
    spans = sorted((max(o.start, window.start), min(o.end, window.end)) for o in window.ops
                   if o.end > window.start and o.start < window.end)
    gaps, reach = [], window.start
    for s, e in spans:
        if s - reach >= min_us:
            gaps.append((reach, s))
        reach = max(reach, e)
    if window.end - reach >= min_us:
        gaps.append((reach, window.end))
    hosts = sorted(((e.time_range.start, e.time_range.end, e.name) for e in host_events), key=lambda h: h[0])
    starts = [h[0] for h in hosts]
    out = []
    for s, e in gaps:
        label = "host: no op"
        k = bisect.bisect_right(starts, s) - 1
        steps = 0
        while k >= 0 and steps < 200:
            hs, he, name = hosts[k]
            if he >= s:
                label = name
                break
            k -= 1
            steps += 1
        out.append((label, (e - s) / 1e6))
    return out


def top(pairs, n: int = 10) -> list:
    """The n largest totals of (name, seconds) pairs, summed by name."""
    totals: dict = {}
    for name, seconds in pairs:
        totals[name] = totals.get(name, 0.0) + seconds
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]
