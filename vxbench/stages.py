"""The program's own stages read on the profiler's clock: the spans and the
legs' counters of volxel_tpu_torch.utils.profiling, for the per-layer
metrics that name a stage of the program.

The harness's profiled windows run with the program's spans off (as they
do at every commit), so the readers of these metrics take windows of their
own, once a run, after its reference: `of(run)` sets the cell's program up
again from the run's seed with spans on (the set-up's spans: the ingest's
stages, the grid's upload), warms its modes as the harness does, then
profiles with the host's ops and spans on as many frames of each mode as
the run's own host-ops windows covered, each in a padded window like the
harness's (trace.record, recorded again where it lost device records).
Each device op is given the vx:: spans above the runtime call that
launched it; each blocking runtime call is kept with its spans; the legs'
counters are read after each window, outside it. A checkout of the
program without spans gives None, as does a run without a card.
"""

from __future__ import annotations

import bisect
import gc
import sys
import time
from dataclasses import dataclass, field

import torch

from vxbench import scene, trace

# the CUDA runtime's calls that block the host until the device catches up
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


@dataclass
class SpanOp(trace.Op):
    spans: tuple = ()  # the vx:: spans above the op's launching runtime call, outermost first


@dataclass
class SpanWindow(trace.Window):
    syncs: list = field(default_factory=list)  # (runtime call, its vx:: spans) of each blocking call
    counters: dict = field(default_factory=dict)  # the legs' counters over the window's frames
    stage_gaps: list = field(default_factory=list)  # (innermost vx:: span at its start, seconds) of each idle gap
    annotations: int = 0  # the spans' ranges the profiler put on the device, left out of the ops


@dataclass
class Staged:
    windows: list  # SpanWindow, each one mode's frames
    setup_spans: list  # (name, parent, args, t0_ns, t1_ns) of the set-up's spans


def of(run):
    """The run's Staged (measured at the first call), or None."""
    if not hasattr(run, "stages"):
        run.stages = measure(run)
    return run.stages


def frames(staged) -> int:
    return sum(len(w.frames) for w in staged.windows) if staged is not None else 0


def under(staged, name: str) -> list:
    """The device ops launched under span `name`."""
    return [o for w in staged.windows for o in w.ops if name in o.spans]


def ms_per_frame(staged, name: str):
    """Device ms of the ops under span `name`, per profiled frame."""
    n = frames(staged)
    return sum(o.end - o.start for o in under(staged, name)) / 1000.0 / n if n else None


def _seed() -> int:
    """The run's --seed from the harness's command line (0 where none)."""
    args = sys.argv[1:]
    for i, a in enumerate(args):
        try:
            if a == "--seed" and i + 1 < len(args):
                return int(args[i + 1])
            if a.startswith("--seed="):
                return int(a.split("=", 1)[1])
        except ValueError:
            break
    return 0


def _chain(event) -> tuple:
    """The vx:: spans above a host event, outermost first."""
    names = []
    while event is not None:
        if event.name.startswith("vx::"):
            names.append(event.name)
        event = event.cpu_parent
    return tuple(reversed(names))


def read(events, records, launched: dict):
    """The SpanWindow of one host-ops profile's events, or None where it
    lost records: trace.read's window, with each op's spans. A span's range
    on the device (a user annotation the profiler may add there) is no
    device op."""
    from torch.autograd import DeviceType

    def annotation(e):
        return e.device_type == DeviceType.CUDA and (e.name.startswith("vx::")
                                                     or getattr(e, "is_user_annotation", False))

    kept = [e for e in events if not annotation(e)]
    window = trace.read(kept, records, launched, True)
    if window is None:
        return None
    host = [e for e in kept if e.device_type == DeviceType.CPU]
    runtime = {e.id: e for e in host if e.name.startswith("cu")}
    chains = {(e.name, e.time_range.start, e.time_range.end): _chain(runtime.get(e.id))
              for e in kept if e.device_type == DeviceType.CUDA}
    ops = [SpanOp(o.name, o.start, o.end, o.aten, o.kernel, chains[(o.name, o.start, o.end)]) for o in window.ops]
    out = SpanWindow(frames=records, ops=ops, start=window.start, end=window.end, gaps=window.gaps,
                     annotations=len(events) - len(kept))
    out.syncs = [(e.name, _chain(e)) for e in host if e.name in SYNCS]
    out.stage_gaps = stage_gaps(out, [e for e in host if e.name.startswith("vx::")])
    return out


def stage_gaps(window, span_events, min_us: float = 1.0) -> list:
    """Each idle stretch of the window (as trace.idle_gaps finds them),
    labelled by the innermost span open on the host at its start, searched
    among the spans alone ("no span" outside every span)."""
    bounds = sorted((max(o.start, window.start), min(o.end, window.end)) for o in window.ops
                    if o.end > window.start and o.start < window.end)
    gaps, reach = [], window.start
    for s, e in bounds:
        if s - reach >= min_us:
            gaps.append((reach, s))
        reach = max(reach, e)
    if window.end - reach >= min_us:
        gaps.append((reach, window.end))
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in span_events)
    starts = [sp[0] for sp in spans]
    out = []
    for s, e in gaps:
        label = "no span"
        for k in range(bisect.bisect_right(starts, s) - 1, -1, -1):  # the latest span open at s is the innermost
            if spans[k][1] >= s:
                label = spans[k][2]
                break
        out.append((label, (e - s) / 1e6))
    return out


def measure(run):
    """Staged windows of the run's cell (see the module's docstring)."""
    from volxel_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans") or not torch.cuda.is_available():
        return None
    plan = [(w.frames[0].mode, len(w.frames)) for w in run.windows if w.host_ops and w.frames]
    if not plan:
        return None
    from vxbench import harness

    started = time.monotonic()
    device = torch.device("cuda")
    vol = run.config["volume"]
    volume = scene.make_volume(vol["size"], vol["bits_stored"], _seed(), device)
    profiling.take_spans(), profiling.take_counts()
    with profiling.spans():
        r, *_ = scene.port_renderer(run.config, run.workload, volume, device)
    setup_spans = profiling.take_spans()
    profiling.take_counts()
    del volume

    def frames_fn(n):
        recs = []
        for _ in range(n):
            recs.append(harness.Frame(r.frame_index, r.render_mode, 0.0, 0.0, 0.0, True))
            r.render_frame()
            torch.cuda.synchronize()
        return recs

    warm = set()
    windows = []
    for mode, count in plan:
        if r.render_mode != mode or mode not in warm:
            r.render_mode = mode
            for _ in range(harness.WARMUP_FRAMES):
                r.render_frame()
            warm.add(mode)
        for attempt in range(1, trace.ATTEMPTS + 1):
            with profiling.spans():
                p = trace.record(frames_fn, count, True, attempt)
            counters = profiling.take_counts()
            profiling.take_spans()
            window = read(p.prof.events(), p.records, p.launched)
            del p
            if window is not None:
                window.attempts, window.counters = attempt, counters
                windows.append(window)
                break
    del r
    gc.collect()
    torch.cuda.empty_cache()
    staged = Staged(windows, setup_spans)
    report(staged, time.monotonic() - started)
    return staged


def report(staged, seconds: float) -> None:
    """The stage table on standard error: device ms and kernels a frame
    under each span (a nested span's ops count in every span above it), the
    syncs and uploads inside render_frame, the idle gaps' labels and the
    legs' counters."""
    n = frames(staged)
    if not n:
        print(f"vxbench: stages: no window kept ({seconds:.1f} s)", file=sys.stderr)
        return
    names = sorted({s for w in staged.windows for o in w.ops for s in o.spans})
    rows = []
    for name in names:
        ops = [o for w in staged.windows for o in w.ops if name in o.spans]
        rows.append(f"{name} {sum(o.end - o.start for o in ops) / 1000.0 / n:.4f} ms "
                    f"{sum(o.kernel for o in ops) / n:.1f} kernels")
    syncs: dict = {}
    for w in staged.windows:
        for call, chain in w.syncs:
            if "vx::render_frame" in chain:
                syncs[f"{call} in {chain[-1]}"] = syncs.get(f"{call} in {chain[-1]}", 0) + 1
    uploads: dict = {}
    for w in staged.windows:
        for o in w.ops:
            if o.name.startswith("Memcpy HtoD") and "vx::render_frame" in o.spans:
                uploads[o.spans[-1]] = uploads.get(o.spans[-1], 0) + 1
    counters: dict = {}
    for w in staged.windows:
        for key, c in w.counters.items():
            into = counters.setdefault(key, {"calls": 0, "lanes": 0, "steps": 0})
            for k in into:
                into[k] += c[k]
    modes = [w.frames[0].mode for w in staged.windows]
    print(f"vxbench: stages over {n} frames of {modes}, spans on, after the window ({seconds:.1f} s; attempts "
          f"{[w.attempts for w in staged.windows]}), a frame: " + "; ".join(rows), file=sys.stderr)
    print(f"vxbench: stages: syncs in render_frame {syncs}; uploads by stage {uploads}; leg counters {counters}; "
          f"idle gaps {trace.top(g for w in staged.windows for g in w.gaps)}", file=sys.stderr)
    setup = {}
    for name, _, _, t0, t1 in staged.setup_spans:
        setup[name] = setup.get(name, 0.0) + (t1 - t0) / 1e9
    print(f"vxbench: stages: set-up spans (s) {setup}", file=sys.stderr)
    gaps = [g for w in staged.windows for g in w.stage_gaps]
    print(f"vxbench: stages: span ranges on the device left out {sum(w.annotations for w in staged.windows)}; "
          f"idle s a frame {sum(s for _, s in gaps) / n:.6f}, by the innermost span at the "
          f"gap's start {trace.top(gaps, 12)}", file=sys.stderr)
