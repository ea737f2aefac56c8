"""One run of one cell: set-up, the measured window, the comparison with
the reference, the metrics, and the result line.

Everything that belongs to one cell is found by name: the cell's entry in
BENCHMARK.json (which metrics it reports), workloads/<cell>.json (its
configuration, modes, settings, traced frames and limits),
configs/<config>.json (the scene and its sizes) and metrics/<metric>.py
(one reader a metric). Adding a cell or a metric is adding those files and
entries; nothing here names a cell.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from vxbench import judge, reference, scene, trace

HOME = Path(__file__).resolve().parent
ROOT = HOME.parent
# top-level modules that may not be loaded in a run: JAX, its libraries,
# the JAX package and its benchmark script
FORBIDDEN = ("jax", "jaxlib", "flax", "volxel_tpu", "bench")
WARMUP_FRAMES = 6  # frames a mode is rendered before the window: past the 5 warm-up samples


@dataclass
class Frame:
    index: int  # the renderer's frame index the frame rendered
    mode: str
    start: float  # host clock (s) at the call of render_frame()
    enqueue_s: float  # until render_frame() returned
    frame_s: float  # until torch.cuda.synchronize() returned
    traced: bool = False


@dataclass
class Run:
    """What a metric reader reads."""

    cell: str
    config: dict
    workload: dict
    frames: list = field(default_factory=list)
    window_s: float = 0.0
    setup: dict = field(default_factory=dict)
    windows: list = field(default_factory=list)  # trace.Window
    in_box: dict = field(default_factory=dict)  # frame index -> camera rays inside the box
    field_bytes: dict = field(default_factory=dict)  # mode -> field bytes a camera call can reach


def cell_metrics(bench: dict, cell: str, traced: bool) -> list:
    """The BENCHMARK.json entries of the metrics this cell reports in a run
    with or without --trace."""
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def reader(home: Path, name: str):
    path = home / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"vxbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def _pin(cpus) -> dict:
    """Set every thread of this process to run on `cpus`; returns each
    thread's former set, for `_unpin`."""
    former = {}
    for tid in (int(t) for t in os.listdir("/proc/self/task")):
        try:
            former[tid] = os.sched_getaffinity(tid)
            os.sched_setaffinity(tid, cpus)
        except OSError:  # the thread has ended
            pass
    return former


def _unpin(former: dict) -> None:
    for tid, cpus in former.items():
        try:
            os.sched_setaffinity(tid, cpus)
        except OSError:
            pass


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: str, seed: int, seconds: float, traced: bool, started: float, *, home: Path = HOME,
             bench: dict | None = None, device="cuda", renderer_hook=None) -> tuple[int, dict | None]:
    """One run. Returns (exit code, result); prints the checks on stderr.
    `renderer_hook(renderer)`, for tests, may replace parts of the program
    once it is set up."""
    device = torch.device(device)
    bench = bench if bench is not None else json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"vxbench: BENCHMARK.json has no cell named {cell!r}")
    workload = json.loads((home / "workloads" / f"{cell}.json").read_text())
    config = json.loads((home / "configs" / f"{entry['config']}.json").read_text())
    run = Run(cell=cell, config=config, workload=workload)

    # -- set-up: inputs from the seed, the program, every shape warmed ------------
    vol = config["volume"]
    stages = {"imports": time.monotonic() - started}
    volume = scene.make_volume(vol["size"], vol["bits_stored"], seed, device)
    stages["volume"] = time.monotonic() - started
    r, run.setup["grid_load_s"], run.setup["ingest_s"], encode_s = scene.port_renderer(config, workload, volume,
                                                                                        device)
    del volume
    stages["program"] = time.monotonic() - started
    if renderer_hook is not None:
        renderer_hook(r)
    modes = workload["modes"]
    for mode in modes:
        r.render_mode = mode
        for _ in range(WARMUP_FRAMES):
            r.render_frame()
        r.image()
    r.render_mode = modes[0]
    _sync(device)
    stages["warm-up"] = time.monotonic() - started
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # -- the window ------------------------------------------------------------
    turn = workload.get("turn_frames")
    plan = sorted(tuple(t) for t in workload.get("trace_frames", [])) if traced else []
    pending = []  # recorded profiler windows, read after the window
    judged = {}  # mode -> (framebuffer, frame indices since its restart)
    since: list = []

    def one(keep: bool = True) -> Frame:
        """One fenced frame; `keep` it in the window's records and outputs."""
        nonlocal since
        index, mode = r.frame_index, r.render_mode
        t0 = time.perf_counter()
        fb = r.render_frame()
        t1 = time.perf_counter()
        _sync(device)
        t2 = time.perf_counter()
        rec = Frame(index, mode, t0, t1 - t0, t2 - t0)
        if keep:
            since = since + [index] if index else [index]
            judged[mode] = (fb, since)
            run.frames.append(rec)
        return rec

    def frames_fn(n, keep: bool = True):
        recs = [one(keep) for _ in range(n)]
        for rec in recs:
            rec.traced = True
        return recs

    # the window's host work on one CPU (the last this process may use),
    # threads started in the window too, so a second host thread cannot
    # gain here: unpinned, the host-bound default cell spread by 9-10% over
    # 6 runs and its median moved by 7% between two sets of one code
    former = _pin({max(os.sched_getaffinity(0))}) if device.type == "cuda" else {}
    # the harness's own encoding of the input file (a user's scan is a file
    # already) is left out of the set-up, as the reference is
    run.setup["setup_s"] = time.monotonic() - started - encode_s
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        if turn and r.frame_index >= turn:  # the next mode's turn, from a restart
            r.render_mode = modes[(modes.index(r.render_mode) + 1) % len(modes)]
        if plan and len(run.frames) >= plan[0][0]:
            _, count = plan.pop(0)
            pending.extend(trace.profiled(frames_fn, count))
            continue
        one()
    last = run.frames[-1]
    run.window_s = last.start + last.frame_s - run.frames[0].start
    _unpin(former)

    # -- outputs, then the program's state freed ----------------------------------
    image = r.image()
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    chosen = scene.settings(config, workload)
    exposure, gamma = float(chosen["exposure"]), float(chosen["gamma"])
    render_w, render_h = scene.render_size(config, workload)
    final_fb = judged[run.frames[-1].mode][0].detach().cpu()
    pixels = judge.sample_pixels(seed, render_w, render_h, int(workload["check"]["pixels"]))
    outputs = {m: (fb[pixels.to(fb.device)].detach().cpu().numpy(), idx) for m, (fb, idx) in judged.items()}
    del judged

    def again(p):
        """Frames like those of a window that lost records, past the window."""
        if r.render_mode != p.records[0].mode:
            r.render_mode = p.records[0].mode
        return trace.record(lambda n: frames_fn(n, keep=False), len(p.records), p.host_ops, p.attempt + 1)

    run.windows = trace.finish(pending, again)
    del r, pending
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # -- the reference ----------------------------------------------------------------
    ref_started = time.monotonic()
    data = scene.normalised(scene.make_volume(vol["size"], vol["bits_stored"], seed, device))
    ours, theirs = [], []
    for mode, (got, indices) in outputs.items():
        host = scene.reference_scene(config, workload, mode, data)
        sc = reference.Scene(host, device)
        del host
        frames = [i for i in indices if i >= reference.WARMUP_SAMPLES] or indices[-1:]
        theirs.append(reference.accumulate(sc, pixels, frames).cpu().numpy())
        ours.append(got)
        if run.windows:
            run.field_bytes[mode] = scene.reachable_field_bytes(sc)
        for window in run.windows:
            for rec in window.frames:
                if rec.index not in run.in_box:
                    run.in_box[rec.index] = scene.lanes_in_box(sc, rec.index)
        del sc
    del data
    numbers = judge.fb_numbers(np.concatenate(ours), np.concatenate(theirs))
    numbers["image_gap"] = judge.image_gap(image, final_fb, exposure, gamma, render_w, render_h)
    limits = workload["check"]["limits"]
    correct, lines = judge.verdict(numbers, limits)
    ref_s = time.monotonic() - ref_started

    # -- metrics --------------------------------------------------------------------
    metrics = {}
    for m in cell_metrics(bench, cell, traced):
        value = reader(home, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(entry["chips"]), "memory_peak_bytes": peak}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    result = {"correct": bool(correct), "attempted": len(run.frames), "failed": 0 if correct else len(run.frames),
              "metrics": metrics, "device": dev}
    if traced:
        quiet = [w for w in run.windows if not w.host_ops]
        full = [w for w in run.windows if w.host_ops]
        dev["busy_s"] = sum(w.busy_s() for w in quiet)
        dev["window_s"] = sum(w.wall_s for w in quiet)
        ops = [(o.name, (o.end - o.start) / 1e6) for w in quiet for o in w.ops]
        result["breakdown"] = {"device_ops": trace.top(ops), "idle_gaps": trace.top(g for w in full for g in w.gaps)}
    result["checks"] = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}

    found = forbidden_modules()
    if found:
        print(f"vxbench: modules that may not be loaded were loaded: {found}", file=sys.stderr)
        return 3, None
    print("vxbench: set-up stages end at " + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items())
          + f"; the input file's encoding, {encode_s:.2f} s, is not in setup_s", file=sys.stderr)
    print(f"vxbench: {len(run.frames)} frames in {run.window_s:.3f} s; reference {ref_s:.1f} s; "
          f"traced windows {len(run.windows)} (attempts {[w.attempts for w in run.windows]})", file=sys.stderr)
    if run.field_bytes:
        print(f"vxbench: field bytes a camera call can reach {run.field_bytes}; camera rays in the box "
              f"{sorted(set(run.in_box.values()))}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    return 0, result


def main(argv=None, started: float | None = None) -> int:
    import argparse

    started = time.monotonic() if started is None else started
    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"vxbench: BENCHMARK.json has no cell named {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"vxbench: the cell needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    import volxel_tpu_torch

    if not Path(volxel_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        print(f"vxbench: volxel_tpu_torch was loaded from {volxel_tpu_torch.__file__}, not from this checkout",
              file=sys.stderr)
        return 2
    code, result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), started, bench=bench)
    if result is not None:
        print(json.dumps(result))
    return code
