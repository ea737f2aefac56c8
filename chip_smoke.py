#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from volxel_tpu_torch/csrc and print the time;
   build csrc/dda_leg.cu, csrc/track_leg.cu and csrc/tonemap.cu once more
   with `-Xptxas -v` (registers and spills of each kernel) and check in the
   legs' SASS (cuobjdump) that the leg kernels' own code holds no FFMA;
   count the tonemap's SASS instructions and its instructions per float;
2b. ingest and the reference benchmark, in a temporary directory: write
   the 512^3 12-bit synthetic CT volume with the port's fixture writer as a
   deflated DICOM zip; ingest it on the native path in three timed stages
   (parse, scan, grid) and build the grid once more on numpy (bit-equal;
   fails if the native library does not build); write a 2048x1024 HDR map
   and time Renderer.load_env on the card (one importance-pyramid launch,
   its peak memory, resize_linear alone); then, with every launch counter
   at 0 before it, Renderer.from_attributes with the zip, the map and
   tests/fixtures/reference_benchmark.json (one entry per mode at bounces
   1, 1536x864 and 500 samples), timing inside it the first call of
   restart_from_zip, restart_from_grid, load_env and render_frame (ZIP
   bytes to the first frame): print each record and the fingerprint (the
   card's name and power limit), and check every timePerSample, the image
   after each entry and that every kernel of the three modes launched;
   then hold each of those kernels against its plain version on the
   spec's grid and map (one frame a mode, every call; K4 at image(), K3 on
   the map's base); print the host's CPU model;
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes, and time both with CUDA events:
   - both default-mode legs (the camera leg's and the shadow leg's kernel:
     the DDA march and its collisions, each lane until it ends) at every
     call of one 1080p default-mode sample of the 512^3 scene, the shadow
     leg with physical shadows at every call of one more, and both legs at
     every call of one sample at bounces 3 (bit-equal on every output of
     every lane), with a bound recounted for the work the lanes need, each
     kernel's registers and resident warps per SM, and the march as the
     warps execute it: march steps, collisions, warp iterations and warp
     efficiency of the nested loop (march, then decode) and of a flat one
     (a step an iteration), the longest lane, the spread of the warps'
     iterations, the SASS sizes of a march step and a collision and the
     issue floor of the loop the kernel runs; the legs' -logf(1 - xi)
     against torch.log at all 2^24 draws;
   - both no_dda legs (delta and ratio tracking, each lane until it ends)
     at every call of one 1080p no_dda sample, bit-equal on every output
     of every lane, with their warp efficiency (events over 32 times the
     most a lane of the warp takes), a bound recounted for the events the
     lanes take, and each kernel's registers, resident warps per SM and
     issue floor (its event loop's SASS at every warp iteration);
   - both table fetches: the transfer-LUT fetch where it still runs (the
     default sample's premultiplied pyramid) and gather_f32 at every call
     of one 1080p default-mode
     sample and at one environment lookup over 1920x1080 directions
     (bit-equal), gather_f32 beside torch.index_select on the same int32
     indices and torch.take on their int64 copy, the LUT fetch's mean call
     beside the launch floor (an empty kernel over the same grid);
   - the importance pyramid on the default environment's 512^2 base
     (bit-equal, its launches per build, beside the launch floor), and the
     tonemap, bit-equal on a 1920x1080x3 buffer and at all
     2^32 f32 inputs, timed beside a plain 16-byte copy of the same buffer
     (the practical floor) and torch's copy_;
   - both raymarch step loops (the camera leg's and the shadow leg's) at
     every call of one 1080p raymarch sample (bit-equal on state, hit, t
     and rgb, or state and tau, of every lane), and the nearest-tap sums on
     that sample's camera rays at 64 steps (bit-equal);
   - the shear-warp intermediate on the 512^3 volume, on the preview's
     fixed canvas and on one view's static canvas (bit-equal, or within
     1e-6 where the card's expf and ATen's exp round apart), and on the
     fixed canvas through the Renderer's default transfer and at a
     translucent density; again at each of the preview's
     six poses in phase 4;
   each kernel's entry also carries its bound (the larger of its bytes
   over the card's memory rate and its operations over the f32 rate) and,
   where one PyTorch call computes the same function, that call's time;
4. run the main paths through the Renderer: the 512^3 synthetic CT volume
   in the benchmark framing (bench.py), 1920x1080, 5 warm-up + 3
   accumulated frames, then image(), in the default, the raymarch and the
   no_dda mode, each with every launch counter at 0 before it; check the
   output, that every kernel of the path launched, that each leg of the
   default and no_dda modes is one launch per bounce and that the LUT
   fetch launched at most once per default sample and never in the other
   modes; print every kernel's launches per sample; in the three modes
   split one sample into its camera and shadow legs (their ms, launches
   and host syncs, which must be 0) and profile one (device kernels,
   torch.nonzero calls), and the default mode once more at bounces 3; then
   the shear-warp preview: render_preview() at six
   camera poses that use all six (principal axis, flip) volumes, each
   called 1 + 3 times, and render_dvr(screen=True) once, with the counters
   at 0 before it;
5. render the same scene at 64x64 on the card and on the CPU (plain
   versions) in each of the three modes and hold the images to the parity
   contract of tests/test_parity_oracle.py; the preview at three poses is
   held to max abs err 1e-5.

The second-to-last line is a JSON object with one entry per kernel, the
last line {"ok": true, "device": {...}}. Without a CUDA device, or without
the volxel_tpu_torch package beside it, the script fails before printing
any result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

# bench.py's scene: framing, transfer and sample range (bench.py:186-200)
BENCH_TRANSFER = [
    {"color": [0.5686, 0.2549, 0.6745, 0.54], "stop": 0.0},
    {"color": [0.9725, 0.8941, 0.3608, 1.0], "stop": 0.1782},
    {"color": [0.0, 1.0, 1.0, 0.17], "stop": 0.3985},
]
BENCH_SAMPLE_RANGE = [0.0564, 1.0]
WARMUP_FRAMES = 5
ACCUMULATED_FRAMES = 3
PARITY_FRAMES = 12  # frames 5..11 accumulate, as tests/test_parity_oracle.py
# a kernel's time at one call is the mean of this many back-to-back launches
# of the call, so the few microseconds the events add per timed region are
# spread over them (the LUT fetch's calls take ~3 us at 1080p)
KERNEL_REPS = 5
# the preview's camera poses, applied one after the other to the bench
# framing: each turns the view onto another (principal axis, flip)
PREVIEW_POSES = ((0.0, 0.0), (1.57, 0.0), (1.57, 0.0), (1.57, 0.0), (0.0, 1.2), (0.0, -2.4))
PREVIEW_REPEATS = 3  # calls after the first at each pose
PREVIEW_PARITY_ATOL = 1e-5
# a view whose static canvas phase 3 checks: x principal, flipped
STATIC_VIEW = (-0.9, 0.35, 0.3)
# the bench's density makes every voxel of the 512^3 scene opaque (sigma * a
# >= 100 for every LUT row), so most of K7's compositing there is not needed
# (a pixel with t = 0 keeps its colour); at this fraction of it a ray through
# the volume gathers an optical depth of a few units, no pixel turns opaque,
# and every pixel-slice of the footprints is needed work
TRANSLUCENT = 2.0**-16
# launches of the empty kernel that open and close every profiler window,
# and how often a window that lost device records is profiled again
# (profile_call)
PROFILE_PAD = 32
PROFILE_ATTEMPTS = 5
PAD_KERNEL = "empty_kernel"
# the device symbol of the kernel behind each launch counter
KERNEL_SYMBOLS = {"dda_leg_sample": "dda_leg_sample_kernel", "dda_leg_shadow": "dda_leg_shadow_kernel",
                  "track_leg_sample": "track_leg_sample_kernel", "track_leg_shadow": "track_leg_shadow_kernel",
                  "importance_pyramid": "importance_pyramid_kernel",
                  "tonemap": "tonemap_kernel", "tile_march_sample": "tile_march_sample_kernel",
                  "tile_march_transmittance": "tile_march_transmittance_kernel",
                  "tile_march_sums": "tile_march_sums_kernel", "shearwarp_intermediate": "shearwarp_kernel",
                  "gather_f32": "gather_f32_kernel", "lookup_transfer": "lookup_transfer_kernel"}

# the least time a call could take: its bytes (each input read once, each
# output written once) over HBM3's 3.35 TB/s, or its operations over the
# 67 TFLOP/s of f32 outside the tensor cores, whichever is longer (NVIDIA's
# H100 SXM data sheet; a card below its 700 W limit is slower)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations per unit of work, counted from the kernels' sources: a DDA
# step of the march; a collision of the default legs or an event of the
# no_dda legs (the trilinear decode of eight taps, the LUT, two or three
# draws, the log, the leg's updates); a
# raymarch step (nine xoshiro draws, the tricubic offsets, the tap, the
# LUT and the tau test); a nearest-tap sum step; a
# shear-warp voxel's LUT index (two products, floor, clamp), a LUT row's
# alpha' (product, exp, difference), one canvas pixel's update per slice
# (4-tap blend of 4 channels and the composite) and, once the pixel's t is
# +-0 and its colour can no longer change, its alpha blend and t update
# alone; a tonemapped pixel (3 channels of Hable, exposure and pow); a LUT
# fetch (compares, floor, clamp)
OPS_DDA_STEP = 50
OPS_COLLIDE = 100
OPS_TILE_STEP = 160
OPS_SUMS_STEP = 15
OPS_SW_VOXEL = 5
OPS_SW_LUT_ROW = 3
OPS_SW_PIXEL = 37
OPS_SW_OPAQUE_PIXEL = 9
OPS_TONEMAP_PIXEL = 48
OPS_LUT_FETCH = 6


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_renderer(grid, width: int, height: int, device, mode: str = "default", bounces: int = 1):
    from volxel_tpu_torch import Renderer

    r = Renderer(width, height, device=device)
    r.restart_from_grid(grid)
    r.render_mode = mode
    r.camera.rotate_around_view(0.6, 0.4)
    r.camera.zoom(2.0)
    r.settings.bounces = bounces
    r.set_transfer_colors(BENCH_TRANSFER)
    r.settings.sample_range = list(BENCH_SAMPLE_RANGE)
    r.restart_rendering()
    return r


@functools.lru_cache(maxsize=None)
def spin_cycles_per_ms() -> float:
    """Clock cycles per millisecond of torch.cuda._sleep on this card."""
    import torch

    torch.cuda._sleep(1_000_000)  # wake the clocks
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def device_ms(fn, reps: int = 1):
    """(last output, mean ms per call) of `reps` calls of `fn`, by CUDA
    events. A first, untimed round measures the host's enqueue time; then a
    device-side spin of twice that (+0.5 ms, at most 50 ms) is queued ahead
    of the start event, so the card reaches the start event only after the
    host has enqueued the whole timed round, and the events bracket device
    work, not host time. A function that synchronizes inside (the plain
    versions' step loops) still includes its host share."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1000
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_cycles_per_ms() * min(2 * host_ms + 0.5, 50.0)))
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def profile_call(fn):
    """A torch.profiler window (host and device activities) over one call
    of `fn`, opened and closed by PROFILE_PAD launches of the empty kernel
    and ending in torch.cuda.synchronize(). On the H100, once a process has
    profiled a window of tens of thousands of kernels, later windows lose
    device records: their first few (up to 8 seen), which the leading pads
    take, and in the windows right after the large one, all of them or a
    run of them (PERF.md §6; examples/profiler_record_loss.py). So a
    window counts only if it recorded every launch of this repo's kernels
    that the launch counters saw in it, and more pads than PROFILE_PAD (a
    run that reaches the window's end takes trailing pads with it);
    otherwise `fn` is profiled again, at most PROFILE_ATTEMPTS times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.render.gather import launch_floor

    cuda = torch.device("cuda")
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        before = dict(kernels.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                launch_floor(1, cuda)
            fn()
            for _ in range(PROFILE_PAD):
                launch_floor(1, cuda)
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
        launched = {KERNEL_SYMBOLS[k]: n - before[k] for k, n in kernels.LAUNCHES.items()}
        lost = {sym: n - sum(e.count for e in device if sym in e.key) for sym, n in launched.items()}
        lost = {sym: n for sym, n in lost.items() if n}
        pads = sum(e.count for e in device if PAD_KERNEL in e.key)
        if pads <= PROFILE_PAD:
            lost[PAD_KERNEL] = 2 * PROFILE_PAD - pads
        if not lost:
            if pads < 2 * PROFILE_PAD:
                log(f"profiler window {attempt}: kept, {2 * PROFILE_PAD - pads} of its {2 * PROFILE_PAD} pads lost")
            return prof
        log(f"profiler window {attempt} of {PROFILE_ATTEMPTS} lost device records (launches not recorded: {lost}; "
            f"pads recorded {pads} of {2 * PROFILE_PAD})")
    raise SystemExit(f"the profiler lost device records in all {PROFILE_ATTEMPTS} windows")


def device_events(prof) -> list:
    """The device-side entries of a profile_call() window's
    key_averages(), without the empty kernel that opened and closed it (a
    CPU op's device time repeats its kernels', so host entries are left
    out too)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type != DeviceType.CPU and PAD_KERNEL not in e.key]


def profiled_device_ms(fn, name: str) -> float:
    """Summed device time (ms) of the kernels whose name contains `name`
    over one call of `fn`, read by torch.profiler."""
    return sum(e.device_time_total for e in device_events(profile_call(fn)) if name in e.key) / 1000


def bits_equal(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs(got, want) -> float:
    """Largest |difference| over the outputs; lanes outside the box carry
    NaN/inf through unchanged, so those count as 0."""
    return max(float((a.double() - b.double()).abs().nan_to_num(0.0).max()) for a, b in zip(got, want))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved_bytes: float, ops: float) -> dict:
    """The least time (ms) the card could take for work that moves
    `moved_bytes` and does `ops` operations, and which of the two sets it."""
    by_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def sample_operands(r):
    config = r._config()
    inv_view, inv_proj, light_dir = r._camera_operands(config)
    return (config, r._device_grid, r.volume_params(), r._lut, r.environment.state, inv_view, inv_proj, light_dir)


def fresh_calls(fn, args, mutable, calls: int):
    """A function that calls `fn` on a fresh copy of `args` each time, at
    most `calls` times: the operands at the indices in `mutable`, which
    `fn` updates in place, are cloned ahead (untimed). Also returns the
    list of the copies, in the order they are used."""
    copies = [tuple(a.clone() if i in mutable else a for i, a in enumerate(args)) for _ in range(calls)]
    used = iter(copies)
    return (lambda: fn(*next(used))), copies


@contextlib.contextmanager
def compared_calls(module, name: str, cuda_fn, plain_fn, outputs, lanes, work, library_fn=None, others=None,
                   mutable=()):
    """Replace module.<name>, for the block's duration, by a stand-in that
    sends each call's inputs through the kernel and the plain version
    (and `library_fn`, when given), raises unless they agree bit for bit
    on every output, and returns the kernel's result. A function that
    updates the operands at the indices in `mutable` in place gets fresh
    copies of them at every timed call, and the kernel's updates are then
    copied into the caller's operands. `others` maps a name to a function
    of the call's inputs that prepares (untimed) one more call to time
    beside them. Yields the tally: calls, lanes (`lanes(args)`), the times
    summed over the calls, the bytes and operations of the work
    (`work(args, outputs)`), the largest difference, and the first call's
    arguments."""
    others = others or {}
    tally = {"calls": 0, "lanes": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "ops": 0,
             "err": 0.0, "first_args": None, "others": dict.fromkeys(others, 0.0)}

    def compared(*args):
        kernel_call, copies = fresh_calls(cuda_fn, args, mutable, 2 * KERNEL_REPS)
        got, ms = device_ms(kernel_call, KERNEL_REPS)
        plain_call, _ = fresh_calls(plain_fn, args, mutable, 2)
        want, plain_ms = device_ms(plain_call)
        single = not isinstance(got, tuple)
        got_t, want_t = ((got,), (want,)) if single else (got, want)
        bad = [nm for nm, a, b in zip(outputs, got_t, want_t) if not bits_equal(a, b)]
        err = max_abs(got_t, want_t)
        if bad:
            raise SystemExit(f"{name} call {tally['calls']}: kernel differs from its plain version "
                             f"in {bad} (max abs {err})")
        if library_fn is not None:
            tally["library_ms"] += device_ms(lambda: library_fn(*args), KERNEL_REPS)[1]
        for other, prepare in others.items():
            tally["others"][other] += device_ms(prepare(*args), KERNEL_REPS)[1]
        moved, ops = work(args, got_t)
        tally["calls"] += 1
        tally["lanes"] += lanes(args)
        tally["ms"] += ms
        tally["plain_ms"] += plain_ms
        tally["bytes"] += moved
        tally["ops"] += ops
        tally["err"] = max(tally["err"], err)
        if tally["first_args"] is None:
            tally["first_args"] = args
        # the caller's operands take the kernel's in-place updates, and the
        # result names them instead of the copies
        kept = {id(copies[-1][i]): args[i] for i in mutable}
        for i in mutable:
            args[i].copy_(copies[-1][i])
        return got if single else tuple(kept.get(id(o), o) for o in got)

    original = getattr(module, name)
    setattr(module, name, compared)
    try:
        yield tally
    finally:
        setattr(module, name, original)


def check_every_call(r, module, names, frame: int = 0, what: str = "") -> list[dict]:
    """Render one sample of `r` with each module.<name> compared at every
    call (compared_calls); `names` maps a name to compared_calls' other
    arguments. The plain versions of the marches synchronize at every step
    (to test whether any lane still runs), so their time includes the
    host's share. Returns the tallies in the order of `names`."""
    from volxel_tpu_torch.render.pathtrace import render_sample

    with contextlib.ExitStack() as stack:
        tallies = [stack.enter_context(compared_calls(module, name, **kw)) for name, kw in names.items()]
        render_sample(*sample_operands(r), frame)
    config = r._config()
    for name, tally in zip(names, tallies):
        log_tally(name, tally, f"one {config.width}x{config.height} {config.mode} sample{what}")
    return tallies


def log_tally(name: str, tally: dict, where: str) -> None:
    log(f"{name}: bit-equal at all {tally['calls']} calls of {where} ({tally['lanes']} lanes in all); kernel "
        f"{tally['ms']:.4f} ms, plain {tally['plain_ms']:.4f} ms"
        + (f", library {tally['library_ms']:.4f} ms" if tally["library_ms"] else "")
        + "".join(f", {other} {ms:.4f} ms" for other, ms in tally["others"].items())
        + f" summed over the calls; bound {bound(tally['bytes'], tally['ops'])['bound_ms']:.4f} ms "
        f"({tally['bytes'] / 1e6:.3f} MB, {tally['ops'] / 1e9:.4f} Gop)")


def entry(name: str, source: str, replaces: str, err: float, ms: float, plain_ms: float, moved: float, ops: float,
          library_ms=None, route: str = "cuda") -> dict:
    return {"name": name, "route": route, "source": source, "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, **bound(moved, ops), "library_ms": library_ms}


def march_stats() -> dict:
    """Zeroed tallies of the default legs' march as the plain rounds take
    it (march_rounds)."""
    return {"steps": 0, "collisions": 0, "flat": 0, "nested": 0, "coll_iters": 0, "flat_coll_iters": 0,
            "longest_steps": 0, "longest_collisions": 0, "warp_nested": []}


def march_rounds(stats: dict, rounds: list, n: int) -> None:
    """Add one leg call's plain rounds to `stats`. `rounds` holds, per
    round of the plain leg, each lane's march steps in it (the budget it
    spent) and whether it collided. Warps are 32 lanes in pixel order, as
    the kernels take them. A warp of the nested loop (march, then decode)
    takes in each round as many step iterations as its longest lane takes
    in that round, and a collision iteration where any of its lanes
    collides; a flat loop (one step an iteration) takes as many as its
    longest lane's total steps, and a collision iteration at each step
    index at which any of its lanes collides."""
    import torch

    if not rounds:
        return
    pad = (-n) % 32
    warp_steps = warp_colls = lane_steps = lane_colls = 0
    longest = int(sum(s.to(torch.int64) for s, _ in rounds).max())
    at = torch.zeros(((n + pad) // 32, longest + 1), dtype=torch.bool, device=rounds[0][0].device)
    warp = torch.arange((n + pad) // 32, device=at.device)[:, None].expand(-1, 32)
    for steps, collided in rounds:
        steps = torch.nn.functional.pad(steps.to(torch.int64), (0, pad)).reshape(-1, 32)
        collided = torch.nn.functional.pad(collided.to(torch.int64), (0, pad)).reshape(-1, 32)
        warp_steps = warp_steps + steps.amax(dim=1)
        warp_colls = warp_colls + collided.amax(dim=1)
        lane_steps = lane_steps + steps
        lane_colls = lane_colls + collided
        hit = collided.bool()
        at[warp[hit], lane_steps[hit]] = True
    stats["steps"] += int(lane_steps.sum())
    stats["collisions"] += int(lane_colls.sum())
    stats["flat"] += int(lane_steps.amax(dim=1).sum())
    stats["nested"] += int(warp_steps.sum())
    stats["coll_iters"] += int(warp_colls.sum())
    stats["flat_coll_iters"] += int(at.sum())
    stats["longest_steps"] = max(stats["longest_steps"], int(lane_steps.max()))
    stats["longest_collisions"] = max(stats["longest_collisions"], int(lane_colls.max()))
    stats["warp_nested"].append(warp_steps.cpu())


def march_report(name: str, stats: dict, loop, clock: float, sms: int, ms: float) -> str:
    """One line of a default leg's march as its warps execute it: warp
    efficiency of the flat and the nested loop, warp iterations, the
    longest lane, the spread of the warps' step iterations (quantiles and
    the share of the 10% longest warps) and, from `loop` (march_loops),
    the issue floor of the loop the kernel runs (nested or flat): the
    step's instructions at every warp step iteration and the collision's
    at every collision iteration."""
    import torch

    per_warp = torch.cat(stats["warp_nested"]).double() if stats["warp_nested"] else torch.zeros(1)
    q = {f"p{k}": float(per_warp.quantile(k / 100)) for k in (50, 90, 99)}
    ordered = per_warp.sort(descending=True).values
    top = float(ordered[:max(1, len(ordered) // 10)].sum() / max(float(ordered.sum()), 1.0))
    line = (f"{name}: {stats['steps']} march steps and {stats['collisions']} collisions; warp efficiency "
            f"{stats['steps'] / max(32 * stats['flat'], 1):.4f} as a flat loop ({stats['flat']} warp step "
            f"iterations, {stats['flat_coll_iters']} with a collision), "
            f"{stats['steps'] / max(32 * stats['nested'], 1):.4f} as the nested loop "
            f"({stats['nested']} warp step iterations, {stats['coll_iters']} warp collision iterations); longest "
            f"lane {stats['longest_steps']} steps, {stats['longest_collisions']} collisions; per-warp step "
            f"iterations {q}, max {float(per_warp.max()):.0f}, the longest 10% of warps take {top:.1%}")
    if loop is not None:
        steps, colls = ((stats["nested"], stats["coll_iters"]) if loop["loop"] == "nested"
                        else (stats["flat"], stats["flat_coll_iters"]))
        floor = (loop["step"] * steps + loop["collision"] * colls) / (sms * 4 * clock * 1e3)
        line += (f"; SASS of its {loop['loop']} loop ({loop['step_loop']} instructions"
                 + (f", {loop['steps_per_pass']} steps a pass" if loop["loop"] == "nested" else "")
                 + f"): march step {loop['step']:.1f} instructions, collision {loop['collision']:.1f} (its own "
                 f"{loop['collision_own']} + the log's {loop['log']} + the division's {loop['division']}); issue "
                 f"floor {floor:.4f} ms ({sms} SMs at {clock:.0f} MHz; {floor / max(ms, 1e-9):.1%} of the "
                 f"kernel's {ms:.4f} ms)")
    return line


def march_loops(body: str) -> dict | None:
    """The static SASS sizes of a default leg kernel's march step and
    collision (`body`: one function's cuobjdump -sass listing). The step
    loop is the innermost loop of the kernel's own code (a BRA back to an
    address at or before it) that holds a 4-byte global load (the
    majorant) and no call of the log; it takes as many steps a pass as it
    holds such loads (a ring of steps unrolled). The collision is the
    innermost loop around it that calls the log, less the step loop, plus
    one log (the tau redraw) and one IEEE division (t at the collision),
    the out-of-line functions at the kernel's CALL targets. Every
    instruction counts once a pass, branches not taken included. None
    where no such loops are found."""
    instrs = [(int(a, 16), text) for a, text in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    calls = sorted({int(a, 16) for a in re.findall(r"CALL\.REL\S*\s+0x([0-9a-f]+)", body)})
    if not calls:
        return None
    own_end = calls[0]

    def function(start):  # an out-of-line function's instructions, up to its first RET
        code = [text for a, text in instrs if a >= start]
        return code[:next((k + 1 for k, text in enumerate(code) if text.startswith("RET")), len(code))]

    # the functions the kernel's own code calls: the log (a polynomial) and
    # the division (its reciprocal a MUFU.RCP; its slow path, called from
    # it, is left out)
    called = sorted({int(a, 16) for a in re.findall(r"CALL\.REL\S*\s+0x([0-9a-f]+)",
                                                    "\n".join(t for a, t in instrs if a < own_end))})
    logs = [c for c in called if not any("MUFU" in t for t in function(c))]
    divs = [c for c in called if any("MUFU.RCP" in t for t in function(c))]
    if len(logs) != 1:
        return None
    log_at = logs[0]
    size = {c: len(function(c)) for c in called}
    div = divs
    loops = []
    for addr, text in instrs:
        m = re.search(r"\bBRA(?:\.\S+)?\s+(?:[^,;]*,\s*)?0x([0-9a-f]+)", text)
        if addr < own_end and m and int(m.group(1), 16) <= addr:
            span = [t2 for a2, t2 in instrs if int(m.group(1), 16) <= a2 <= addr]
            loops.append((int(m.group(1), 16), addr, span))

    def calls_log(span):
        return any(re.search(rf"CALL\.REL\S*\s+0x0*{log_at:x}\b", t2) for t2 in span)

    def majorant_loads(span):
        return sum(1 for t2 in span if re.match(r"(@!?U?P\d+\s+)?LDG\.E(\.CONSTANT)?(\.STRONG\.\w+)?\s", t2))

    division = size[div[0]] if div else 0
    steps = [lp for lp in loops if majorant_loads(lp[2]) and not calls_log(lp[2])]
    if steps:  # nested: a step loop inside the loop that decodes
        step = min(steps, key=lambda lp: len(lp[2]))
        outer = [lp for lp in loops if lp[0] <= step[0] and lp[1] >= step[1] and lp is not step
                 and calls_log(lp[2])]
        if not outer:
            return None
        coll = min(outer, key=lambda lp: len(lp[2]))
        per_pass = majorant_loads(step[2])
        own = len(coll[2]) - len(step[2])
        return {"loop": "nested", "step_loop": len(step[2]), "steps_per_pass": per_pass,
                "step": len(step[2]) / per_pass, "collision_own": own, "log": size[log_at], "division": division,
                "collision": own + size[log_at] + division}
    # flat: one loop a step; its collision branch is the code from the
    # conditional branch that skips it (the first after the BSSY of the
    # outermost region of the loop around the log's call) to that branch's
    # target
    flat = [lp for lp in loops if majorant_loads(lp[2]) and calls_log(lp[2])]
    if not flat:
        return None
    lp = min(flat, key=lambda x: len(x[2]))
    site = next(a for a, t in instrs if lp[0] <= a <= lp[1] and re.search(rf"CALL\.REL\S*\s+0x0*{log_at:x}\b", t))
    regions = [(a, int(m.group(1), 16)) for a, t in instrs if lp[0] <= a <= lp[1]
               for m in [re.search(r"BSSY\s+B\d+,\s*0x([0-9a-f]+)", t)] if m and a < site < int(m.group(1), 16)]
    if not regions:
        return None
    start, end = min(regions)  # the outermost: the branch on the collision test
    skip = next(((a, int(m.group(1), 16)) for a, t in instrs if start < a < site
                 for m in [re.search(r"@!?P\d+\s+BRA\s+0x([0-9a-f]+)", t)] if m and site < int(m.group(1), 16) <= end),
                None)
    if skip is None:
        return None
    branch = sum(1 for a, _ in instrs if skip[0] < a < skip[1])
    return {"loop": "flat", "step_loop": len(lp[2]), "step": len(lp[2]) - branch, "collision_own": branch, "log": size[log_at], "division": division,
            "collision": branch + size[log_at] + division}


def check_legs(r, sass: dict, registers: dict) -> list[dict]:
    """Both leg kernels at every call of one 1080p default sample (the
    camera leg and the shadow leg; lanes counted: the running ones), then
    the shadow leg with physical shadows at every call of one more sample,
    then both legs at every call of one sample at bounces 3; bit-equal on
    every output of every lane. Their work, recounted for what
    these lanes need: every lane's `running` and words read and its outputs
    written once (the camera leg also reads every lane's t, the shadow leg
    its tr), each running lane's ray and march state read once, one
    majorant fetch and one DDA step per march step taken (the budget each
    lane spent), and per collision (counted by the plain leg's rounds) the
    decode with its eight 2-byte bf16 taps (at most the field's bytes, as
    for the raymarch step loops); the pyramid, the LUT and the scalars
    read once. Also, per leg, the march as the warps execute it
    (march_rounds, march_report: warp efficiency of a flat and of the
    nested loop, warp iterations, the longest lane, the warps' spread, the
    issue floor from the kernel's SASS, `sass`: dda_leg.cu's functions,
    march_loops) and the kernel's registers (`registers`: ptxas's report)
    and resident warps per SM (ddaleg.resident_warps)."""
    import torch

    import volxel_tpu_torch.render.modes as modes
    from volxel_tpu_torch.render import ddaleg
    from volxel_tpu_torch.render.pyrmarch import KIND_COLL

    calls = []  # per plain leg call, its rounds: (steps per lane, collided per lane)
    stats = {}  # per leg and sample: march_stats()

    def counting(plain_fn):
        def run(*args):
            rounds = []
            original = ddaleg.pyr_march_plain

            def march(maj_alpha, extent, ipos, idir, ri, t, tau, mip, far, budget, running, cap):
                out = original(maj_alpha, extent, ipos, idir, ri, t, tau, mip, far, budget, running, cap)
                rounds.append((budget - out[-1], running & (out[4] == KIND_COLL)))
                return out

            ddaleg.pyr_march_plain = march
            try:
                out = plain_fn(*args)
            finally:
                ddaleg.pyr_march_plain = original
            calls.append(rounds)
            return out
        return run

    def work_of(leg, key, cap):
        def work(args, got):
            dense, maj, _, scalars, lut, ipos, idir, ri, far, t, tau, mip, state, running = args[:14]
            n = t.numel()
            steps = torch.where(running, cap - got[-1], 0)
            st = stats.setdefault(key, march_stats())
            march_rounds(st, calls[-1], n)
            coll = sum(int(c.sum()) for _, c in calls[-1])
            taken = int(steps.sum())
            lanes = int(running.sum())
            every = nbytes(running, state, *got) + nbytes(t if leg == "sample" else args[14])
            per_running = nbytes(ipos, idir, ri, far, tau, mip) + (nbytes(t) if leg != "sample" else 0)
            moved = every + lanes * per_running // n + min(nbytes(dense), coll * 8 * 2) + nbytes(maj, lut, scalars)
            return moved, taken * OPS_DDA_STEP + coll * OPS_COLLIDE
        return work

    def compare(leg, key):
        name = f"dda_leg_{leg}"
        cap = ddaleg.DDA_SAMPLE_MAX_STEPS if leg == "sample" else ddaleg.DDA_TRANSMITTANCE_MAX_STEPS
        outputs = ("state", "hit", "t", "rgb", "budget") if leg == "sample" else ("state", "tr", "budget")
        return dict(cuda_fn=getattr(ddaleg, f"{name}_cuda"), plain_fn=counting(getattr(ddaleg, f"{name}_plain")),
                    outputs=outputs, lanes=lambda a: int(a[13].sum()), work=work_of(leg, key, cap))

    sample, shadow = check_every_call(r, modes, {"dda_leg_sample": compare("sample", "sample"),
                                                 "dda_leg_shadow": compare("shadow", "shadow")})
    r.settings.physical_shadows = True
    try:
        (physical,) = check_every_call(r, modes, {"dda_leg_shadow": compare("shadow", "physical")}, frame=1,
                                       what=" with physical shadows")
    finally:
        r.settings.physical_shadows = False
    r.settings.bounces = 3
    try:
        sample3, shadow3 = check_every_call(r, modes, {"dda_leg_sample": compare("sample", "sample3"),
                                                       "dda_leg_shadow": compare("shadow", "shadow3")},
                                            frame=2, what=" at bounces 3")
    finally:
        r.settings.bounces = 1
    clock, sms = sm_clock_mhz(), torch.cuda.get_device_properties(0).multi_processor_count
    kernels_of = {"sample": "dda_leg_sample_kernel", "shadow": "dda_leg_shadow_kernelILb0E",
                  "physical": "dda_leg_shadow_kernelILb1E"}
    entries = []
    for name, leg, t, key in (("dda_leg_sample", "sample", sample, "sample"),
                              ("dda_leg_shadow", "shadow", shadow, "shadow"),
                              ("dda_leg_shadow (physical)", "physical", physical, "physical"),
                              ("dda_leg_sample at bounces 3", "sample", sample3, "sample3"),
                              ("dda_leg_shadow at bounces 3", "shadow", shadow3, "shadow3")):
        least = bound(t["bytes"], t["ops"])
        kernel = next(fn for fn in sass if kernels_of[leg] in fn)
        loop = march_loops(sass[kernel])
        if loop is None:
            raise SystemExit(f"{name}: no march step loop and collision loop found in its SASS")
        log(f"{name}: {t['calls']} launches, kernel {t['ms']:.4f} ms; bound {least['bound_ms']:.4f} ms by "
            f"{least['bound_by']} ({least['bound_ms'] / max(t['ms'], 1e-9):.1%} of the kernel's time); "
            f"{registers[kernel]} registers, {ddaleg.resident_warps(leg, 'cuda')} resident warps per SM")
        log(march_report(name, stats[key], loop, clock, sms, t["ms"]))
        if name in ("dda_leg_sample", "dda_leg_shadow"):
            entries.append(entry(name, "volxel_tpu_torch/csrc/dda_leg.cu", "volxel_tpu/render/pyrmarch.py:313",
                                 max(t["err"], physical["err"] if name == "dda_leg_shadow" else 0.0), t["ms"],
                                 t["plain_ms"], t["bytes"], t["ops"]))
    return entries


def sm_clock_mhz() -> float:
    """The card's largest SM clock (nvidia-smi)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def check_track_legs(r, sass: dict, registers: dict) -> list[dict]:
    """Both no_dda leg kernels at every call of one 1080p no_dda sample (the
    camera leg and the shadow leg; lanes counted: the running ones),
    bit-equal on every output of every lane, events left included. Their
    work, as these lanes need it: every lane's `running` and words read and
    its outputs written once (the camera leg also reads every lane's t, the
    shadow leg its tr), each running lane's ray, box exit (and, in the
    shadow leg, t) read once, and per event it takes the decode's eight
    2-byte bf16 taps (at most the field's bytes); the LUT and the scalars
    read once. Also, per leg: the warp efficiency of the launches (the
    events the lanes took over 32 times the most a lane of their warp, 32
    lanes in pixel order, took: the kernels keep that order, one thread a
    lane); the bytes of the events' 16-byte LUT rows, which the bound does
    not count (the LUT is read once); the kernel's registers (`registers`:
    ptxas's report) and resident warps per SM (trackleg.resident_warps);
    its issue floor, the SASS instructions of its event loop (`sass`:
    track_leg.cu's functions, event_loop) at every warp iteration over 4 a
    cycle on every SM at the card's largest clock."""
    import torch

    import volxel_tpu_torch.render.modes as modes
    from volxel_tpu_torch.render import trackleg

    cap = trackleg.TRACKING_MAX_EVENTS
    warps = {}  # per leg: [events taken, 32 x the warps' most, the events' taps before the field's cap]

    def work_of(leg):
        def work(args, got):
            dense, _, scalars, lut, ipos, idir, far, t, state, running = args[:10]
            n = t.numel()
            events = torch.where(running, cap - got[-1], 0)
            most = torch.nn.functional.pad(events, (0, (-n) % 32)).reshape(-1, 32).amax(dim=1)
            taken = int(events.sum())
            w = warps.setdefault(leg, [0, 0, 0])
            w[0] += taken
            w[1] += 32 * int(most.sum())
            w[2] += taken * 8 * 2
            lanes = int(running.sum())
            every = nbytes(running, state, *got) + nbytes(t if leg == "sample" else args[10])
            per_running = nbytes(ipos, idir, far) + (nbytes(t) if leg != "sample" else 0)
            moved = every + lanes * per_running // n + min(nbytes(dense), taken * 8 * 2)
            return moved + nbytes(lut, scalars), taken * OPS_COLLIDE
        return work

    def compare(leg):
        name = f"track_leg_{leg}"
        outputs = ("state", "hit", "t", "rgb", "events") if leg == "sample" else ("state", "tr", "events")
        return dict(cuda_fn=getattr(trackleg, f"{name}_cuda"), plain_fn=getattr(trackleg, f"{name}_plain"),
                    outputs=outputs, lanes=lambda a: int(a[9].sum()), work=work_of(leg))

    r.render_mode = "no_dda"
    try:
        sample, shadow = check_every_call(r, modes, {"track_leg_sample": compare("sample"),
                                                     "track_leg_shadow": compare("shadow")})
    finally:
        r.render_mode = "default"
    clock, sms = sm_clock_mhz(), torch.cuda.get_device_properties(0).multi_processor_count
    entries = []
    for leg, name, t, w in (("sample", "track_leg_sample", sample, warps["sample"]),
                            ("shadow", "track_leg_shadow", shadow, warps["shadow"])):
        least = bound(t["bytes"], t["ops"])
        kernel = next(fn for fn in sass if f"{name}_kernel" in fn)
        loop = event_loop(sass[kernel])
        if loop is None:
            raise SystemExit(f"{name}: no event loop found in its SASS")
        floor = issue_floor_ms(loop["per_event"], w[1] // 32, clock, sms)
        log(f"{name}: {t['calls']} launches, warp efficiency {w[0] / max(w[1], 1):.4f} ({w[0]} events of {w[1]} warp "
            f"lane-events); bound {least['bound_ms']:.4f} ms by {least['bound_by']} ({t['bytes'] / 1e6:.1f} MB, the "
            f"events' taps {w[2] / 1e6:.1f} MB before the field's cap, their LUT rows {16 * w[0] / 1e6:.1f} MB not "
            f"counted; {least['bound_ms'] / max(t['ms'], 1e-9):.1%} of the kernel's {t['ms']:.4f} ms)")
        log(f"{name}: {registers[kernel]} registers, {trackleg.resident_warps(leg, 'cuda')} resident warps per SM; "
            f"event loop {loop['loop_instructions']} SASS instructions a pass of {loop['phases']} events + the log's "
            f"{loop['log_instructions']} = {loop['per_event']:.1f} an event; issue floor {floor:.4f} ms "
            f"({w[1] // 32} warp iterations, {sms} SMs at {clock:.0f} MHz; "
            f"{floor / max(t['ms'], 1e-9):.1%} of the kernel's time)")
        entries.append(entry(name, "volxel_tpu_torch/csrc/track_leg.cu", "volxel_tpu/render/mxu_gather.py:196",
                             t["err"], t["ms"], t["plain_ms"], t["bytes"], t["ops"]))
    return entries


def check_neg_log1m() -> None:
    """The legs' -logf(1 - xi) against -torch.log(1.0 - xi) at all 2^24
    values a draw takes (k * 2^-24), bit for bit."""
    import torch

    from volxel_tpu_torch.render.ddaleg import neg_log1m_cuda

    xi = torch.arange(2**24, dtype=torch.int32, device="cuda").to(torch.float32) * (1.0 / 16777216.0)
    got, want = neg_log1m_cuda(xi), -torch.log(1.0 - xi)
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    if bad:
        raise SystemExit(f"-logf(1 - xi) differs from -torch.log(1.0 - xi) at {bad} of the 2^24 draws")
    log(f"-logf(1 - xi) of the legs: bit-equal to -torch.log(1.0 - xi) at all {xi.numel()} draws")


# the sources phase 2 reads the SASS of, and in each the kernels whose own
# code must hold no FFMA (the leg kernels) with how many there are
SASS_CHECKS = {"dda_leg.cu": (r"dda_leg_(sample|shadow)_kernel", 3),
               "track_leg.cu": (r"track_leg_(sample|shadow)_kernel", 2), "tonemap.cu": (None, 0),
               "tile_march.cu": (None, 0)}


def sass_counts(sass: str) -> dict:
    """Per function of a cuobjdump -sass listing: {part: (FFMA, MUFU,
    instructions)} of its own code ("own") and of the out-of-line function
    at each CALL target, which cuobjdump lists after the code of the kernel
    that calls it."""
    found = {}
    for name, body in sass_functions(sass).items():
        calls = sorted({int(a, 16) for a in re.findall(r"CALL\.REL\S*\s+0x([0-9a-f]+)", body)})
        counts = {}
        for addr, text in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body):
            starts = [c for c in calls if c <= int(addr, 16)]
            part = hex(starts[-1]) if starts else "own"
            ffma, mufu, total = counts.get(part, (0, 0, 0))
            counts[part] = (ffma + ("FFMA" in text), mufu + ("MUFU" in text), total + 1)
        found[name] = counts
    return found


def sass_functions(sass: str) -> dict:
    """{function: its part of a cuobjdump -sass listing}."""
    return dict(re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S))


def event_loop(body: str, phases: int | None = None) -> dict | None:
    """The static size of a leg kernel's event loop in one function's SASS
    (`body`): of the loops in its own code (a BRA back to an address at or
    before it), the innermost one that calls the log (the out-of-line
    function called from the most sites) at least `phases` times, `phases`
    being how many events one pass of it takes (a loop unrolled over a ring
    of slots; by default as many as the innermost loop that calls the log
    at all calls it, one free flight an event). Returns its instructions,
    the log's, `phases`, and their sum per event: every instruction of the
    loop once a pass, branches not taken included, and one log an event.
    None where no such loop is found."""
    instrs = [(int(a, 16), text) for a, text in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    sites = re.findall(r"CALL\.REL\S*\s+0x([0-9a-f]+)", body)
    calls = sorted({int(a, 16) for a in sites})
    if not calls:
        return None
    ends = [*calls[1:], float("inf")]
    size = {c: sum(1 for a, _ in instrs if c <= a < e) for c, e in zip(calls, ends)}
    mufu = {c: sum(1 for a, text in instrs if c <= a < e and "MUFU" in text) for c, e in zip(calls, ends)}
    # the log: the function called from the most sites, and of those the
    # one without MUFU (logf is a polynomial; the division's reciprocal is
    # a MUFU.RCP)
    log_at = min(calls, key=lambda c: (-sites.count(f"{c:x}"), mufu[c]))
    own_end, log_instrs = calls[0], size[log_at]
    found = None
    for addr, text in instrs:
        m = re.search(r"\bBRA(?:\.\S+)?\s+(?:[^,;]*,\s*)?0x([0-9a-f]+)", text)
        if addr >= own_end or not m or int(m.group(1), 16) > addr:
            continue
        start = int(m.group(1), 16)
        span = [text2 for a2, text2 in instrs if start <= a2 <= addr]
        log_calls = sum(1 for t2 in span if re.search(rf"CALL\.REL\S*\s+0x0*{log_at:x}\b", t2))
        if log_calls >= (phases or 1) and (found is None or len(span) < found["loop_instructions"]):
            events = phases or log_calls
            found = {"loop_instructions": len(span), "log_instructions": log_instrs, "phases": events,
                     "per_event": len(span) / events + log_instrs}
    return found


def issue_floor_ms(per_event: float, warp_iterations: int, clock_mhz: float, sms: int) -> float:
    """The least time the card takes to issue `per_event` instructions at
    each of `warp_iterations` warp iterations of an event loop: 4
    warp-instructions a cycle per SM."""
    return per_event * warp_iterations / (sms * 4 * clock_mhz * 1e3)


def step_loop(body: str) -> dict | None:
    """The static SASS size of one step of a raymarch step-loop or sums
    kernel (`body`: one function's cuobjdump -sass listing): of the loops in
    its own code (a BRA back to an address at or before it), the innermost
    one that holds whole steps. A step is known by its nine IEEE divisions
    (the reservoir's compares, each with one FCHK range check) or, in a loop
    without them (the sums), by its one 2-byte tap load. Its steps a pass
    are those marks over their count a step. Per step: its instructions
    (every instruction of the loop once a pass, branches not taken
    included), and among them the divisions' MUFU.RCP, FCHK and CALL (to the
    slow path, whose own code at the CALL target a division reaches only
    outside FCHK's range and is not counted) and the 2-byte tap loads. None
    where no such loop is found."""
    instrs = [(int(a, 16), text) for a, text in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    calls = sorted({int(a, 16) for a in re.findall(r"CALL\.REL\S*\s+0x([0-9a-f]+)", body)})
    own_end = calls[0] if calls else float("inf")
    loops = []
    for addr, text in instrs:
        m = re.search(r"\bBRA(?:\.\S+)?\s+(?:[^,;]*,\s*)?0x([0-9a-f]+)", text)
        if addr < own_end and m and int(m.group(1), 16) <= addr:
            loops.append([t for a, t in instrs if int(m.group(1), 16) <= a <= addr])
    for mark, per in ((r"\bFCHK\b", 9), (r"\bLDG\S*\.U16\b", 1)):
        held = [span for span in loops if (n := sum(bool(re.search(mark, t)) for t in span)) >= per and n % per == 0]
        if held:
            best = min(held, key=len)
            steps = sum(bool(re.search(mark, t)) for t in best) // per
            break
    else:
        return None

    def per_step(pattern):
        return sum(bool(re.search(pattern, t)) for t in best) / steps

    return {"loop_instructions": len(best), "steps_per_pass": steps, "per_step": len(best) / steps,
            "mufu_rcp": per_step(r"MUFU\.RCP"), "fchk": per_step(r"\bFCHK\b"), "call": per_step(r"\bCALL\b"),
            "tap_loads": per_step(r"\bLDG\S*\.U16\b")}


def ptxas_registers(report: str) -> dict:
    """{kernel: registers} from an `nvcc -Xptxas -v` report."""
    found, kernel = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        kernel = m.group(1) if m else kernel
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            found[kernel] = int(m.group(1))
    return found


def check_sass() -> tuple[dict, dict, dict]:
    """Build csrc/dda_leg.cu, csrc/track_leg.cu and csrc/tonemap.cu once
    more, each to a cubin with `-Xptxas -v` (each kernel's registers, stack
    and spills, printed), all at once, and count the FFMA, MUFU and
    instructions in each kernel of their SASS (cuobjdump -sass): the leg
    kernels' own code must hold no FFMA, so no f32 operation of theirs is
    contracted. The log and the IEEE division, whose code needs FFMA, are
    out-of-line functions, counted apart. Returns the counts per source,
    and per source each function's SASS (sass_functions) and each kernel's
    registers (ptxas_registers)."""
    from volxel_tpu_torch import kernels

    nvcc = kernels._nvcc()
    kernels.BUILD.mkdir(parents=True, exist_ok=True)
    found, bodies, registers = {}, {}, {}
    with tempfile.TemporaryDirectory(dir=kernels.BUILD) as tmp:
        procs = {}
        for name in SASS_CHECKS:
            src = kernels.CSRC / name
            cubin = str(Path(tmp) / f"{src.stem}.cubin")
            procs[name] = (cubin, subprocess.Popen([nvcc, *kernels._flags(src), "-Xptxas", "-v", "-cubin", "-o", cubin,
                                                    str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                                   text=True))
        for name, (cubin, proc) in procs.items():
            _, ptxas = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise SystemExit(f"nvcc -cubin failed on {name}:\n{ptxas}")
            sass = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", cubin], capture_output=True,
                                  text=True, check=True, timeout=300).stdout
            log(f"{name}, nvcc -Xptxas -v:\n" + "\n".join(line for line in ptxas.splitlines() if "ptxas" in line
                                                          or "bytes" in line))
            found[name] = sass_counts(sass)
            bodies[name] = sass_functions(sass)
            registers[name] = ptxas_registers(ptxas)
    for name, (pattern, expected) in SASS_CHECKS.items():
        legs = {}
        for fn, counts in found[name].items():
            log(f"{name} SASS of {fn}: (FFMA, MUFU, instructions) of its own code and of the function at each call "
                f"target {counts}")
            if pattern and re.search(pattern, fn):
                legs[fn] = counts["own"][0]
        if pattern and (len(legs) != expected or any(legs.values())):
            raise SystemExit(f"the leg kernels' own SASS in {name} holds FFMA, or not every leg kernel was found: "
                             f"{legs}")
    return found, bodies, registers


def check_gather(r) -> list[dict]:
    """K2's two entry points, bit-equal: the LUT fetch where it still runs,
    at every call of one 1080p default-mode sample (the premultiplied
    pyramid, its only call), with its mean time per call beside the launch
    floor, an empty kernel over the grid of the mean call, timed the same
    way; gather_f32 at every call of
    one 1080p default-mode sample (the environment's bilinear taps and
    importance texels), beside torch.index_select on the same int32
    indices and torch.take on their int64 copy, then at one environment
    lookup over 1920x1080 seeded directions."""
    import torch

    from volxel_tpu_torch.render import gather
    from volxel_tpu_torch.render.pathtrace import render_sample
    from volxel_tpu_torch.scene.environment import lookup_environment

    def gather_cuda(table, idx):
        return gather.gather_f32_cuda(table.contiguous(), idx.contiguous())

    def gather_work(args, got):
        table, idx = args  # int32 indices: 4 bytes read and 4 written per word
        return nbytes(idx, *got) + min(nbytes(table), 4 * idx.numel()), idx.numel()

    def index_select(table, idx):
        return torch.index_select(table.reshape(-1), 0, idx.reshape(-1))

    def take_int64(table, idx):
        wide = idx.to(torch.int64)
        return lambda: torch.take(table, wide)

    take = {"torch.take (int64)": take_int64}

    def lut_cuda(lut, sample_range, density):
        return gather.lookup_transfer_cuda(lut.contiguous(), sample_range.contiguous(), density.contiguous())

    def lut_work(args, got):
        return nbytes(*args, *got), args[2].numel() * OPS_LUT_FETCH

    with compared_calls(gather, "lookup_transfer_fetch", lut_cuda, gather.lookup_transfer_plain, ("rgba",),
                        lambda a: a[2].numel(), lut_work) as lut:
        render_sample(*sample_operands(r), 0)
    log_tally("lookup_transfer", lut, f"one {r.width}x{r.height} default sample (the premultiplied pyramid)")
    mean_lanes = max(1, round(lut["lanes"] / max(lut["calls"], 1)))
    _, floor_ms = device_ms(lambda: gather.launch_floor(mean_lanes, torch.device("cuda")), KERNEL_REPS)
    per_call = lut["ms"] / max(lut["calls"], 1)
    log(f"lookup_transfer: {per_call * 1000:.3f} us per call (mean of {lut['calls']} calls, {mean_lanes} lanes on "
        f"average) beside a launch floor of {floor_ms * 1000:.3f} us (empty kernel, same grid): launches are "
        f"{floor_ms / per_call:.1%} of its time")
    (sel,) = check_every_call(r, gather, {"gather_f32": dict(
        cuda_fn=gather_cuda, plain_fn=gather.gather_f32_plain, outputs=("values",), lanes=lambda a: a[1].numel(),
        work=gather_work, library_fn=index_select, others=take)})
    log(f"gather_f32 over the sample: kernel {sel['ms']:.4f} ms, torch.index_select (int32) "
        f"{sel['library_ms']:.4f} ms, torch.take (int64) {sel['others']['torch.take (int64)']:.4f} ms, bound "
        f"{bound(sel['bytes'], sel['ops'])['bound_ms']:.4f} ms")

    rng = np.random.default_rng(2)
    d = rng.normal(size=(1920 * 1080, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dirs = torch.from_numpy(d).cuda()
    with compared_calls(gather, "gather_f32", gather_cuda, gather.gather_f32_plain, ("values",),
                        lambda a: a[1].numel(), gather_work, library_fn=index_select, others=take) as env:
        le = lookup_environment(r.environment.state, dirs)
    if not (env["calls"] == 1 and bool(torch.isfinite(le).all())):
        raise SystemExit(f"environment lookup: {env['calls']} gather calls, finite {bool(torch.isfinite(le).all())}")
    log(f"gather_f32: bit-equal at one environment lookup of {dirs.shape[0]} directions ({env['lanes']} words); "
        f"kernel {env['ms']:.4f} ms, plain {env['plain_ms']:.4f} ms, torch.index_select (int32) "
        f"{env['library_ms']:.4f} ms, torch.take (int64) {env['others']['torch.take (int64)']:.4f} ms, "
        f"bound {bound(env['bytes'], env['ops'])['bound_ms']:.4f} ms")
    source, replaces = "volxel_tpu_torch/csrc/gather.cu", "volxel_tpu/render/mxu_gather.py:196"
    return [entry("lookup_transfer", source, replaces, lut["err"], lut["ms"], lut["plain_ms"], lut["bytes"],
                  lut["ops"]),
            entry("gather_f32", source, replaces, sel["err"], sel["ms"], sel["plain_ms"], sel["bytes"],
                  sel["ops"], library_ms=sel["library_ms"])]


def check_pyramid(r) -> dict:
    """K3 on the default environment's 512^2 importance base, bit-equal to
    its plain version on every level, with its launches per build; timed
    beside the launch floor (one launch of an empty one-block kernel) and
    9 chained F.avg_pool2d(x, 2) calls (the same means)."""
    import torch
    import torch.nn.functional as F

    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.render.gather import launch_floor
    from volxel_tpu_torch.render.pallas_ops import build_importance_pyramid_cuda, build_importance_pyramid_plain

    base = r.environment.state.imp_mips[0]
    before = kernels.LAUNCHES["importance_pyramid"]
    got = build_importance_pyramid_cuda(base)
    launches = kernels.LAUNCHES["importance_pyramid"] - before
    want = build_importance_pyramid_plain(base)
    err = max_abs(got, want)
    bad = [tuple(a.shape) for a, b in zip(got, want) if not bits_equal(a, b)]
    if bad:
        raise SystemExit(f"importance pyramid levels {bad} differ from the plain version (max abs {err})")

    def pooled():
        level = base[None]
        for _ in range(len(got)):
            level = F.avg_pool2d(level, 2)
        return level

    _, ms = device_ms(lambda: build_importance_pyramid_cuda(base), 50)
    _, plain_ms = device_ms(lambda: build_importance_pyramid_plain(base), 50)
    _, library_ms = device_ms(pooled, 50)
    _, floor_ms = device_ms(lambda: launch_floor(1, torch.device("cuda")), 50)
    out_elems = sum(level.numel() for level in got)
    moved = nbytes(base, *got)
    log(f"importance_pyramid: bit-equal on all {len(got)} levels, {launches} launches per build; kernel {ms:.4f} ms "
        f"against a launch floor of {floor_ms:.4f} ms (one empty kernel; {launches} of them {launches * floor_ms:.4f} "
        f"ms), plain {plain_ms:.4f} ms, avg_pool2d {library_ms:.4f} ms, bound "
        f"{bound(moved, 4 * out_elems)['bound_ms']:.4f} ms")
    return entry("importance_pyramid", "volxel_tpu_torch/csrc/importance_pyramid.cu",
                 "volxel_tpu/render/pallas_ops.py:60", err, ms, plain_ms, moved, 4 * out_elems,
                 library_ms=library_ms)


def tonemap_every_input(exposure: float, gamma: float) -> None:
    """K4 against its plain version at all 2^32 f32 bit patterns (NaN
    payloads, +-inf, denormals and negatives among them), 2^28 at a time:
    bit-equal, NaN included."""
    import torch

    from volxel_tpu_torch.render.pallas_ops import tonemap_cuda, tonemap_plain

    chunk = 2**28
    bad = 0
    for first in range(-(2**31), 2**31, chunk):
        x = torch.arange(first, first + chunk, dtype=torch.int32, device="cuda").view(torch.float32).reshape(-1, 4)
        got = tonemap_cuda(x, exposure, gamma)
        bad += int((got.view(torch.int32) != tonemap_plain(x, exposure, gamma).view(torch.int32)).sum())
        del x, got
    if bad:
        raise SystemExit(f"tonemap differs from its plain version at {bad} of the 2^32 f32 inputs")
    log(f"tonemap: bit-equal to its plain version at all 2^32 f32 inputs (exposure {exposure}, gamma {gamma})")


def check_tonemap(exposure: float, gamma: float, sass: dict) -> dict:
    """K4 on a 1920x1080x3 buffer of seeded radiances, bit-equal, timed
    beside a plain 16-byte copy of the same buffer in the kernel's layout
    (the practical floor of a kernel that reads and writes it once) and
    torch's copy_; then at every f32 input. Its SASS instructions per float
    (the static count of the vector kernel's own code over the 4 floats a
    thread maps, the powf's slow paths included) against the card's issue
    rate (132 SMs x 4 warp instructions a clock at the card's top SM
    clock)."""
    import torch

    from volxel_tpu_torch.render.pallas_ops import copy16, tonemap_cuda, tonemap_plain

    fb = np.random.default_rng(1).uniform(0.0, 4.0, (1920 * 1080, 3)).astype(np.float32)
    fb = torch.from_numpy(fb).cuda()
    got = tonemap_cuda(fb, exposure, gamma)
    want = tonemap_plain(fb, exposure, gamma)
    err = max_abs([got], [want])
    if not bits_equal(got, want):
        raise SystemExit(f"tonemap kernel differs from its plain version (max abs {err})")
    _, ms = device_ms(lambda: tonemap_cuda(fb, exposure, gamma), 50)
    _, plain_ms = device_ms(lambda: tonemap_plain(fb, exposure, gamma), 50)
    _, copy_ms = device_ms(lambda: copy16(fb), 50)
    out = torch.empty_like(fb)
    _, torch_copy_ms = device_ms(lambda: out.copy_(fb), 50)
    moved, ops = nbytes(fb, got), fb.shape[0] * OPS_TONEMAP_PIXEL
    least = bound(moved, ops)
    (counts,) = [c for fn, c in sass["tonemap.cu"].items() if re.search(r"tonemap_kernel", fn)]
    per_float = counts["own"][2] / 4  # one float4 a thread
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    issue_ms = per_float * fb.numel() / 32 / (132 * 4 * mhz * 1e6) * 1e3
    log(f"tonemap: bit-equal on {fb.numel()} floats (max abs {err}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
        f"16-byte copy of the same buffer {copy_ms:.4f} ms, torch copy_ {torch_copy_ms:.4f} ms; bound "
        f"{least['bound_ms']:.4f} ms by {least['bound_by']} ({least['bound_ms'] / ms:.1%} of the kernel's time, the "
        f"copy at {least['bound_ms'] / copy_ms:.1%}); SASS of tonemap_kernel {counts} for its 4 floats a thread: "
        f"{per_float:.1f} instructions a float, {issue_ms:.4f} ms of issue at {mhz:.0f} MHz")
    tonemap_every_input(exposure, gamma)
    return entry("tonemap", "volxel_tpu_torch/csrc/tonemap.cu", "volxel_tpu/render/pallas_ops.py:115", err, ms,
                 plain_ms, moved, ops)


def check_tile_march(r, sass: dict, registers: dict) -> list[dict]:
    """K5 and the shadow leg's step loop at every call of one 1080p raymarch
    sample (the legs of each bounce; lanes counted: those inside the box),
    bit-equal on state, hit, t and rgb, or state and tau, of every lane;
    then K6 on that sample's camera rays at 64 steps, bit-equal, with its
    registers, resident warps, SASS a step, inside lanes and issue floor as
    below. Their work, as these inputs need it: every lane's `valid` and
    words read and its outputs written (words, and hit, t and rgb, or tau);
    for each lane inside the box its ray read and one 2-byte tap of the
    bf16 field per step it takes (a camera lane stops at its hit). Also,
    per step loop:
    its registers (`registers`: ptxas's report) and resident warps per SM
    (tilemarch.resident_warps), the SASS of one step (`sass`: tile_march.cu's
    functions, step_loop), the lanes inside the box and the warps (32 lanes
    in pixel order, as the kernels take them) that hold one, the warp
    efficiency (the steps the lanes take over 32 times the most a lane of
    the warp takes; in the shadow leg, where every lane inside takes all
    STEPS, the inside lanes over 32 times those warps) and the issue
    floor (a step's SASS at every warp step over 4 a cycle on every SM at
    the card's largest clock)."""
    import torch

    import volxel_tpu_torch.render.modes as modes
    from volxel_tpu_torch.render import tilemarch
    from volxel_tpu_torch.render.tilemarch import (
        STEPS,
        tile_march_sample_cuda,
        tile_march_sample_plain,
        tile_march_sums_cuda,
        tile_march_sums_plain,
        tile_march_transmittance_cuda,
        tile_march_transmittance_plain,
    )

    warps = {}  # per leg: [lanes inside, warps with one, steps taken, warp steps]

    def warp_tally(leg, valid, steps):
        n = valid.numel()
        pad = (-n) % 32
        per_warp = torch.nn.functional.pad(torch.where(valid, steps, 0), (0, pad)).reshape(-1, 32)
        w = warps.setdefault(leg, [0, 0, 0, 0])
        w[0] += int(valid.sum())
        w[1] += int(torch.nn.functional.pad(valid, (0, pad)).reshape(-1, 32).any(dim=1).sum())
        w[2] += int(per_warp.sum())
        w[3] += int(per_warp.amax(dim=1).sum())

    def sample_work(args, got):
        dense, ipos, idir, start, dt, far, valid, tau_target, state, lut, scalars, _ = args
        _, hit, t, _ = got
        taken = torch.clamp(torch.round((t - start) / dt) + 1, 1, STEPS)
        per_lane = torch.where(hit, taken, float(STEPS)).to(torch.int64)
        warp_tally("sample", valid, per_lane)
        steps = int(per_lane[valid].sum())
        inside = int(valid.sum())
        rays = inside * nbytes(ipos, idir, start, dt, far, tau_target) // start.numel()
        moved = nbytes(valid, lut, scalars, state, *got) + rays + min(nbytes(dense), 2 * steps)
        return moved, steps * OPS_TILE_STEP

    def transmittance_work(args, got):
        dense, ipos, idir, start, dt, far, valid, state, lut, scalars, _ = args
        warp_tally("shadow", valid, torch.full_like(valid, STEPS, dtype=torch.int64))
        inside = int(valid.sum())
        steps = inside * STEPS
        rays = inside * nbytes(ipos, idir, start, dt, far) // start.numel()
        moved = nbytes(valid, lut, scalars, state, *got) + rays + min(nbytes(dense), 2 * steps)
        return moved, steps * OPS_TILE_STEP

    sample, shadow = check_every_call(r, modes, {
        "tile_march_sample": dict(cuda_fn=tile_march_sample_cuda, plain_fn=tile_march_sample_plain,
                                  outputs=("state", "hit", "t", "rgb"), lanes=lambda a: int(a[6].sum()),
                                  work=sample_work),
        "tile_march_transmittance": dict(cuda_fn=tile_march_transmittance_cuda,
                                         plain_fn=tile_march_transmittance_plain, outputs=("state", "tau"),
                                         lanes=lambda a: int(a[6].sum()), work=transmittance_work),
    })
    clock, sms = sm_clock_mhz(), torch.cuda.get_device_properties(0).multi_processor_count
    lut_k = sample["first_args"][9].shape[0]
    # the kernels the main path runs: those with a 32-bit tap index
    symbols = {"sample": "tile_march_sample_kernelILb1E", "shadow": "tile_march_transmittance_kernelILb1E",
               "sums": "tile_march_sums_kernelILb1E"}
    for leg, name, t in (("sample", "tile_march_sample", sample), ("shadow", "tile_march_transmittance", shadow)):
        inside, with_inside, steps, warp_steps = warps[leg]
        kernel = next(fn for fn in sass if symbols[leg] in fn)
        loop = step_loop(sass[kernel])
        if loop is None:
            raise SystemExit(f"{name}: no step loop found in its SASS")
        floor = issue_floor_ms(loop["per_step"], warp_steps, clock, sms)
        least = bound(t["bytes"], t["ops"])
        log(f"{name}: {t['calls']} launches, kernel {t['ms']:.4f} ms, bound {least['bound_ms']:.4f} ms by "
            f"{least['bound_by']} ({least['bound_ms'] / max(t['ms'], 1e-9):.1%}); {inside} lanes inside the box in "
            f"{with_inside} warps with an inside lane; warp efficiency {steps / max(32 * warp_steps, 1):.4f} "
            f"({steps} steps of {32 * warp_steps} warp lane-steps; inside lanes over 32 x those warps "
            f"{inside / max(32 * with_inside, 1):.4f}); {registers[kernel]} registers, "
            f"{tilemarch.resident_warps(leg, lut_k, 'cuda')} resident warps per SM (LUT of {lut_k} rows); step loop "
            f"{loop['loop_instructions']} SASS instructions a pass of {loop['steps_per_pass']} steps = "
            f"{loop['per_step']:.1f} a step (MUFU.RCP {loop['mufu_rcp']:.1f}, FCHK {loop['fchk']:.1f}, CALL "
            f"{loop['call']:.1f}, 2-byte tap loads {loop['tap_loads']:.1f}); issue floor {floor:.4f} ms "
            f"({warp_steps} warp steps, {sms} SMs at {clock:.0f} MHz; {floor / max(t['ms'], 1e-9):.1%} of the "
            f"kernel's time)")
    source = "volxel_tpu_torch/csrc/tile_march.cu"
    entries = [entry("tile_march_sample", source, "volxel_tpu/render/tilemarch.py:627", sample["err"], sample["ms"],
                     sample["plain_ms"], sample["bytes"], sample["ops"]),
               entry("tile_march_transmittance", source, "volxel_tpu/render/mxu_gather.py:196", shadow["err"],
                     shadow["ms"], shadow["plain_ms"], shadow["bytes"], shadow["ops"])]
    tally = sample

    dense, ipos, idir, start, dt, far, valid, _, _, _, _, extent = tally["first_args"]
    args = (dense, ipos, idir, start, dt, far, valid, extent, STEPS)
    got, ms = device_ms(lambda: tile_march_sums_cuda(*args), KERNEL_REPS)
    want, plain_ms = device_ms(lambda: tile_march_sums_plain(*args))
    err = max_abs([got], [want])
    if not bits_equal(got, want):
        raise SystemExit(f"tile_march_sums differs from its plain version (max abs {err})")
    inside = int(valid.sum())
    with_inside = int(torch.nn.functional.pad(valid, (0, (-valid.numel()) % 32)).reshape(-1, 32).any(dim=1).sum())
    steps = inside * STEPS
    rays = inside * nbytes(ipos, idir, start, dt, far) // start.numel()
    moved, ops = nbytes(valid, got) + rays + min(nbytes(dense), 2 * steps), steps * OPS_SUMS_STEP
    least = bound(moved, ops)
    kernel = next(fn for fn in sass if symbols["sums"] in fn)
    loop = step_loop(sass[kernel])
    if loop is None:
        raise SystemExit("tile_march_sums: no step loop found in its SASS")
    floor = issue_floor_ms(loop["per_step"], with_inside * STEPS, clock, sms)
    log(f"tile_march_sums: bit-equal on the {ipos.shape[0]} camera rays of that sample at {STEPS} steps "
        f"(mean sum {float(got.mean()):.4f}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{least['bound_ms']:.4f} ms by {least['bound_by']} ({least['bound_ms'] / max(ms, 1e-9):.1%}); {inside} lanes "
        f"inside the box in {with_inside} warps with an inside lane; {registers[kernel]} registers, "
        f"{tilemarch.resident_warps('sums', lut_k, 'cuda')} resident warps per SM; step loop "
        f"{loop['loop_instructions']} SASS instructions a pass of {loop['steps_per_pass']} steps = "
        f"{loop['per_step']:.2f} a step (2-byte tap loads {loop['tap_loads']:.1f}); issue floor {floor:.4f} ms "
        f"({with_inside * STEPS} warp steps; {floor / max(ms, 1e-9):.1%} of the kernel's time)")
    sums = entry("tile_march_sums", source, "volxel_tpu/render/tilemarch.py:293", err, ms, plain_ms, moved, ops)
    return entries + [sums]


def shearwarp_pixel_slices(vol, lut, sx: float, sy: float, inv_maj: float, sigma_dt: float, fixed_canvas: bool,
                           t_kernel) -> int:
    """The pixel-slices of the footprints whose t before the slice is not
    +-0 (the others keep their colour: only their alpha is blended), by
    the plain version's alpha blend, slice by slice on the card. Its t must
    end bit-equal to the kernel's `t_kernel`."""
    import torch

    from volxel_tpu_torch.render import shearwarp

    z_n, y_n, x_n = vol.shape
    out_h, out_w, params = shearwarp.canvas(vol.shape, sx, sy, inv_maj, sigma_dt, fixed_canvas)
    iy, ix, fy, fx = shearwarp.slice_shifts(params, vol.shape, out_h, out_w)
    fy, fx = fy.to(vol.device), fx.to(vol.device)
    p = shearwarp.upload(params, vol.device)
    t = torch.ones((out_h, out_w), dtype=torch.float32, device=vol.device)
    live = torch.zeros((), dtype=torch.int64, device=vol.device)
    for z, (y0, x0) in enumerate(zip(iy.tolist(), ix.tolist())):
        _, alpha = shearwarp._classify(vol[z].to(torch.float32), lut, p[shearwarp.P_INV_MAJ],
                                       p[shearwarp.P_SIGMA_DT])
        a = shearwarp._frac_block(alpha[..., None], fy[z], fx[z])[..., 0]
        rows, cols = slice(y0, y0 + y_n + 1), slice(x0, x0 + x_n + 1)
        live += (t[rows, cols] != 0).sum()
        t[rows, cols] = t[rows, cols] * (1.0 - a)
    if not bits_equal(t, t_kernel):
        raise SystemExit("shearwarp_intermediate: the alpha blend that counts the work ends on another t")
    return int(live)


def check_shearwarp(r) -> dict:
    """K7 on the 512^3 volume: at the bench view on the preview's fixed
    canvas (the main path's shape) and at STATIC_VIEW on its static
    canvas, against the plain slice loop on the card; then on the fixed
    canvas through the Renderer's default transfer (air transparent, a
    linear ramp to opaque white), where part of the tiles turn opaque, and
    at TRANSLUCENT times the bench's density, where none does (the kernel
    then composites every pixel-slice, as it would without its opaque-tile
    path). Bit-equal, or within 1e-6 where only the card's expf and ATen's
    exp can round apart. Its work, as these inputs need it: the bf16 volume
    read once, each voxel's LUT index and each LUT row's alpha' once, each
    footprint pixel of a slice composited while its t is not +-0 and only
    its alpha blended after, the colour and transmittance written once."""
    import torch

    from volxel_tpu_torch.render import shearwarp
    from volxel_tpu_torch.transfer.function import DEFAULT_COLOR_STOPS, generate_transfer_function

    density = float(r.density_scale * r.settings.density_multiplier)
    default_lut = torch.as_tensor(generate_transfer_function(DEFAULT_COLOR_STOPS), dtype=torch.float32).cuda()
    results = {}
    for canvas, view, scale, lut in (("fixed", r._index_view_dir(), 1.0, r._lut),
                                     ("static", np.array(STATIC_VIEW), 1.0, r._lut),
                                     ("default-transfer fixed", r._index_view_dir(), 1.0, default_lut),
                                     ("translucent fixed", r._index_view_dir(), TRANSLUCENT, r._lut)):
        perm, flip, sx, sy = shearwarp.shear_parameters(view)
        vol = shearwarp.permuted_volume(r._device_grid.dense, perm, flip)
        sigma_dt = scale * density * float(np.sqrt(1.0 + sx * sx + sy * sy))
        args = (vol, lut, sx, sy, 1.0, sigma_dt, canvas != "static")
        got, ms = device_ms(lambda: shearwarp.shearwarp_intermediate_cuda(*args), KERNEL_REPS)
        want, plain_ms = device_ms(lambda: shearwarp.shearwarp_intermediate_plain(*args))
        err = max_abs(got, want)
        equal = all(bits_equal(a, b) for a, b in zip(got, want))
        if not (equal or err <= 1e-6):
            raise SystemExit(f"shearwarp_intermediate ({canvas} canvas) differs from its plain version by {err}")
        z_n, y_n, x_n = vol.shape
        pixel_slices = z_n * (y_n + 1) * (x_n + 1)
        live = shearwarp_pixel_slices(*args, got[1])
        moved = nbytes(vol, lut, *got)
        ops = (z_n * y_n * x_n * OPS_SW_VOXEL + lut.shape[0] * OPS_SW_LUT_ROW + live * OPS_SW_PIXEL
               + (pixel_slices - live) * OPS_SW_OPAQUE_PIXEL)
        t = got[1]
        least = bound(moved, ops)
        log(f"shearwarp_intermediate ({canvas} canvas {tuple(t.shape)}, perm {perm}, flip {flip}, "
            f"s=({sx:.4f}, {sy:.4f})): {'bit-equal' if equal else f'within 1e-6 (max abs {err:.3e})'}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {least['bound_ms']:.4f} ms by {least['bound_by']} "
            f"({moved / 1e6:.1f} MB, {ops / 1e9:.3f} Gop; {least['bound_ms'] / ms:.1%} of the kernel's time); "
            f"{live} of {pixel_slices} footprint pixel-slices with t != 0 before the slice "
            f"({live / pixel_slices:.4f}); min t {float(t.min()):.4f}, share of t == 0 "
            f"{float((t == 0).float().mean()):.4f}, last row t == 1: {bool((t[-1] == 1).all())}")
        results[canvas] = entry("shearwarp_intermediate", "volxel_tpu_torch/csrc/shearwarp.cu",
                                "volxel_tpu/render/shearwarp.py:435", err, ms, plain_ms, moved, ops)
        del vol, got, want
        torch.cuda.empty_cache()
    return results["fixed"]


# the kernels each mode's main path must launch
PATH_KERNELS = {
    "default": ("dda_leg_sample", "dda_leg_shadow", "lookup_transfer", "gather_f32",
                "importance_pyramid", "tonemap"),
    "raymarch": ("tile_march_sample", "tile_march_transmittance", "gather_f32", "importance_pyramid", "tonemap"),
    "no_dda": ("track_leg_sample", "track_leg_shadow", "gather_f32", "importance_pyramid", "tonemap"),
    "preview": ("shearwarp_intermediate", "tonemap"),
}
# each mode's two legs, each one launch per bounce
MODE_LEGS = {"default": ("dda_leg_sample", "dda_leg_shadow"),
             "raymarch": ("tile_march_sample", "tile_march_transmittance"),
             "no_dda": ("track_leg_sample", "track_leg_shadow")}
# the path whose run gives each kernel's launch count (K6 lies on none:
# its count from the raymarch run is 0)
KERNEL_PATH = {"dda_leg_sample": "default", "dda_leg_shadow": "default", "track_leg_sample": "no_dda",
               "track_leg_shadow": "no_dda", "lookup_transfer": "default", "gather_f32": "default", "importance_pyramid": "default",
               "tonemap": "default", "tile_march_sample": "raymarch", "tile_march_transmittance": "raymarch",
               "tile_march_sums": "raymarch", "shearwarp_intermediate": "preview"}


def main_path(grid, width: int, height: int, mode: str) -> dict:
    """The Renderer from construction to image() in one render mode, with
    every launch counter at 0 just before it starts; the counts just after."""
    import torch

    from volxel_tpu_torch import kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    r = bench_renderer(grid, width, height, "cuda", mode)
    for _ in range(WARMUP_FRAMES):
        r.render_frame()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches_before = dict(kernels.LAUNCHES)
    for _ in range(ACCUMULATED_FRAMES):
        r.render_frame()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counted = {k: kernels.LAUNCHES[k] - launches_before[k] for k in kernels.LAUNCHES}
    per_sample = {k: n / ACCUMULATED_FRAMES for k, n in counted.items()}
    img = r.image()
    launches = dict(kernels.LAUNCHES)
    raw = r._framebuffer
    log(f"main path ({mode}): {width}x{height}, setup + {WARMUP_FRAMES} warm-up frames {t1 - t0:.3f} s, "
        f"{(t2 - t1) * 1000 / ACCUMULATED_FRAMES:.3f} ms/sample over {ACCUMULATED_FRAMES} accumulated frames, "
        f"launches per sample {per_sample}, peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    log(f"launches ({mode}): {launches}")
    if img.shape != (height, width, 3) or not np.isfinite(img).all():
        raise SystemExit(f"image() gave shape {img.shape} or non-finite values")
    mean = float(raw.mean())
    if not (bool(torch.isfinite(raw).all()) and mean > 0.0):
        raise SystemExit(f"framebuffer not finite or mean radiance {mean} <= 0")
    for name in PATH_KERNELS[mode]:
        if launches[name] <= 0:
            raise SystemExit(f"kernel {name} was not launched on the {mode} main path")
    # the LUT fetch runs once per default sample (the premultiplied pyramid)
    # and nowhere in the other modes' legs; each leg is one launch per
    # bounce
    if per_sample["lookup_transfer"] != (1 if mode == "default" else 0):
        raise SystemExit(f"the LUT fetch launched {per_sample['lookup_transfer']} times per {mode} sample")
    legs = tuple(per_sample[name] for name in MODE_LEGS[mode])
    if legs != (r.settings.bounces,) * 2:
        raise SystemExit(f"the {mode} legs launched {legs} times per sample at bounces {r.settings.bounces}")
    log(f"main path output ({mode}): mean radiance {mean:.6f}, image mean {float(img.mean()):.6f}")
    return launches


def host_syncs(fn):
    """(output, where) of one call of `fn`: `where` lists the file:line of
    each synchronizing call PyTorch made inside it, which
    torch.cuda.set_sync_debug_mode("warn") reports as a warning."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]


def leg_split(r) -> tuple:
    """One sample of `r` with a synchronize around each leg (the mode's
    sample_volume and transmittance): (the sample's ms, each leg's ms, the
    host syncs inside each leg (host_syncs), the repo's kernel launches in
    each leg)."""
    import torch

    import volxel_tpu_torch.render.pathtrace as pathtrace
    from volxel_tpu_torch import kernels

    legs = {"camera": 0.0, "shadow": 0.0}
    syncs = {"camera": [], "shadow": []}
    launches = {"camera": 0, "shadow": 0}

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            before = sum(kernels.LAUNCHES.values())
            t0 = time.perf_counter()
            out, where = host_syncs(lambda: fn(*args))
            torch.cuda.synchronize()
            legs[name] += (time.perf_counter() - t0) * 1000
            syncs[name] += where
            launches[name] += sum(kernels.LAUNCHES.values()) - before
            return out
        return run

    original = pathtrace.get_mode_functions

    def split(mode, physical_shadows=False):
        sample_volume, transmittance = original(mode, physical_shadows)
        return timed("camera", sample_volume), timed("shadow", transmittance)

    pathtrace.get_mode_functions = split
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render_frame()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1000
    finally:
        pathtrace.get_mode_functions = original
    return total, legs, syncs, launches


def breakdown(grid, width: int, height: int, mode: str, bounces: int = 1) -> None:
    """One sample split into its legs (leg_split: each leg's ms, the repo's
    kernel launches in the legs and the host syncs inside them, which
    host_syncs must first see a known sync to count), then one unprofiled
    and one profiled sample (log_device_profile). Raises if the legs
    synchronize with the host."""
    import torch

    if not host_syncs(lambda: bool(torch.ones(1, device="cuda").any()))[1]:
        raise SystemExit("the host-sync count does not see bool() of a CUDA tensor")
    r = bench_renderer(grid, width, height, "cuda", mode, bounces)
    r.render_frame()  # warm
    total, legs, syncs, launches = leg_split(r)
    log(f"{mode} legs at bounces {bounces}: one sample {total:.3f} ms with a synchronize around each leg: camera "
        f"leg {legs['camera']:.3f} ms, shadow leg {legs['shadow']:.3f} ms, rest "
        f"{total - legs['camera'] - legs['shadow']:.3f} ms; launches of the repo's kernels in the legs {launches}, "
        f"host syncs in the legs {({k: len(v) for k, v in syncs.items()})} at {syncs}")
    if any(syncs.values()):
        raise SystemExit(f"the {mode} legs synchronized with the host at {syncs}")

    _, wall = timed_call(r.render_frame)
    log_device_profile(f"{mode} (bounces {bounces})", r.render_frame, wall)


def log_device_profile(what: str, fn, wall_ms: float) -> None:
    """Profile one call of `fn`: device kernels, device busy time against
    an unprofiled call's `wall_ms` (the idle share), the largest kernels
    and the torch.nonzero calls (each a host sync)."""
    prof = profile_call(fn)
    device = device_events(prof)
    busy = sum(e.device_time_total for e in device) / 1000
    count = sum(e.count for e in device)
    nonzero = sum(e.count for e in prof.key_averages() if e.key == "aten::nonzero")
    top = sorted(device, key=lambda e: -e.device_time_total)[:4]
    log(f"{what} profile: one call, {count} device kernels, {nonzero} torch.nonzero calls, device busy {busy:.3f} ms "
        f"against an unprofiled call of {wall_ms:.3f} ms (idle share {1 - busy / wall_ms:.3f}); largest: "
        + "; ".join(f"{e.key[:70]} {e.device_time_total / 1000:.3f} ms x{e.count}" for e in top))


def timed_call(fn):
    """(output, host ms) of one call between two torch.cuda.synchronize()."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1000


def check_image(img, width: int, height: int, what: str) -> None:
    if img.shape != (height, width, 3) or not np.isfinite(img).all():
        raise SystemExit(f"{what}: shape {img.shape} or non-finite values")
    if not float(img.max() - img.min()) > 1e-3:
        raise SystemExit(f"{what}: the image is constant ({float(img.min())})")


def preview_path(grid, width: int, height: int) -> dict:
    """The interactive preview through the Renderer, with every launch
    counter at 0 just before it: render_preview() at each pose (its first
    call builds the permuted volume of its (principal axis, flip)), then
    render_dvr(screen=True) once; the counts just after."""
    import torch

    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.render.shearwarp import shear_parameters

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    r = bench_renderer(grid, width, height, "cuda")
    keys, later, shears = [], [], []
    for pose in PREVIEW_POSES:
        r.camera.rotate_around_view(*pose)
        perm, flip, sx, sy = shear_parameters(r._index_view_dir())
        key = (perm, flip)
        shears.append((key, sx, sy))
        img, first_ms = timed_call(r.render_preview)
        check_image(img, width, height, f"render_preview at {key}")
        ms = [timed_call(r.render_preview)[1] for _ in range(PREVIEW_REPEATS)]
        later += ms
        keys.append(key)
        log(f"preview {key}: first call {first_ms:.3f} ms (its permuted volume built), then "
            f"{sum(ms) / len(ms):.3f} ms mean of {len(ms)}; image mean {float(img.mean()):.4f}")
    if len(set(keys)) != 6:
        raise SystemExit(f"the preview poses used {len(set(keys))} of the 6 (perm, flip) volumes: {keys}")
    img, dvr_ms = timed_call(lambda: r.render_dvr(screen=True))
    check_image(img, width, height, "render_dvr(screen=True)")
    launches = dict(kernels.LAUNCHES)
    log_device_profile("preview", r.render_preview, later[-1])
    preview_kernel_times(r, shears)
    calls = len(PREVIEW_POSES) * (1 + PREVIEW_REPEATS) + 1
    log(f"main path (preview): {width}x{height}, {len(PREVIEW_POSES)} poses x {1 + PREVIEW_REPEATS} previews, "
        f"{sum(later) / len(later):.3f} ms per preview after its volume's first call; render_dvr(screen=True) "
        f"{dvr_ms:.3f} ms; {calls} images, launches shearwarp_intermediate {launches['shearwarp_intermediate']}, "
        f"tonemap {launches['tonemap']}; peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    for name in PATH_KERNELS["preview"]:
        if launches[name] <= 0:
            raise SystemExit(f"kernel {name} was not launched on the preview main path")
    return launches


def profile_keys(fn) -> list:
    """(key, device type, count, host ms, device ms) of every entry of
    torch.profiler's key_averages() over one call of `fn`."""
    return [(e.key, str(e.device_type).rsplit(".", 1)[-1], e.count, e.cpu_time_total / 1000,
             e.device_time_total / 1000) for e in profile_call(fn).key_averages()]


def preview_kernel_times(r, shears) -> None:
    """K7 alone at each preview pose, on that pose's cached volume and the
    fixed canvas: held to the plain slice loop (bit-equal, or within 1e-6
    where only expf and ATen's exp can round apart), CUDA events (the mean
    of KERNEL_REPS launches) beside the profiler's device time of one
    launch. Every key of the first pose's profile is listed."""
    from volxel_tpu_torch.render.shearwarp import shearwarp_intermediate_cuda, shearwarp_intermediate_plain

    density = float(r.density_scale * r.settings.density_multiplier)
    for i, ((perm, flip), sx, sy) in enumerate(shears):
        args = (r._preview_volume(perm, flip), r._lut, sx, sy, 1.0,
                density * float(np.sqrt(1.0 + sx * sx + sy * sy)), True)
        got, ms = device_ms(lambda: shearwarp_intermediate_cuda(*args), KERNEL_REPS)
        want = shearwarp_intermediate_plain(*args)
        err = max_abs(got, want)
        equal = all(bits_equal(a, b) for a, b in zip(got, want))
        if not (equal or err <= 1e-6):
            raise SystemExit(f"shearwarp_intermediate at the preview's {(perm, flip)} pose differs from its plain "
                             f"version by {err}")
        keys = profile_keys(lambda: shearwarp_intermediate_cuda(*args))
        if i == 0:
            log(f"profile of one launch of shearwarp_intermediate_cuda between {PROFILE_PAD} launches of the empty "
                "kernel before and after it, every key (type, count, host ms, device ms): "
                + "; ".join(f"{k} [{kind}, {n}, {host:.4f}, {dev:.4f}]" for k, kind, n, host, dev in keys))
        prof_ms = sum(dev for k, kind, _, _, dev in keys if kind != "CPU" and "shearwarp_kernel" in k)
        if ms > 0 and prof_ms == 0:
            raise SystemExit(f"the profiler recorded no shearwarp_kernel at the {(perm, flip)} pose, where events "
                             f"read {ms:.4f} ms")
        log(f"shearwarp_intermediate at the preview's {(perm, flip)} pose, s=({sx:.4f}, {sy:.4f}): "
            f"{'bit-equal' if equal else f'within 1e-6 (max abs {err:.3e})'}; events {ms:.4f} ms, "
            f"profiler {prof_ms:.4f} ms")


def preview_parity(grid, size: int) -> None:
    """The preview at the first three poses on the card and on the CPU
    (plain versions): deterministic, so held to max abs err 1e-5 on the
    tonemapped image."""
    images = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        r = bench_renderer(grid, size, size, device)
        images[device] = []
        for pose in PREVIEW_POSES[:3]:
            r.camera.rotate_around_view(*pose)
            images[device].append(r.render_preview())
        log(f"parity preview on {device}: {time.perf_counter() - t0:.2f} s")
    err = max(float(np.abs(a - b).max()) for a, b in zip(images["cuda"], images["cpu"]))
    log(f"parity {size}x{size} (preview, 3 poses): max abs err {err:.3e}")
    if not err <= PREVIEW_PARITY_ATOL:
        raise SystemExit(f"card and CPU previews differ by {err} > {PREVIEW_PARITY_ATOL}")


def parity(grid, size: int, mode: str) -> None:
    """The same scene on the card and on the CPU, held to the slice contract."""
    images = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        r = bench_renderer(grid, size, size, device, mode)
        for _ in range(PARITY_FRAMES):
            r.render_frame()
        images[device] = r._framebuffer.cpu().numpy().astype(np.float64)
        log(f"parity render ({mode}) on {device}: {time.perf_counter() - t0:.2f} s")
    gpu, cpu = images["cuda"], images["cpu"]
    rel = np.abs(gpu - cpu) / (np.abs(cpu) + 1e-3)
    tight = float((rel.max(axis=-1) < 1e-3).mean())
    median = float(np.median(rel))
    means = (float(gpu.mean()), float(cpu.mean()))
    log(f"parity {size}x{size} ({mode}): {tight:.4%} of pixels within 0.1%, median rel {median:.3e}, "
        f"means {means[0]:.6f} (card) {means[1]:.6f} (cpu)")
    if not (tight > 0.98 and median < 1e-4 and abs(means[0] - means[1]) < 5e-3 * max(means[1], 1e-3)):
        raise SystemExit(f"card and CPU renders ({mode}) disagree beyond the parity contract")


# phase 2b: the reference's own benchmark spec (three entries, one per
# mode, at bounces 1, resolutionFactor 0.8 and 500 samples) on a DICOM zip
# and an HDR environment that the fixture writers make here
REFERENCE_SPEC = Path(__file__).resolve().parent / "tests" / "fixtures" / "reference_benchmark.json"
ENV_SIZE = (2048, 1024)
RESIZE_REPS = 3


# phase 2b's comparisons: for each render mode, the kernels one sample
# launches, each as (module whose attribute the sample calls, that name,
# the CUDA entry, the plain version, the outputs held bit for bit)
def spec_sample_kernels(mode: str) -> list:
    import volxel_tpu_torch.render.modes as modes
    from volxel_tpu_torch.render import ddaleg, gather, tilemarch, trackleg

    def gather_cuda(table, idx):
        return gather.gather_f32_cuda(table.contiguous(), idx.contiguous())

    def lut_cuda(lut, sample_range, density):
        return gather.lookup_transfer_cuda(lut.contiguous(), sample_range.contiguous(), density.contiguous())

    taps = (gather, "gather_f32", gather_cuda, gather.gather_f32_plain, ("values",))
    if mode == "default":
        return [(modes, "dda_leg_sample", ddaleg.dda_leg_sample_cuda, ddaleg.dda_leg_sample_plain,
                 ("state", "hit", "t", "rgb", "budget")),
                (modes, "dda_leg_shadow", ddaleg.dda_leg_shadow_cuda, ddaleg.dda_leg_shadow_plain,
                 ("state", "tr", "budget")),
                (gather, "lookup_transfer_fetch", lut_cuda, gather.lookup_transfer_plain, ("rgba",)), taps]
    if mode == "no_dda":
        return [(modes, "track_leg_sample", trackleg.track_leg_sample_cuda, trackleg.track_leg_sample_plain,
                 ("state", "hit", "t", "rgb", "events")),
                (modes, "track_leg_shadow", trackleg.track_leg_shadow_cuda, trackleg.track_leg_shadow_plain,
                 ("state", "tr", "events")), taps]
    return [(modes, "tile_march_sample", tilemarch.tile_march_sample_cuda, tilemarch.tile_march_sample_plain,
             ("state", "hit", "t", "rgb")),
            (modes, "tile_march_transmittance", tilemarch.tile_march_transmittance_cuda,
             tilemarch.tile_march_transmittance_plain, ("state", "tau")), taps]


def hold_spec_kernels(r, spec: dict) -> None:
    """Every kernel of the reference spec's path against its plain version
    on the spec's own inputs: the spec renderer's ingested grid and loaded
    map. For each entry, with its settings on `r`, one render_frame() (the
    first frame after the restart, which image() then shows alone) with
    each kernel of the mode's sample (spec_sample_kernels: the legs, the
    map's taps and texels through gather_f32, the default mode's LUT fetch)
    held bit for bit at every call, then K4 at image(); K3 on the map's
    512^2 importance base. Launches made here are not the main path's."""
    import volxel_tpu_torch.render.pallas_ops as pallas_ops
    from volxel_tpu_torch.api.benchmark import apply_entry_settings

    def no_work(args, got):
        return 0, 0

    for entry in spec["benchmarks"]:
        apply_entry_settings(spec, entry, r)
        checks = spec_sample_kernels(entry["renderMode"])
        with contextlib.ExitStack() as stack:
            tallies = [stack.enter_context(compared_calls(module, name, cuda_fn, plain_fn, outputs, lambda a: 0,
                                                          no_work))
                       for module, name, cuda_fn, plain_fn, outputs in checks]
            r.render_frame()
        with compared_calls(pallas_ops, "tonemap_cuda", pallas_ops.tonemap_cuda, pallas_ops.tonemap_plain,
                            ("image",), lambda a: 0, no_work) as tonemap:
            img = r.image()
        w, h = r._render_dims()
        for (_, name, *_), tally in (*zip(checks, tallies), (("", "tonemap"), tonemap)):
            if tally["calls"] == 0:
                raise SystemExit(f"{name} was not called in one {entry['renderMode']} sample of the reference spec")
            log(f"reference spec, {entry['renderMode']} ({w}x{h}): {name} bit-equal at all {tally['calls']} calls "
                f"of one sample; kernel {tally['ms']:.4f} ms, plain {tally['plain_ms']:.4f} ms summed over them")
        if not np.isfinite(img).all():
            raise SystemExit(f"image() of the held {entry['renderMode']} sample is not finite")
    base = r.environment.state.imp_mips[0]
    got = pallas_ops.build_importance_pyramid_cuda(base)
    want = pallas_ops.build_importance_pyramid_plain(base)
    bad = [tuple(a.shape) for a, b in zip(got, want) if not bits_equal(a, b)]
    if bad:
        raise SystemExit(f"importance pyramid of the loaded map: levels {bad} differ from the plain version "
                         f"(max abs {max_abs(got, want)})")
    log(f"reference spec: importance_pyramid bit-equal on all {len(got)} levels of the loaded map's "
        f"{base.shape[0]}x{base.shape[1]} base")


@contextlib.contextmanager
def first_calls(cls, names):
    """While the block runs, time the first call of each method `names` of
    `cls` (on any instance), fenced on the instance's device. Yields
    {name: (start, end)} in time.perf_counter() seconds."""
    from volxel_tpu_torch.utils.profiling import fence_device

    seen = {}
    originals = {name: getattr(cls, name) for name in names}

    def timed(name, fn):
        @functools.wraps(fn)
        def call(self, *args, **kwargs):
            if name in seen:
                return fn(self, *args, **kwargs)
            t0 = time.perf_counter()
            out = fn(self, *args, **kwargs)
            fence_device(self.device)
            seen[name] = (t0, time.perf_counter())
            return out
        return call

    for name, fn in originals.items():
        setattr(cls, name, timed(name, fn))
    try:
        yield seen
    finally:
        for name, fn in originals.items():
            setattr(cls, name, fn)


def staged_ingest(data: bytes):
    """read_zip_to_grid's body in three timed stages: parse (inflate and
    parse every entry), scan (pixel arrays, the histogram and range scan,
    the stack) and grid (normalize and build the brick grid). It leaves out
    read_zip_series' checks of the archive (not empty, one folder), which
    the Renderer's ingest runs. Returns the series, the grid and the
    stages' seconds."""
    from volxel_tpu_torch.ingest import series as series_mod
    from volxel_tpu_torch.ingest import ziploader
    from volxel_tpu_torch.ingest.dicom import parse_dicom
    from volxel_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer(log=False)
    with timer.stage("parse"):
        with ziploader._open_zip(data) as zf:
            files = [parse_dicom(ziploader._read_entry(zf, i)) for i in zf.infolist() if not i.is_dir()]
    with timer.stage("scan"):
        series = series_mod._fold_slices(files)
    del files
    with timer.stage("grid"):
        grid = series_mod.series_to_grid(series)
    return series, grid, timer.report()


def ingest_and_reference_benchmark(size: int, env_size: tuple, width: int, height: int, spec_path: Path,
                                   device="cuda") -> None:
    """Phase 2b: from DICOM bytes to the reference's benchmark records
    through the port's entry points, with every launch counter at 0 just
    before Renderer.from_attributes and read just after; then every kernel
    of that path held against its plain version on its inputs."""
    import os

    import torch

    from volxel_tpu_torch import Renderer, kernels
    from volxel_tpu_torch.api import benchmark
    from volxel_tpu_torch.grid import grid_differences
    from volxel_tpu_torch.grid.brick import construct_brick_grid
    from volxel_tpu_torch.ingest.hdr import decode_env_bytes
    from volxel_tpu_torch.native import loader
    from volxel_tpu_torch.render.rays import luma
    from volxel_tpu_torch.scene.environment import IMP_DIM, resize_linear
    from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume, synthetic_env_hdr, write_dicom_zip
    from volxel_tpu_torch.utils.profiling import fence_device

    t_phase = time.perf_counter()
    log(f"host: {loader._cpu_model()}, {os.cpu_count()} logical CPUs")
    if not loader.native_available():
        raise SystemExit(f"the native ingest library did not build or load: {loader._load_error}")
    cuda = torch.device(device).type == "cuda"
    spec = json.loads(spec_path.read_text())
    with tempfile.TemporaryDirectory(prefix="volxel_ingest_") as tmpdir:
        tmp = Path(tmpdir)
        # 1. the DICOM zip, deflated as users' archives are
        t0 = time.perf_counter()
        vol = synthetic_ct_volume((size,) * 3, bits_stored=12, seed=0)
        zip_path = tmp / f"ct{size}.zip"
        zip_path.write_bytes(write_dicom_zip(vol, bits_stored=12))
        del vol
        log(f"ingest: wrote {zip_path.name} ({size} slices of {size}x{size}, 12-bit, deflated), "
            f"{zip_path.stat().st_size} bytes in {time.perf_counter() - t0:.3f} s (the fixture writer, not the port)")

        # 2. the ingest on the native path, staged; the grid again on numpy
        series, grid, stages = staged_ingest(zip_path.read_bytes())
        grad, gmin, gmax = series.histogram_gradient()
        t0 = time.perf_counter()
        plain = construct_brick_grid(series.normalized(), transform=series.transform, min_maj=(0.0, 1.0),
                                     histogram=series.histogram, histogram_gradient=grad,
                                     histogram_gradient_range=(gmin, gmax), use_native=False)
        numpy_s = time.perf_counter() - t0
        differ = grid_differences(grid, plain)
        log(f"ingest ({size}^3, native): parse {stages['parse']:.3f} s, scan {stages['scan']:.3f} s, grid "
            f"{stages['grid']:.3f} s, total {sum(stages.values()):.3f} s; the grid on numpy {numpy_s:.3f} s; "
            f"{grid.brick_counter} bricks in the atlas; native and numpy grids "
            f"{'bit-equal' if not differ else 'differ in ' + ', '.join(differ)}")
        if differ:
            raise SystemExit(f"the native and numpy brick grids differ in {differ}")
        del series, grid, plain

        # 3. the environment, decoded on the host and built on the device
        env_path = tmp / "sky.hdr"
        env_path.write_bytes(synthetic_env_hdr(*env_size))
        env_bytes = env_path.read_bytes()
        t0 = time.perf_counter()
        image = decode_env_bytes(env_bytes)
        decode_s = time.perf_counter() - t0
        r = Renderer(width, height, device=device)
        fence_device(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated() if cuda else 0
        before = kernels.LAUNCHES["importance_pyramid"]
        t0 = time.perf_counter()
        r.load_env(env_bytes)
        fence_device(device)
        load_s = time.perf_counter() - t0
        k3 = kernels.LAUNCHES["importance_pyramid"] - before
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**20 if cuda else float("nan")
        lum = luma(r.environment.state.envmap)
        resize_ms = []
        for _ in range(RESIZE_REPS):
            fence_device(device)
            t0 = time.perf_counter()
            resize_linear(lum, IMP_DIM, IMP_DIM)
            fence_device(device)
            resize_ms.append((time.perf_counter() - t0) * 1000)
        log(f"load_env ({env_size[0]}x{env_size[1]} HDR, {len(env_bytes)} bytes): {load_s:.4f} s fenced, of which "
            f"the host decode alone takes {decode_s:.4f} s; importance-pyramid launches {k3}; peak device memory "
            f"above the renderer's {peak:.1f} MiB; resize_linear to {IMP_DIM}^2 alone "
            f"{', '.join(f'{ms:.3f}' for ms in resize_ms)} ms")
        if image.shape[:2] != (env_size[1], env_size[0]) or (cuda and k3 != 1):
            raise SystemExit(f"load_env decoded {image.shape} and launched the pyramid {k3} times (want 1)")
        del r, image, lum
        if cuda:
            torch.cuda.empty_cache()

        # 4. the spec, through from_attributes; image() after each entry;
        # the first call of each loading step and of render_frame timed
        looks = []
        run_single = benchmark.run_single_benchmark

        def run_and_look(renderer, name=None, warmup=1):
            rec = run_single(renderer, name=name, warmup=warmup)
            img = renderer.image()
            looks.append((img.shape, bool(np.isfinite(img).all()), float(img.max()), float(img.mean())))
            return rec

        benchmark.run_single_benchmark = run_and_look
        try:
            with first_calls(Renderer, ("restart_from_zip", "restart_from_grid", "load_env", "render_frame")) as first:
                fence_device(device)
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                r = Renderer.from_attributes(width=width, height=height, zip_path=zip_path, env_path=env_path,
                                             benchmark_path=spec_path, device=device)
                fence_device(device)
                spec_s = time.perf_counter() - t0
                launches = dict(kernels.LAUNCHES)
        finally:
            benchmark.run_single_benchmark = run_single
    span = {name: end - start for name, (start, end) in first.items()}
    log(f"ZIP bytes to first frame in from_attributes: restart_from_zip {span['restart_from_zip']:.3f} s "
        f"(restart_from_grid {span['restart_from_grid']:.3f} s of it, the ingest the rest), load_env "
        f"{span['load_env']:.3f} s, first frame {span['render_frame']:.3f} s; "
        f"{first['render_frame'][1] - first['restart_from_zip'][0]:.3f} s from the ZIP's bytes to the first frame's end")
    records = r.last_benchmark
    log(f"reference spec ({spec_path.name}): from_attributes {spec_s:.3f} s; launches {launches}")
    log(f"reference spec device: {json.dumps(records[0]['device'])}")
    for rec, (shape, finite, peak_value, mean) in zip(records, looks):
        log("reference spec record: " + json.dumps(
            {"name": rec["name"], "mode": rec["settings"]["renderMode"], "viewport": rec["viewport"],
             "samples": rec["settings"]["maxSamples"], "bounces": rec["settings"]["bounces"],
             "timePerSample": rec["timePerSample"], "totalTime": rec["totalTime"], "image_mean": mean}))
    if len(records) != len(spec["benchmarks"]) or len(looks) != len(records):
        raise SystemExit(f"{len(records)} records and {len(looks)} images for {len(spec['benchmarks'])} entries")
    for rec, entry, (shape, finite, peak_value, mean) in zip(records, spec["benchmarks"], looks):
        tps = rec["timePerSample"]
        w, h = rec["viewport"][2:]
        if rec["settings"]["renderMode"] != entry["renderMode"] or not (np.isfinite(tps) and tps > 0):
            raise SystemExit(f"record {rec['settings']['renderMode']}: timePerSample {tps}")
        if shape != (h, w, 3) or not finite or not peak_value > 0.0:
            raise SystemExit(f"image() after the {entry['renderMode']} entry: shape {shape}, finite {finite}, "
                             f"max {peak_value}")
    if cuda:
        acc = records[0]["device"]["accelerator"]
        if acc["platform"] != "gpu" or not records[0]["device"].get("powerLimit"):
            raise SystemExit(f"the records' fingerprint lacks the card or its power limit: {records[0]['device']}")
        modes = {e["renderMode"] for e in spec["benchmarks"]}
        for name in sorted({k for m in modes for k in PATH_KERNELS[m]}):
            if launches[name] <= 0:
                raise SystemExit(f"kernel {name} was not launched on the reference spec's path")
        if launches["importance_pyramid"] != 2:  # the default environment, then load_env
            raise SystemExit(f"the importance pyramid launched {launches['importance_pyramid']} times (want 2)")
        hold_spec_kernels(r, spec)
    del r
    if cuda:
        torch.cuda.empty_cache()
    log(f"phase 2b (ingest and the reference benchmark): {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512, help="volume edge in voxels")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--parity-size", type=int, default=64)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import volxel_tpu_torch

    # the kernels must be built from this checkout's sources, not from a copy
    # of the package installed elsewhere
    if Path(volxel_tpu_torch.__file__).resolve().parent.parent != Path(__file__).resolve().parent:
        print(f"chip_smoke: volxel_tpu_torch comes from {volxel_tpu_torch.__file__}, not this checkout",
              file=sys.stderr)
        return 2
    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.grid import construct_brick_grid
    from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # phase 2: build
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.lib()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s: {path.name}")
    sass, sass_bodies, registers = check_sass()

    t0 = time.perf_counter()
    vol = synthetic_ct_volume((args.size,) * 3, bits_stored=12, seed=0)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    del vol
    log(f"scene: {args.size}^3 synthetic CT volume, brick grid built in {time.perf_counter() - t0:.2f} s")

    # phase 2b: ingest and the reference benchmark, through the entry points
    ingest_and_reference_benchmark(args.size, ENV_SIZE, args.width, args.height, REFERENCE_SPEC)
    torch.cuda.empty_cache()

    # phase 3: each kernel against its plain version at the main paths' shapes
    r = bench_renderer(grid, args.width, args.height, "cuda")
    check_neg_log1m()
    results = [*check_legs(r, sass_bodies["dda_leg.cu"], registers["dda_leg.cu"]), *check_track_legs(r, sass_bodies["track_leg.cu"], registers["track_leg.cu"]),
               *check_gather(r), check_pyramid(r), check_tonemap(r.settings.exposure, r.settings.gamma, sass),
               check_shearwarp(r)]
    del r
    r = bench_renderer(grid, args.width, args.height, "cuda", "raymarch")
    results += check_tile_march(r, sass_bodies["tile_march.cu"], registers["tile_march.cu"])
    del r
    torch.cuda.empty_cache()

    # phase 4: the main paths, each with the counters at 0 before it
    launches = {}
    for mode in MODE_LEGS:
        launches[mode] = main_path(grid, args.width, args.height, mode)
        torch.cuda.empty_cache()
    for mode in MODE_LEGS:
        breakdown(grid, args.width, args.height, mode)
    breakdown(grid, args.width, args.height, "default", bounces=3)
    launches["preview"] = preview_path(grid, args.width, args.height)
    for e in results:
        e["launches"] = launches[KERNEL_PATH[e["name"]]][e["name"]]
    torch.cuda.empty_cache()

    # phase 5: card against CPU at a small size, in every mode and the preview
    for mode in ("default", "raymarch", "no_dda"):
        parity(grid, args.parity_size, mode)
    preview_parity(grid, args.parity_size)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in results]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
