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
2c. the app path, on the zip and the map of phase 2b: with every launch
   counter at 0 before it, Renderer.from_attributes at 960x540 (`serve`'s
   default size) in bench.py's framing, then the preview server on an
   ephemeral port, driven over HTTP: GET /, /frame.png (decoded here: its
   size, not black), /state, /histogram (timed), /transfer; rotate
   commands until drag previews are served (the ms from each command to
   its first preview, the K7 and K4 launches over the drags); POST
   /settings with gradient_shading, debug_hits and warmup_low_res, each
   followed by a served frame; render_mode raymarch and no_dda, each
   followed by a served frame; POST /benchmark of 16 samples and
   /benchmark_result (the card's name and power limit); frames served a
   second in each mode, the PNG encode's ms and the first fallback
   histogram (the dense field to the host); the server stops, and every
   kernel of the path must have launched. On the server's renderer
   (960x540, bounces 3, the zip's grid and the map), after the counts are
   read: one frame in each mode with each kernel held at every call of its
   three bounces, one warm-up frame (the legs at 0.33 of the size, K4 on
   its image()) and one drag preview (K7, within 1e-6 where only expf and
   ATen's exp can round apart, and K4). Then through the Renderer at
   1920x1080: gradient-shaded samples in each mode, timed and one
   profiled, and one more with each of its kernels held bit for bit at
   every call; a debug-hits sample, timed and profiled (no leg, no LUT
   fetch; one K4 at image()). Then
   `python -m volxel_tpu_torch render --synthetic 256 --size 512x512
   --samples 16` and `info` in subprocesses, the PNG decoded here;
2d. the mesh (parallel/), on the bench scene at the main paths' size: with
   every launch counter at 0 before it, a DistributedRenderer on a 2x2
   mesh whose four positions name the card, 3 steps (6 samples) in each
   mode, each step timed beside four single samples, the framebuffer
   bit-equal to the same steps replayed over single-position
   render_sample calls, each leg four launches a step and the LUT fetch
   one a default step; then one more step a mode profiled (device kernels,
   busy ms, idle share) and one with every kernel held at every call
   (hold_frame_kernels); render_views of 4 views in one wavefront (timed
   and profiled, its peak memory, each leg one launch, each view bit-equal
   to render_sample at frame * 4 + view; then one more call with every
   kernel held at every call, at its 4 x 1080p lanes); two processes on the
   card joined over gloo with sp = 2 spanning them (a first step equal to
   the mean of samples 0 and 1 in each, process_info reporting 2
   processes, the steps and the all_gather of a process's block timed), and NCCL in a
   process group of one (its all_gather of a frame buffer); step_statistics in the default and no_dda
   modes (the percentiles, the seconds, each leg one launch, then every
   kernel it launched held bit-equal, budgets and events included);
   PreviewServer over a 2x2 DistributedRenderer at 960x540, stepped
   (frames, the server's benchmark counting sp samples a step, a drag
   preview through K7), then on its renderer one frame with every kernel
   held and one drag preview with K7 and K4 held;
   `python -m volxel_tpu_torch serve --synthetic 64 --mesh 1,1,1` in a
   subprocess (/state, /frame.png); sp = 2 over cuda:0 and cuda:1 where
   the machine has two cards, else one line saying it was skipped;
2e. render-time volume slabs (parallel/volshard.py), on the bench scene at
   the main paths' size: with every launch counter at 0 before it, a
   DistributedRenderer whose (1, 1, 4) positions name the card, loaded by
   restart_from_grid from the brick grid (the load's seconds, each slab's
   bytes, and the load's peak above what it keeps, which must stay below
   the whole field's bytes), beside a vz = 1 renderer on the card; 2 steps
   in each mode, each timed beside the vz = 1 step (one sample), the
   framebuffer bit-equal to vz = 1's, each leg launched only in its slab
   form, 4 times a bounce; then, after the counts are read, 2 held steps
   of each renderer in turns with every kernel held bit for bit at every
   call (the legs' slab and dense forms' ms at one step's calls); two
   gradient-shaded default steps timed in turns with vz = 1's and
   bit-equal to them; one (sp=2, px=1,
   vz=2) step bit-equal to an sp = 2 one; vz = 2 over cuda:0 and cuda:1
   where the machine has two cards, else one line saying it was skipped;
   `python -m volxel_tpu_torch serve --synthetic 64 --mesh 1,1,2 --device
   cuda:0` in a subprocess (/state, /frame.png);
   then phase 2's registers and SASS of the legs' dense forms, which must
   be the parent commit's (DENSE_LEG_SASS). The slab forms' entries join
   the JSON line (launches from this phase);
2f. a vz row across the processes of a node (parallel/nodeshare.py), on
   the bench scene at the main paths' size: two processes on the card
   joined over gloo (`chip_smoke.py --node-worker ADDR PID DEVICES`), a
   (1, 1, 2) mesh with one position each, loaded by restart_from_grid:
   each process decodes its own slab and maps the other's through CUDA
   IPC (its device bytes after the load and the load's peak, which must
   stay below the whole field's); in each mode, with the counters at 0
   before them, 2 steps, each leg launched only in its slab form, rank
   0's framebuffer bit-equal to a one-process vz = 1 renderer's; 2 rounds
   of a step across the processes timed in turns with one-process vz = 2
   and vz = 1 steps, still bit-equal; one step with each leg held bit for
   bit against its plain version on every 16th lane of each call through
   the table that holds the mapped slab, and each leg's first call timed
   beside the one-process vz = 2 mesh's at the same lanes, in turns; then
   2 timestep swaps (each process cuts its slab from a whole field) with
   no host sync of the caller's, bit-equal to vz = 1, each swap freeing
   the slab it replaced, and close(); again with the processes on cuda:0
   and cuda:1, joined over NCCL, where the machine has two cards;
2g. a vz row across nodes (parallel/migrate.py), rehearsed on the one
   machine: two processes on the card over gloo (`chip_smoke.py
   --cross-worker ADDR PID DEVICES NODES`), fed the node identities A and
   B (printed beside the machine's own), a (1, 1, 2) row across them at
   the main paths' size: each holds its own slab, the other's is absent,
   and a lane that reaches it parks, moves to its owner and is resumed by
   the leg's park form. In each mode, with the counters at 0 before them,
   2 steps: each leg launched only in its park form, no slab mapped,
   rank 0's framebuffer bit-equal to a one-process vz = 1 renderer's, each
   leg call's lanes (running, parked, moved, returned), rounds and bytes
   printed; 2 steps timed in turns with vz = 1 (beside phase 2f's step);
   one step with each park form held bit for bit against its plain park
   form on every 16th lane of each call in both processes, and each park
   form's first call timed beside its plain version and, in rank 0, the
   slab form at the same lanes on every slab (in turns; the slab form's
   bytes give its bound); each process's device bytes after the load.
   Again over NCCL on cuda:0 and cuda:1 where the machine has two cards;
   then four processes fed [A, A, B, B] at 256^3 and 960x540 (slabs
   mapped within a node, lanes moved across), bit-equal to vz = 1, and
   again over NCCL on cuda:0-3 where the machine has four cards. The park
   forms' entries join the JSON line. `chip_smoke.py --cross-nodes-only`
   builds the kernels and runs this phase alone (its NCCL runs on a
   machine of four cards);
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
     default sample's premultiplied pyramid) and gather_f32, on no render
     path since the environment's kernels took its sites, at every call of
     the plain environment's warp and escape lookup over 1920x1080 lanes
     (bit-equal), gather_f32 beside torch.index_select on the same int32
     indices and torch.take on their int64 copy, the LUT fetch's mean call
     beside the launch floor (an empty kernel over the same grid);
   - the environment's warp sample and lookup (csrc/env.cu) over 1920x1080
     uniforms and directions, each form bit-equal to the plain version at
     every lane in one launch, beside it, with its bytes floor;
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
   - the per-ray RNG's seeding of every 1920x1080 pixel and a masked
     rng2_where on its words (bit-equal, words and floats at every lane),
     each beside its plain int64 version;
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
   modes, and that the RNG is seeded in one launch a sample; print every
   kernel's launches per sample; in the three modes
   split one sample into its camera and shadow legs (their ms, launches
   and host syncs, which must be 0) and profile one (device kernels,
   torch.nonzero calls), and the default mode once more at bounces 3; then
   the shear-warp preview: render_preview() at six
   camera poses that use all six (principal axis, flip) volumes, each
   called 1 + 3 times, and render_dvr(screen=True) once, with the counters
   at 0 before it;
5. render the same scene at 64x64 on the card and on the CPU (plain
   versions) in each of the three modes, plain and with gradient shading,
   and hold the images to the parity contract of
   tests/test_parity_oracle.py; debug hits in each mode and the preview at
   three poses are held to max abs err 1e-5.

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
import os
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
                  "gather_f32": "gather_f32_kernel", "lookup_transfer": "lookup_transfer_kernel",
                  "rng_seed": "rng_seed_kernel", "rng_draw": "rng_draw_kernel",
                  "env_sample": "env_sample_kernel", "env_lookup": "env_lookup_kernel",
                  **{f"{leg}{form}": f"{leg}{kernel}_kernel"
                     for leg in ("dda_leg_sample", "dda_leg_shadow", "track_leg_sample", "track_leg_shadow",
                                 "tile_march_sample", "tile_march_transmittance")
                     for form, kernel in (("_slabs", "_slabs"), ("_slabs_park", "_park"))}}

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
# integer instructions of the RNG (csrc/rng.cu) as SASS fuses them (an IMAD
# for (v << 4) + c, a LOP3 for the three-way xor, the round's sum folded
# into an immediate): 12 a TEA round, 8 a Wang hash; a xoshiro128++ step
# with its float 12, the mask's select 4
OPS_RNG_SEED = 32 * 12 + 4 * 8 + 2
OPS_RNG_DRAW = 12
OPS_RNG_SELECT = 4
# f32 operations of the environment's kernels (csrc/env.cu) as the source
# writes them, a division or a math function counted one: ~14 a level of the
# warp's nine, its direction, tap and pdf ~44; a lookup's (u, v), tap and pdf
OPS_ENV_SAMPLE = 9 * 14 + 44
OPS_ENV_LOOKUP = 40


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_renderer(grid, width: int, height: int, device, mode: str = "default", bounces: int = 1):
    from volxel_tpu_torch import Renderer

    r = Renderer(width, height, device=device)
    r.restart_from_grid(grid)
    r.render_mode = mode
    r.settings.bounces = bounces
    bench_look(r)
    return r


def bench_look(r) -> None:
    """bench.py's framing, transfer and sample range on a loaded renderer."""
    r.camera.rotate_around_view(0.6, 0.4)
    r.camera.zoom(2.0)
    r.set_transfer_colors(BENCH_TRANSFER)
    r.settings.sample_range = list(BENCH_SAMPLE_RANGE)
    r.restart_rendering()


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
    run that reaches the window's end takes trailing pads with it), that
    is, at least one leading pad, so that the lost run ended before `fn`;
    otherwise `fn` is profiled again, at most PROFILE_ATTEMPTS times, each
    time behind twice the leading pads (a window has lost exactly its 32
    leading pads five times in a row)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.render.gather import launch_floor

    cuda = torch.device("cuda")
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        before = dict(kernels.LAUNCHES)
        lead = PROFILE_PAD << (attempt - 1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
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
            lost[PAD_KERNEL] = lead + PROFILE_PAD - pads
        if not lost:
            if pads < lead + PROFILE_PAD:
                log(f"profiler window {attempt}: kept, {lead + PROFILE_PAD - pads} of its {lead + PROFILE_PAD} pads "
                    "lost")
            return prof
        log(f"profiler window {attempt} of {PROFILE_ATTEMPTS} lost device records (launches not recorded: {lost}; "
            f"pads recorded {pads} of {lead + PROFILE_PAD})")
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
                   mutable=(), atol: float = 0.0):
    """Replace module.<name>, for the block's duration, by a stand-in that
    sends each call's inputs through the kernel and the plain version
    (and `library_fn`, when given), raises unless they agree bit for bit
    on every output (or, with `atol`, within it), and returns the kernel's
    result. A function that
    updates the operands at the indices in `mutable` in place gets fresh
    copies of them at every timed call, and the kernel's updates are then
    copied into the caller's operands. `others` maps a name to a function
    of the call's inputs that prepares (untimed) one more call to time
    beside them. Yields the tally: calls, lanes (`lanes(args)`), the times
    summed over the calls, the bytes and operations of the work
    (`work(args, outputs)`), the largest difference, whether every call
    was bit-equal, and the first call's arguments."""
    others = others or {}
    tally = {"calls": 0, "lanes": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "ops": 0,
             "err": 0.0, "equal": True, "first_args": None, "others": dict.fromkeys(others, 0.0)}

    def compared(*args):
        kernel_call, copies = fresh_calls(cuda_fn, args, mutable, 2 * KERNEL_REPS)
        got, ms = device_ms(kernel_call, KERNEL_REPS)
        plain_call, _ = fresh_calls(plain_fn, args, mutable, 2)
        want, plain_ms = device_ms(plain_call)
        single = not isinstance(got, tuple)
        got_t, want_t = ((got,), (want,)) if single else (got, want)
        bad = [nm for nm, a, b in zip(outputs, got_t, want_t) if not bits_equal(a, b)]
        err = max_abs(got_t, want_t)
        if bad and not err <= atol:
            raise SystemExit(f"{name} call {tally['calls']}: kernel differs from its plain version "
                             f"in {bad} (max abs {err})")
        tally["equal"] = tally["equal"] and not bad
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
# code must hold no FFMA (the leg kernels, dense, slab and park forms) with
# how many there are
SASS_CHECKS = {"dda_leg.cu": (r"dda_leg_(sample|shadow)(_slabs|_park)?_kernel", 15),
               "track_leg.cu": (r"track_leg_(sample|shadow)(_slabs|_park)?_kernel", 10), "tonemap.cu": (None, 0),
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
    way; gather_f32, which no render path calls since csrc/env.cu took the
    environment's sites, at every call of the plain environment's warp
    sample and escape lookup over 1920x1080 seeded lanes (the bilinear taps
    and the importance texels), beside torch.index_select on the same int32
    indices and torch.take on their int64 copy."""
    import torch

    from volxel_tpu_torch.render import gather
    from volxel_tpu_torch.render.pathtrace import render_sample
    from volxel_tpu_torch.scene import environment as env_mod

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
    rng = np.random.default_rng(2)
    d = rng.normal(size=(1920 * 1080, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dirs = torch.from_numpy(d).cuda()
    rnd2 = torch.from_numpy(rng.random((1920 * 1080, 2), dtype=np.float32)).cuda()
    state = r.environment.state
    with compared_calls(gather, "gather_f32", gather_cuda, gather.gather_f32_plain, ("values",),
                        lambda a: a[1].numel(), gather_work, library_fn=index_select, others=take) as sel:
        le, _, _ = env_mod.sample_environment_plain(state, rnd2)
        le_esc, _ = env_mod.lookup_environment_pdf_plain(state, dirs)
    finite = bool(torch.isfinite(le).all()) and bool(torch.isfinite(le_esc).all())
    if not (sel["calls"] == 3 and finite):
        raise SystemExit(f"the plain environment: {sel['calls']} gather calls (want 3), finite {finite}")
    log(f"gather_f32: bit-equal at the plain environment's {sel['calls']} calls of a warp sample and an escape "
        f"lookup over {dirs.shape[0]} lanes ({sel['lanes']} words); kernel {sel['ms']:.4f} ms, plain "
        f"{sel['plain_ms']:.4f} ms, torch.index_select (int32) {sel['library_ms']:.4f} ms, torch.take (int64) "
        f"{sel['others']['torch.take (int64)']:.4f} ms, bound {bound(sel['bytes'], sel['ops'])['bound_ms']:.4f} ms")
    source, replaces = "volxel_tpu_torch/csrc/gather.cu", "volxel_tpu/render/mxu_gather.py:196"
    return [entry("lookup_transfer", source, replaces, lut["err"], lut["ms"], lut["plain_ms"], lut["bytes"],
                  lut["ops"]),
            entry("gather_f32", source, replaces, sel["err"], sel["ms"], sel["plain_ms"], sel["bytes"],
                  sel["ops"], library_ms=sel["library_ms"])]


def check_rng(width: int, height: int) -> list[dict]:
    """The per-ray RNG's two kernels (csrc/rng.cu) at width x height, bit
    for bit against the plain int64 version on the card: the seeding of
    every pixel at a frame past 2^31, then a masked rng2_where on its
    words (about 70% of the lanes drawing), words and floats at every
    lane, masked-out lanes included. Each timed beside its plain version,
    with its bound (bytes: indices, words, mask and floats, each read or
    written once; its integer instructions, OPS_RNG_*, over the f32 rate
    are less)."""
    import torch

    from volxel_tpu_torch.render import rng

    cuda = torch.device("cuda")
    pix = torch.arange(width * height, dtype=torch.int64, device=cuda)
    frame = 2**31 + 5
    state = rng.seed_rays_cuda(pix, frame)
    if not bits_equal(state, rng.seed_rays_plain(pix, frame)):
        raise SystemExit("rng_seed: the words differ from the plain version's")
    mask = torch.rand(pix.shape, generator=torch.Generator(cuda).manual_seed(3), device=cuda) < 0.7
    got, want = rng.draw_cuda(state, 2, mask), rng.draw_plain(state, 2, mask)
    if not all(bits_equal(a, b) for a, b in zip(got, want)):
        raise SystemExit("rng_draw: a masked rng2_where differs from the plain version's")
    n = pix.numel()
    work = {"rng_seed": (lambda: rng.seed_rays_cuda(pix, frame), lambda: rng.seed_rays_plain(pix, frame),
                         nbytes(pix, state), n * OPS_RNG_SEED),
            "rng_draw": (lambda: rng.draw_cuda(state, 2, mask), lambda: rng.draw_plain(state, 2, mask),
                         nbytes(state, mask, *got), n * (2 * OPS_RNG_DRAW + OPS_RNG_SELECT))}
    entries = []
    for name, (cuda_fn, plain_fn, moved, ops) in work.items():
        _, ms = device_ms(cuda_fn, 50)
        _, plain_ms = device_ms(plain_fn, 5)
        e = entry(name, "volxel_tpu_torch/csrc/rng.cu", "volxel_tpu/render/rng.py (plain jnp)", 0.0, ms, plain_ms,
                  moved, ops)
        log(f"{name}: bit-equal at all {n} lanes of {width}x{height}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
            f"bound {e['bound_ms']:.4f} ms by {e['bound_by']} ({moved / 1e6:.1f} MB, {ops / 1e9:.3f} G integer ops; "
            f"the kernel at {e['bound_ms'] / ms:.1%})")
        entries.append(e)
    return entries


def check_env(r, width: int, height: int) -> list[dict]:
    """The environment's two kernels (csrc/env.cu) on `r`'s map at width x
    height lanes, bit for bit against the plain version on the card, one
    launch a call: the warp sample with each pdf over seeded uniforms (0,
    0.5 and 1 - ulp among them), and the lookup with each pdf, alone and
    the pdf alone over seeded directions (the poles among them). Each form
    timed beside its plain version; each kernel's entry is its main-path
    form (the reference's pdf; the escape's lookup with it), with its bytes
    floor (each lane's inputs read and outputs written once, the map and
    the pyramid read once; its f32 operations, OPS_ENV_*, over the f32 rate
    are less)."""
    import torch

    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.scene import environment as env_mod

    cuda = torch.device("cuda")
    n = width * height
    g = torch.Generator(cuda).manual_seed(5)
    rnd2 = torch.rand((n, 2), generator=g, device=cuda)
    rnd2[:3] = torch.tensor([[0.0, 0.0], [0.5, 0.5], [1.0 - 2.0**-24] * 2], device=cuda)
    d = torch.randn((n, 3), generator=g, device=cuda)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    d[:2] = torch.tensor([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]], device=cuda)
    state = r.environment.state
    tables = nbytes(state.envmap, *state.imp_mips)
    forms = {"env_sample": [(f"physical {p}", env_mod.sample_environment_cuda, env_mod.sample_environment_plain,
                             (state, rnd2, p), OPS_ENV_SAMPLE) for p in (False, True)],
             "env_lookup": [(f"lookup and pdf, physical {p}", env_mod.lookup_environment_pdf_cuda,
                             env_mod.lookup_environment_pdf_plain, (state, d, p), OPS_ENV_LOOKUP) for p in (False, True)]
             + [("lookup", env_mod.lookup_environment_cuda, env_mod.lookup_environment_plain, (state, d),
                 OPS_ENV_LOOKUP)]
             + [(f"pdf, physical {p}", env_mod.pdf_environment_cuda, env_mod.pdf_environment_plain, (state, d, p),
                 OPS_ENV_LOOKUP) for p in (False, True)]}
    entries = []
    for name, calls in forms.items():
        for i, (label, cuda_fn, plain_fn, args, ops) in enumerate(calls):
            before = kernels.LAUNCHES[name]
            got = cuda_fn(*args)
            launches = kernels.LAUNCHES[name] - before
            want = plain_fn(*args)
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            if launches != 1 or not all(bits_equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"{name} ({label}): {launches} launches, max abs {max_abs(got, want)} from the "
                                 "plain version")
            _, ms = device_ms(lambda: cuda_fn(*args), 50)
            _, plain_ms = device_ms(lambda: plain_fn(*args), 5)
            moved = nbytes(args[1], *got) + tables
            e = entry(name, "volxel_tpu_torch/csrc/env.cu", "volxel_tpu_torch/scene/environment.py (plain ATen ops; "
                      "the Pallas kernel volxel_tpu/render/mxu_gather.py:196 at its taps)", 0.0, ms, plain_ms, moved,
                      n * ops)
            log(f"{name} ({label}): bit-equal at all {n} lanes of {width}x{height} in one launch; kernel {ms:.4f} "
                f"ms, plain {plain_ms:.4f} ms; bound {e['bound_ms']:.4f} ms by {e['bound_by']} ({moved / 1e6:.1f} "
                f"MB; the kernel at {e['bound_ms'] / ms:.1%})")
            if i == 0:
                entries.append(e)
    return entries


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
    "default": ("dda_leg_sample", "dda_leg_shadow", "lookup_transfer", "env_sample", "env_lookup",
                "importance_pyramid", "tonemap", "rng_seed", "rng_draw"),
    "raymarch": ("tile_march_sample", "tile_march_transmittance", "env_sample", "env_lookup", "importance_pyramid",
                 "tonemap", "rng_seed", "rng_draw"),
    "no_dda": ("track_leg_sample", "track_leg_shadow", "env_sample", "env_lookup", "importance_pyramid", "tonemap",
               "rng_seed", "rng_draw"),
    "preview": ("shearwarp_intermediate", "tonemap"),
}
# each mode's two legs, each one launch per bounce
MODE_LEGS = {"default": ("dda_leg_sample", "dda_leg_shadow"),
             "raymarch": ("tile_march_sample", "tile_march_transmittance"),
             "no_dda": ("track_leg_sample", "track_leg_shadow")}
# the path whose run gives each kernel's launch count (K6 and gather_f32
# lie on none: their counts from the raymarch and default runs are 0)
KERNEL_PATH = {"dda_leg_sample": "default", "dda_leg_shadow": "default", "track_leg_sample": "no_dda",
               "track_leg_shadow": "no_dda", "lookup_transfer": "default", "gather_f32": "default", "importance_pyramid": "default",
               "tonemap": "default", "tile_march_sample": "raymarch", "tile_march_transmittance": "raymarch",
               "tile_march_sums": "raymarch", "shearwarp_intermediate": "preview", "rng_seed": "default",
               "rng_draw": "default", "env_sample": "default", "env_lookup": "default"}


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
    # the RNG seeds every pixel once a sample, in one launch
    if per_sample["rng_seed"] != 1:
        raise SystemExit(f"the RNG was seeded {per_sample['rng_seed']} times per {mode} sample")
    # the environment's warp and escape lookup, one launch each a bounce
    env = (per_sample["env_sample"], per_sample["env_lookup"], per_sample["gather_f32"])
    if env != (r.settings.bounces, r.settings.bounces, 0):
        raise SystemExit(f"the environment launched (env_sample, env_lookup, gather_f32) {env} times per {mode} "
                         f"sample at bounces {r.settings.bounces}")
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
            log(f"profile of one launch of shearwarp_intermediate_cuda between at least {PROFILE_PAD} launches of the "
                "empty kernel before it and {PROFILE_PAD} after it, every key (type, count, host ms, device ms): "
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


def parity(grid, size: int, mode: str, setting: str | None = None) -> None:
    """The same scene on the card and on the CPU, held to the slice
    contract; with `setting` ("gradient_shading" or "debug_hits") turned
    on. Debug hits, which draw nothing, are held to max abs err
    DEBUG_HITS_ATOL instead."""
    what = mode if setting is None else f"{mode}, {setting}"
    images = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        r = bench_renderer(grid, size, size, device, mode)
        if setting is not None:
            setattr(r.settings, setting, True)
        for _ in range(PARITY_FRAMES):
            r.render_frame()
        images[device] = r._framebuffer.cpu().numpy().astype(np.float64)
        log(f"parity render ({what}) on {device}: {time.perf_counter() - t0:.2f} s")
    gpu, cpu = images["cuda"], images["cpu"]
    if setting == "debug_hits":
        err = float(np.abs(gpu - cpu).max())
        log(f"parity {size}x{size} ({what}): max abs err {err:.3e}, means {gpu.mean():.6f} (card) "
            f"{cpu.mean():.6f} (cpu)")
        if not (err <= DEBUG_HITS_ATOL and cpu.mean() > 0):
            raise SystemExit(f"card and CPU debug-hits renders ({mode}) differ by {err} > {DEBUG_HITS_ATOL}")
        return
    rel = np.abs(gpu - cpu) / (np.abs(cpu) + 1e-3)
    tight = float((rel.max(axis=-1) < 1e-3).mean())
    median = float(np.median(rel))
    means = (float(gpu.mean()), float(cpu.mean()))
    log(f"parity {size}x{size} ({what}): {tight:.4%} of pixels within 0.1%, median rel {median:.3e}, "
        f"means {means[0]:.6f} (card) {means[1]:.6f} (cpu)")
    if not (tight > 0.98 and median < 1e-4 and abs(means[0] - means[1]) < 5e-3 * max(means[1], 1e-3)):
        raise SystemExit(f"card and CPU renders ({what}) disagree beyond the parity contract")


# phase 2b: the reference's own benchmark spec (three entries, one per
# mode, at bounces 1, resolutionFactor 0.8 and 500 samples) on a DICOM zip
# and an HDR environment that the fixture writers make here
REFERENCE_SPEC = Path(__file__).resolve().parent / "tests" / "fixtures" / "reference_benchmark.json"
ENV_SIZE = (2048, 1024)
RESIZE_REPS = 3


# phase 2b's comparisons: for each render mode, the kernels one sample
# launches, each as (module whose attribute the sample calls, that name,
# the CUDA entry, the plain version, the outputs held bit for bit); a
# gradient-shaded sample (`shaded`) makes one environment lookup, and no
# warp sample or escape
def spec_sample_kernels(mode: str, shaded: bool = False) -> list:
    import volxel_tpu_torch.render.modes as modes
    import volxel_tpu_torch.scene.environment as env_mod
    from volxel_tpu_torch.render import ddaleg, gather, tilemarch, trackleg

    def lut_cuda(lut, sample_range, density):
        return gather.lookup_transfer_cuda(lut.contiguous(), sample_range.contiguous(), density.contiguous())

    if shaded:
        taps = (env_mod, "lookup_environment_cuda", env_mod.lookup_environment_cuda,
                env_mod.lookup_environment_plain, ("le",))
    else:
        taps = (env_mod, "sample_environment_cuda", env_mod.sample_environment_cuda,
                env_mod.sample_environment_plain, ("le", "pdf", "w_i"))
        escape = (env_mod, "lookup_environment_pdf_cuda", env_mod.lookup_environment_pdf_cuda,
                  env_mod.lookup_environment_pdf_plain, ("le", "pdf"))
    if mode == "default":
        checks = [(modes, "dda_leg_sample", ddaleg.dda_leg_sample_cuda, ddaleg.dda_leg_sample_plain,
                   ("state", "hit", "t", "rgb", "budget")),
                  (modes, "dda_leg_shadow", ddaleg.dda_leg_shadow_cuda, ddaleg.dda_leg_shadow_plain,
                   ("state", "tr", "budget")),
                  (gather, "lookup_transfer_fetch", lut_cuda, gather.lookup_transfer_plain, ("rgba",)), taps]
    elif mode == "no_dda":
        checks = [(modes, "track_leg_sample", trackleg.track_leg_sample_cuda, trackleg.track_leg_sample_plain,
                   ("state", "hit", "t", "rgb", "events")),
                  (modes, "track_leg_shadow", trackleg.track_leg_shadow_cuda, trackleg.track_leg_shadow_plain,
                   ("state", "tr", "events")), taps]
    else:
        checks = [(modes, "tile_march_sample", tilemarch.tile_march_sample_cuda, tilemarch.tile_march_sample_plain,
                   ("state", "hit", "t", "rgb")),
                  (modes, "tile_march_transmittance", tilemarch.tile_march_transmittance_cuda,
                   tilemarch.tile_march_transmittance_plain, ("state", "tau")), taps]
    return checks if shaded else checks + [escape]


def no_work(args, got):
    return 0, 0


def mask_lanes(args) -> int:
    """The lanes of a leg call, by its 1-D bool mask of running lanes (0
    for the table fetches, which take none)."""
    import torch

    return max((a.numel() for a in args if isinstance(a, torch.Tensor) and a.dtype == torch.bool and a.dim() == 1),
               default=0)


def held_sample_kernels(fn, mode: str, shaded: bool = False) -> tuple:
    """fn() with each kernel of a `mode` sample (spec_sample_kernels: the
    legs, the environment's warp sample and escape lookup, or a
    gradient-shaded sample's lookup, the default mode's LUT fetch) held bit
    for bit against its plain version at every call. Returns fn's result
    and [(name, tally)] in the order of the checks."""
    checks = spec_sample_kernels(mode, shaded)
    with contextlib.ExitStack() as stack:
        tallies = [stack.enter_context(compared_calls(module, name, cuda_fn, plain_fn, outputs, mask_lanes, no_work))
                   for module, name, cuda_fn, plain_fn, outputs in checks]
        out = fn()
    return out, [(name, tally) for (_, name, *_), tally in zip(checks, tallies)]


def hold_frame_kernels(r, what: str) -> None:
    """One render_frame() of `r` with each kernel of its mode's sample held
    bit for bit against its plain version at every call
    (held_sample_kernels), then K4 at image(); fails unless each was
    called. Launches made here are not the main path's."""
    import volxel_tpu_torch.render.pallas_ops as pallas_ops

    _, tallies = held_sample_kernels(r.render_frame, r.render_mode, r.settings.gradient_shading)
    with compared_calls(pallas_ops, "tonemap_cuda", pallas_ops.tonemap_cuda, pallas_ops.tonemap_plain,
                        ("image",), lambda a: 0, no_work) as tonemap:
        img = r.image()
    # a warm-up frame renders, and image() tonemaps, the low-res preview
    w, h = r._warmup_preview[:2] if r._warmup_preview is not None else r._render_dims()
    for name, tally in (*tallies, ("tonemap", tonemap)):
        if tally["calls"] == 0:
            raise SystemExit(f"{name} was not called in one {r.render_mode} sample of {what}")
        log(f"{what}, {r.render_mode} ({w}x{h}): {name} bit-equal at all {tally['calls']} calls "
            f"of one sample; kernel {tally['ms']:.4f} ms, plain {tally['plain_ms']:.4f} ms summed over them")
    if not np.isfinite(img).all():
        raise SystemExit(f"image() of the held {r.render_mode} sample of {what} is not finite")


def hold_spec_kernels(r, spec: dict) -> None:
    """Every kernel of the reference spec's path against its plain version
    on the spec's own inputs: the spec renderer's ingested grid and loaded
    map. For each entry, with its settings on `r`, one render_frame() (the
    first frame after the restart, which image() then shows alone) held at
    every call (hold_frame_kernels); K3 on the map's 512^2 importance base.
    Launches made here are not the main path's."""
    import volxel_tpu_torch.render.pallas_ops as pallas_ops
    from volxel_tpu_torch.api.benchmark import apply_entry_settings

    for entry in spec["benchmarks"]:
        apply_entry_settings(spec, entry, r)
        hold_frame_kernels(r, "reference spec")
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
    """read_zip_series and series_to_grid, the Renderer's ingest, in the
    three stages their spans time: parse (inflate and parse every entry),
    scan (pixel arrays, the histogram and range scan, the stack) and grid
    (normalize and build the brick grid). Returns the series, the grid and
    the stages' seconds."""
    from volxel_tpu_torch.ingest import series as series_mod
    from volxel_tpu_torch.ingest import ziploader
    from volxel_tpu_torch.utils import profiling

    profiling.take_spans()
    with profiling.spans():
        series = ziploader.read_zip_series(data)
        grid = series_mod.series_to_grid(series)
    stages = {name.removeprefix("vx::ingest."): (t1 - t0) / 1e9 for name, _, _, t0, t1 in profiling.take_spans()
              if name.startswith("vx::ingest.")}
    return series, grid, stages


def ingest_and_reference_benchmark(size: int, env_size: tuple, width: int, height: int, spec_path: Path, tmp: Path,
                                   device="cuda") -> tuple:
    """Phase 2b: from DICOM bytes to the reference's benchmark records
    through the port's entry points, with every launch counter at 0 just
    before Renderer.from_attributes and read just after; then every kernel
    of that path held against its plain version on its inputs. Writes the
    zip and the HDR map into `tmp` and returns their paths."""
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
    log(f"host: {loader._cpu_model()}; {host_probe()}")
    if not loader.native_available():
        raise SystemExit(f"the native ingest library did not build or load: {loader._load_error}")
    cuda = torch.device(device).type == "cuda"
    spec = json.loads(spec_path.read_text())
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
    return zip_path, env_path


# phase 2c: the app path. The preview server (`serve`'s default size) on
# the zip and the HDR map that phase 2b writes, driven over HTTP; gradient
# shading and debug hits through the Renderer at the main paths' size; the
# CLI in subprocesses
APP_SIZE = (960, 540)
APP_SETTINGS = ("gradient_shading", "debug_hits", "warmup_low_res")
APP_WAIT = 120.0  # the longest wait, in seconds, for a served frame or a result
FPS_SECONDS = 2.0  # the window in which each mode's served frames are counted
HOST_PROBE_ITERATIONS = 2_000_000
DRAGS = 3  # rotate commands, each followed by its first preview
SERVER_BENCH_SAMPLES = 16
GRADIENT_SAMPLES = 3  # timed gradient-shaded samples a mode, after one untimed
DEBUG_HITS_ATOL = 1e-5
CLI_RENDER = ("render", "--synthetic", "256", "--size", "512x512", "--samples", "16")
# every kernel the app path launches (K6 and gather_f32 lie on no render path)
APP_KERNELS = tuple(name for name in KERNEL_PATH if name not in ("tile_march_sums", "gather_f32"))


def http(base: str, path: str, body=None) -> tuple:
    """(status, content type, body) of a GET of `path`, or of a POST of
    `body` as JSON."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    request = urllib.request.Request(base + path, data=data, method="GET" if body is None else "POST")
    with urllib.request.urlopen(request, timeout=APP_WAIT) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def wait_until(fn, what: str):
    """fn()'s first truthy value, polled for at most APP_WAIT seconds."""
    deadline = time.monotonic() + APP_WAIT
    while time.monotonic() < deadline:
        value = fn()
        if value:
            return value
        time.sleep(0.005)
    raise SystemExit(f"app: no {what} within {APP_WAIT} s")


def next_served(served: list, since: float, preview: bool = False, **want) -> dict:
    """The first frame the server encoded after `since` (perf_counter
    seconds), a drag preview or a progressive frame, whose record holds
    `want`."""
    def find():
        return next((rec for rec in list(served) if rec["t"] > since and rec["preview"] == preview
                     and all(rec[k] == v for k, v in want.items())), None)

    return wait_until(find, f"{'preview' if preview else 'frame'} served with {want}")


def served_frame(base: str, width: int, height: int, what: str) -> np.ndarray:
    """GET /frame.png, decoded; fails unless it has the size and is not black."""
    from volxel_tpu_torch.utils.png import decode_png

    status, ctype, png = http(base, "/frame.png")
    img = decode_png(png)
    if status != 200 or ctype != "image/png" or img.shape != (height, width, 3) or not img.max() > 0:
        raise SystemExit(f"app: /frame.png after {what}: {status} {ctype}, {img.shape}, max {img.max()}")
    return img


def host_probe() -> str:
    """The host's speed and load as this process sees them: the ms of a
    fixed pure-Python loop (the kind of work that enqueues kernels) and
    the 1-minute load average against the logical CPUs."""
    t0 = time.perf_counter()
    total = 0
    for i in range(HOST_PROBE_ITERATIONS):
        total += i & 7
    ms = (time.perf_counter() - t0) * 1000
    return (f"a {HOST_PROBE_ITERATIONS:,}-iteration Python loop {ms:.1f} ms, load average "
            f"{os.getloadavg()[0]:.2f} on {os.cpu_count()} logical CPUs")


def hold_app_kernels(r, preview_scale: float) -> None:
    """Every kernel of the app path against its plain version on the
    server's renderer `r` at the shapes the server gave it: one frame in
    each mode (every call of every bounce, hold_frame_kernels), one
    default-mode warm-up frame (its legs at 0.33 of the size and K4 on its
    image()) and one drag preview at `preview_scale` (hold_drag_preview).
    Launches made here are not the main path's."""
    # default last: the server's warm-up frame was a default-mode one
    for mode in ("raymarch", "no_dda", "default"):
        r.render_mode = mode
        hold_frame_kernels(r, f"app path, bounces {r.settings.bounces}")
    r.settings.warmup_low_res = True
    r.restart_rendering()
    hold_frame_kernels(r, "app path warm-up")
    r.settings.warmup_low_res = False
    r.restart_rendering()
    hold_drag_preview(r, preview_scale, "app path")


def hold_drag_preview(r, preview_scale: float, what: str) -> None:
    """One drag preview of `r` at `preview_scale` with K7 held to its plain
    version (bit-equal, or within 1e-6 where only the card's expf and
    ATen's exp can round apart, as check_shearwarp holds it) and K4
    bit-equal; fails unless each was called. Launches made here are not
    the main path's."""
    import volxel_tpu_torch.render.pallas_ops as pallas_ops
    from volxel_tpu_torch.render import shearwarp

    with compared_calls(shearwarp, "shearwarp_intermediate_cuda", shearwarp.shearwarp_intermediate_cuda,
                        shearwarp.shearwarp_intermediate_plain, ("colour", "transmittance"), lambda a: 0, no_work,
                        atol=1e-6) as k7, \
            compared_calls(pallas_ops, "tonemap_cuda", pallas_ops.tonemap_cuda, pallas_ops.tonemap_plain,
                           ("image",), lambda a: 0, no_work) as k4:
        img = r.render_preview(scale=preview_scale)
    h, w = img.shape[:2]
    for name, tally in (("shearwarp_intermediate", k7), ("tonemap", k4)):
        if tally["calls"] == 0:
            raise SystemExit(f"{name} was not called in a {w}x{h} drag preview of the {what}")
        agree = "bit-equal" if tally["equal"] else f"within 1e-6 (max abs {tally['err']:.3e})"
        log(f"{what} drag preview ({w}x{h}): {name} {agree} at all {tally['calls']} calls; kernel "
            f"{tally['ms']:.4f} ms, plain {tally['plain_ms']:.4f} ms summed over them")
    check_image(img, w, h, f"the {what}'s held drag preview")


def frames_per_second(served: list, mode: str) -> float:
    """Progressive frames served in `mode` over the next FPS_SECONDS."""
    t0 = time.perf_counter()
    time.sleep(FPS_SECONDS)
    n = sum(1 for rec in list(served)
            if not rec["preview"] and rec["mode"] == mode and t0 < rec["t"] <= t0 + FPS_SECONDS)
    return n / FPS_SECONDS


def app_server(zip_path: Path, env_path: Path, device="cuda") -> dict:
    """The preview server on `device`, over HTTP on an ephemeral port, with
    every launch counter at 0 just before its renderer loads the zip and
    the map (Renderer.from_attributes, then bench.py's framing and transfer)
    and read after the server stopped: each route, drag previews, each of
    APP_SETTINGS, the raymarch and no_dda modes and the server's benchmark;
    frames a second in each mode, the PNG encode's ms, the ms from a rotate
    command to its preview, the first /histogram and the first fallback
    histogram (the dense field copied to the host). Returns the counts."""
    import torch

    from volxel_tpu_torch import Renderer, kernels
    from volxel_tpu_torch.api import server as server_mod
    from volxel_tpu_torch.utils.profiling import fence_device

    cuda = torch.device(device).type == "cuda"
    width, height = APP_SIZE
    log(f"app: host before the server: {host_probe()}")
    t_phase = time.perf_counter()
    fence_device(device)
    kernels.reset_launch_counts()
    r = Renderer.from_attributes(width=width, height=height, zip_path=zip_path, env_path=env_path, device=device)
    bench_look(r)
    fence_device(device)
    log(f"app: Renderer.from_attributes({width}x{height}, {zip_path.name}, {env_path.name}) and bench.py's look "
        f"{time.perf_counter() - t_phase:.3f} s")
    s = server_mod.PreviewServer(r, port=0)
    served, encode_ms = [], []
    encode_frame, encode_png = s._encode_frame, server_mod.encode_png

    def recorded(img=None):
        encode_frame(img)
        served.append({"t": time.perf_counter(), "preview": img is not None, "mode": r.render_mode,
                       "frame": r.frame_index, **{name: getattr(r.settings, name) for name in APP_SETTINGS}})

    def timed_png(rgb):
        t0 = time.perf_counter()
        png = encode_png(rgb)
        encode_ms.append(((time.perf_counter() - t0) * 1000, rgb.shape[:2], len(png)))
        return png

    s._encode_frame = recorded
    server_mod.encode_png = timed_png
    t_start = time.perf_counter()
    base = f"http://127.0.0.1:{s.start()}"
    try:
        status, ctype, page = http(base, "/")
        if status != 200 or ctype != "text/html" or b"</html>" not in page:
            raise SystemExit(f"app: GET / gave {status} {ctype}, {len(page)} bytes")
        first = next_served(served, t_start)
        img = served_frame(base, width, height, "the first frame")
        log(f"app: first frame served {first['t'] - t_start:.3f} s after start(); /frame.png {img.shape}, "
            f"mean {img.mean():.2f} of 255")
        state = json.loads(http(base, "/state")[2])
        if (state["width"], state["height"]) != APP_SIZE or state["samples"] <= 0 or state["error"] is not None:
            raise SystemExit(f"app: /state {state['width']}x{state['height']}, samples {state['samples']}, "
                             f"error {state['error']}")
        t0 = time.perf_counter()
        hist = json.loads(http(base, "/histogram")[2])
        hist_ms = (time.perf_counter() - t0) * 1000
        transfer = json.loads(http(base, "/transfer")[2])
        if not hist["bars"] or transfer["type"] != "color_stops" or len(transfer["colors"]) != len(BENCH_TRANSFER):
            raise SystemExit(f"app: /histogram {len(hist['bars'])} bars, /transfer {transfer}")
        t0 = time.perf_counter()
        fallback = s._fallback_histogram()
        fallback_ms = (time.perf_counter() - t0) * 1000
        log(f"app: /histogram (the ingest's histogram, {len(hist['bars'])} bars) {hist_ms:.1f} ms; the fallback "
            f"histogram's first call (the {'x'.join(map(str, r._device_grid.dense.shape))} bf16 field to the "
            f"host as f32, np.histogram) {fallback_ms:.1f} ms, {int(fallback[0].sum())} voxels")
        fps = {"default": frames_per_second(served, "default")}

        before = dict(kernels.LAUNCHES)
        t_drag, drag_ms = time.perf_counter(), []
        for _ in range(DRAGS):
            wait_until(lambda: time.time() > s._motion_until + 0.05, "end of the last drag's motion")
            t0 = time.perf_counter()
            http(base, "/input", {"type": "rotate", "by": [0.05, 0.02]})
            drag_ms.append((next_served(served, t0, preview=True)["t"] - t0) * 1000)
        wait_until(lambda: time.time() > s._motion_until + 0.05, "end of the last drag's motion")
        next_served(served, time.perf_counter())
        drag = {name: kernels.LAUNCHES[name] - before[name] for name in ("shearwarp_intermediate", "tonemap")}
        previews = sum(1 for rec in list(served) if rec["preview"] and rec["t"] > t_drag)
        log(f"app: {DRAGS} rotate commands: ms to the first preview {', '.join(f'{ms:.2f}' for ms in drag_ms)}; "
            f"{previews} previews at {r.width // 2}x{r.height // 2} served while the motion lasted; launches over "
            f"the drags {drag}")
        if cuda and not (drag["shearwarp_intermediate"] >= previews >= DRAGS and drag["tonemap"] >= previews):
            raise SystemExit(f"app: {previews} previews served with launches {drag}")

        for name in APP_SETTINGS:
            t0 = time.perf_counter()
            http(base, "/settings", {name: True})
            rec = next_served(served, t0, **{name: True})
            served_frame(base, width, height, f"{name} on")
            log(f"app: {name} on: frame {rec['frame']} served {(rec['t'] - t0) * 1000:.1f} ms after the POST")
            http(base, "/settings", {name: False})
        next_served(served, time.perf_counter(), **dict.fromkeys(APP_SETTINGS, False))

        for mode in ("raymarch", "no_dda", "default"):
            t0 = time.perf_counter()
            http(base, "/input", {"type": "render_mode", "mode": mode})
            rec = next_served(served, t0, mode=mode)
            served_frame(base, width, height, f"render_mode {mode}")
            if mode != "default":
                fps[mode] = frames_per_second(served, mode)
            log(f"app: render_mode {mode}: first frame {(rec['t'] - t0) * 1000:.1f} ms after the POST")

        http(base, "/benchmark", {"samples": SERVER_BENCH_SAMPLES})

        def result():
            b = json.loads(http(base, "/benchmark_result")[2])
            return b if b.get("running") is False and "time_per_sample_ms" in b else None

        bench = wait_until(result, "benchmark result")
        fingerprint = bench["device"]
        log(f"app: /benchmark of {SERVER_BENCH_SAMPLES} samples: {bench['time_per_sample_ms']} ms a sample served, "
            f"{bench['done']} samples; device {json.dumps(fingerprint['accelerator'])}, "
            f"power limit {fingerprint.get('powerLimit')}")
        if cuda and (fingerprint["accelerator"]["kind"] != torch.cuda.get_device_name(0)
                     or not fingerprint.get("powerLimit")):
            raise SystemExit(f"app: the benchmark's device lacks the card or its power limit: {fingerprint}")
        state = json.loads(http(base, "/state")[2])
        if state["error"] is not None:
            raise SystemExit(f"app: the server reports {state['error']}")
    finally:
        s.stop()
        server_mod.encode_png = encode_png
    if s._render_thread.is_alive():
        raise SystemExit("app: the render thread outlived stop()")
    launches = dict(kernels.LAUNCHES)
    full = [(ms, n) for ms, shape, n in encode_ms if shape == (height, width)]
    ms = [v for v, _ in full]
    log(f"app: frames served a second at {width}x{height}: " + ", ".join(f"{m} {v:.2f}" for m, v in fps.items())
        + f"; PNG encode of a {width}x{height} frame: median {np.median(ms):.2f} ms over {len(ms)} frames "
        f"(min {min(ms):.2f}, max {max(ms):.2f}), {np.median([n for _, n in full]) / 1e3:.0f} kB")
    log(f"app: launches over the server's run {launches}; phase {time.perf_counter() - t_phase:.1f} s; "
        f"host after the server: {host_probe()}")
    if cuda:
        for name in APP_KERNELS:
            if launches[name] <= 0:
                raise SystemExit(f"kernel {name} was not launched on the app path")
        t0 = time.perf_counter()
        hold_app_kernels(r, s.preview_scale)
        log(f"app: the path's kernels held on the server's renderer in {time.perf_counter() - t0:.1f} s")
    return launches


def gradient_and_debug_hits(grid, width: int, height: int) -> None:
    """Through the Renderer on the card at width x height: in each mode
    gradient-shaded samples (one launch of each leg), timed and one
    profiled, then one more with each kernel of the sample held bit for bit
    at every call (hold_frame_kernels); a debug-hits sample, timed and
    profiled, which launches no leg and no LUT fetch, and its image() one
    K4."""
    import torch

    from volxel_tpu_torch import kernels

    legs = {name for names in MODE_LEGS.values() for name in names}
    for mode, (camera, shadow) in MODE_LEGS.items():
        r = bench_renderer(grid, width, height, "cuda", mode)
        r.settings.gradient_shading = True
        r.render_frame()
        ms = []
        for _ in range(GRADIENT_SAMPLES):
            torch.cuda.synchronize()
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            r.render_frame()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1000)
            sample = {k: n - before[k] for k, n in kernels.LAUNCHES.items() if n != before[k]}
        log(f"gradient shading ({mode}, {width}x{height}): {', '.join(f'{v:.3f}' for v in ms)} ms a sample; "
            f"launches a sample {sample}")
        if (sample.get(camera), sample.get(shadow)) != (1, 1):
            raise SystemExit(f"a gradient-shaded {mode} sample launched its legs {sample}")
        log_device_profile(f"gradient shading ({mode})", r.render_frame, float(np.median(ms)))
        hold_frame_kernels(r, "gradient shading")
        del r
        torch.cuda.empty_cache()
    r = bench_renderer(grid, width, height, "cuda")
    r.settings.debug_hits = True
    r.render_frame()
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    r.render_frame()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000
    frame = {k: n - before[k] for k, n in kernels.LAUNCHES.items() if n != before[k]}
    before = dict(kernels.LAUNCHES)
    img = r.image()
    shown = {k: n - before[k] for k, n in kernels.LAUNCHES.items() if n != before[k]}
    log(f"debug hits ({width}x{height}): {ms:.3f} ms a sample, launches {frame} (env_lookup: the environment "
        f"behind the box); image() launches {shown}")
    log_device_profile("debug hits", r.render_frame, ms)
    if (legs | {"lookup_transfer", "shearwarp_intermediate", "tonemap"}) & set(frame) or shown != {"tonemap": 1}:
        raise SystemExit(f"a debug-hits sample launched {frame} and its image() {shown}")
    check_image(img, width, height, "debug hits")


def cli_path(tmp: Path) -> None:
    """`python -m volxel_tpu_torch render` (CLI_RENDER) and `info` in
    subprocesses from this checkout, on the card; the PNG is decoded here."""
    from volxel_tpu_torch.utils.png import decode_png

    root = Path(__file__).resolve().parent
    out = tmp / "cli.png"
    for args in ((*CLI_RENDER, "--out", str(out)), ("info",)):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "volxel_tpu_torch", *args], cwd=root, capture_output=True,
                             text=True, timeout=600)
        if run.returncode != 0:
            raise SystemExit(f"python -m volxel_tpu_torch {' '.join(args)} exited {run.returncode}:\n"
                             f"{run.stderr[-3000:]}")
        log(f"cli: {' '.join(args[:1])} in {time.perf_counter() - t0:.2f} s: "
            + " | ".join(line.strip() for line in run.stdout.strip().splitlines()[-4:]))
    img = decode_png(out.read_bytes())
    size = tuple(int(v) for v in CLI_RENDER[CLI_RENDER.index("--size") + 1].split("x"))
    if img.shape != (size[1], size[0], 3) or not img.max() > 0:
        raise SystemExit(f"the CLI's PNG is {img.shape} with max {img.max()}")
    if "native ingest: available" not in run.stdout or '"platform": "gpu"' not in run.stdout:
        raise SystemExit(f"`info` did not report the card and the native library: {run.stdout}")


# phase 2d: the mesh (parallel/). A DistributedRenderer on a 2x2 mesh whose
# four positions name one card, in each mode; render_views; two processes
# joined over gloo; step statistics; the preview server over a
# DistributedRenderer and `serve --mesh 1,1,1`; positions on two cards
# where the machine has them.
MESH = (2, 2)  # sp, px
MESH_STEPS = 3  # timed steps a mode, each sp samples
VIEWS = 4
MESH_SERVER_SIZE = (960, 540)
MESH_BENCH_SAMPLES = 4
MESH_WORKER_TIMEOUT = 420.0  # seconds, each of the two processes
CLI_SERVE = ("serve", "--synthetic", "64", "--size", "320x180", "--mesh", "1,1,1")
# phase 2e's: the volume in two slabs, both positions on the one card
CLI_SERVE_SLABS = ("serve", "--synthetic", "64", "--size", "320x180", "--mesh", "1,1,2", "--device", "cuda:0")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_renderer(grid, width: int, height: int, mesh, mode: str = "default"):
    """A DistributedRenderer on `mesh` with bench.py's scene and look."""
    from volxel_tpu_torch.parallel.distributed import DistributedRenderer

    r = DistributedRenderer(width, height, mesh=mesh)
    r.restart_from_grid(grid)
    r.render_mode = mode
    r.settings.bounces = 1
    bench_look(r)
    return r


def fenced_ms(fn, device) -> tuple:
    """(output, host ms) of one call of `fn`, the device fenced before and after."""
    from volxel_tpu_torch.utils.profiling import fence_device

    fence_device(device)
    t0 = time.perf_counter()
    out = fn()
    fence_device(device)
    return out, (time.perf_counter() - t0) * 1000


def mesh_steps(grid, width: int, height: int, device="cuda") -> dict:
    """The 2x2 mesh on one device named four times, MESH_STEPS steps in
    each mode, with every launch counter at 0 before the first mode: each
    step timed, the framebuffer bit-equal to the replayed single-position
    samples (tests/torch_mesh.py), each leg sp * px launches a step and the
    LUT fetch one a default step (one card), four single samples timed
    beside them, image() checked; then one more step profiled
    (log_device_profile) and one with every kernel held at every call
    (hold_frame_kernels). Returns the path's launch counts."""
    import torch

    from tests.torch_mesh import replayed_framebuffer
    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.parallel import make_mesh
    from volxel_tpu_torch.render.pathtrace import render_sample

    cuda = torch.device(device).type == "cuda"
    sp, px = MESH
    mesh = make_mesh(sp=sp, px=px, devices=[device] * (sp * px))
    kernels.reset_launch_counts()
    for mode, legs in MODE_LEGS.items():
        r = mesh_renderer(grid, width, height, mesh, mode)
        before = dict(kernels.LAUNCHES)
        step_ms = [fenced_ms(r.render_frame, device)[1] for _ in range(MESH_STEPS)]
        per_step = {k: (kernels.LAUNCHES[k] - before[k]) / MESH_STEPS for k in kernels.LAUNCHES}
        want = replayed_framebuffer(r, MESH_STEPS)
        if not bits_equal(r._framebuffer, want):
            raise SystemExit(f"mesh {sp}x{px} ({mode}): the framebuffer differs from the replayed single-position "
                             f"samples (max abs {max_abs([r._framebuffer], [want])})")
        ops = sample_operands(r)
        singles = [fenced_ms(lambda i=i: render_sample(*ops, i), device)[1] for i in range(sp * px)]
        img = r.image()
        check_image(img, width, height, f"mesh {sp}x{px} ({mode}) image()")
        log(f"mesh {sp}x{px} on one device ({mode}, {width}x{height}): steps of {sp} samples "
            + ", ".join(f"{ms:.3f}" for ms in step_ms) + f" ms; {sp * px} single samples "
            + ", ".join(f"{ms:.3f}" for ms in singles) + f" ms; framebuffer bit-equal to the replayed samples after "
            f"{MESH_STEPS} steps ({r.samples_rendered()} samples); launches a step "
            f"{ {k: v for k, v in per_step.items() if v} }")
        if cuda and any(per_step[name] != sp * px * r.settings.bounces for name in legs):
            raise SystemExit(f"mesh ({mode}): the legs launched {[per_step[n] for n in legs]} times a step")
        if cuda and per_step["lookup_transfer"] != (1 if mode == "default" else 0):
            raise SystemExit(f"mesh ({mode}): the LUT fetch launched {per_step['lookup_transfer']} times a step")
        launches = dict(kernels.LAUNCHES)
        if cuda:
            log_device_profile(f"mesh {sp}x{px} step ({mode})", r.render_frame, float(np.median(step_ms[1:])))
            hold_frame_kernels(r, f"mesh {sp}x{px} step")
        kernels.LAUNCHES.update(launches)  # the profile's and the holds' launches are not the path's
        del r
    return dict(kernels.LAUNCHES)


def mesh_views(grid, width: int, height: int, device="cuda") -> None:
    """render_views of VIEWS views at width x height in the default mode:
    one wavefront, each leg one launch a call, each view bit-equal to
    render_sample at frame * VIEWS + view; its ms and peak memory beside
    VIEWS single samples; then, after the counts are read, one more call
    with every kernel it launches held bit for bit against its plain
    version at every call, at the call's own shapes (VIEWS x width x
    height lanes; held_sample_kernels), bit-equal to the first."""
    import torch

    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.parallel.multiview import render_views
    from volxel_tpu_torch.render.pathtrace import render_sample

    cuda = torch.device(device).type == "cuda"
    r = bench_renderer(grid, width, height, device)
    config = r._config()
    cams = []
    for _ in range(VIEWS):
        r.camera.rotate_around_view(0.3, 0.0)
        cams.append(r._camera_operands(config))
    inv_views = torch.stack([c[0] for c in cams])
    inv_projs = torch.stack([c[1] for c in cams])
    ops = (r._device_grid, r.volume_params(), r._lut, r.environment.state)
    frame = 1
    render_views(config, *ops, inv_views, inv_projs, cams[0][2], frame)  # warm
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    before = dict(kernels.LAUNCHES)
    views, ms = fenced_ms(lambda: render_views(config, *ops, inv_views, inv_projs, cams[0][2], frame), device)
    calls = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES if kernels.LAUNCHES[k] != before[k]}
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20 if cuda else float("nan")
    singles = []
    for v in range(VIEWS):
        one, one_ms = fenced_ms(lambda v=v: render_sample(config, *ops, cams[v][0], cams[v][1], cams[v][2],
                                                          frame * VIEWS + v), device)
        singles.append(one_ms)
        if not bits_equal(views[v], one):
            raise SystemExit(f"render_views: view {v} differs from render_sample at {frame * VIEWS + v} "
                             f"(max abs {max_abs([views[v]], [one])})")
    log(f"render_views ({VIEWS} views, {width}x{height}, default): {ms:.3f} ms a call, {peak:.1f} MiB peak above "
        f"the operands; {VIEWS} single samples " + ", ".join(f"{v:.3f}" for v in singles) + " ms; every view "
        f"bit-equal to render_sample at frame * {VIEWS} + view; launches a call {calls}")
    if cuda and (calls.get("dda_leg_sample"), calls.get("dda_leg_shadow")) != (1, 1):
        raise SystemExit(f"render_views launched its legs {calls} times in one call")
    if cuda:
        log_device_profile(f"render_views ({VIEWS} views)",
                           lambda: render_views(config, *ops, inv_views, inv_projs, cams[0][2], frame), ms)
        held, tallies = held_sample_kernels(
            lambda: render_views(config, *ops, inv_views, inv_projs, cams[0][2], frame), "default")
        for name, tally in tallies:
            if tally["calls"] == 0:
                raise SystemExit(f"{name} was not called in the held render_views call")
            log(f"render_views ({VIEWS} views, {width}x{height}) held: {name} bit-equal at all {tally['calls']} "
                f"calls ({tally['lanes']} leg lanes in all); kernel {tally['ms']:.4f} ms, plain {tally['plain_ms']:.4f} ms "
                f"summed over them")
        if not bits_equal(held, views):
            raise SystemExit("render_views: the held call differs from the first")
        legs = dict(tallies)
        if legs["dda_leg_sample"]["lanes"] != VIEWS * width * height:
            raise SystemExit(f"render_views: the held camera leg ran {legs['dda_leg_sample']['lanes']} lanes")


def mesh_worker(addr: str, pid: int, size: int, width: int, height: int) -> None:
    """One of two processes on the card, joined over gloo: the bench scene,
    a DistributedRenderer whose sp = 2 spans the two processes (the mesh's
    default, every card of every process); its first step is bit-equal to
    the mean of samples 0 and 1 rendered here, and MESH_STEPS steps to the
    replayed samples. Prints one JSON line."""
    import torch

    from tests.torch_mesh import replayed_framebuffer
    from volxel_tpu_torch.grid import construct_brick_grid
    from volxel_tpu_torch.parallel import initialize_multihost, make_mesh, multihost, process_info
    from volxel_tpu_torch.render.pathtrace import render_sample
    from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume

    t0 = time.perf_counter()
    if not initialize_multihost(addr, 2, pid, backend="gloo"):
        raise SystemExit("mesh worker: initialize_multihost did not join the group")
    info = process_info()
    vol = synthetic_ct_volume((size,) * 3, bits_stored=12, seed=0)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    del vol
    r = mesh_renderer(grid, width, height, make_mesh(sp=2, px=1))
    setup_s = time.perf_counter() - t0
    step_ms = [fenced_ms(r.render_frame, r.device)[1]]
    ops = sample_operands(r)
    mean01 = (render_sample(*ops, 0) + render_sample(*ops, 1)) / 2
    first = bits_equal(r._framebuffer, mean01)
    step_ms += [fenced_ms(r.render_frame, r.device)[1] for _ in range(MESH_STEPS - 1)]
    replayed = bits_equal(r._framebuffer, replayed_framebuffer(r, MESH_STEPS))
    # the step's collective alone: the all_gather of this process's own (1, n, 3) f32 block
    buf = torch.zeros((1, width * height, 3), dtype=torch.float32, device=r.device)
    gather_ms = [fenced_ms(lambda: multihost.all_gather(buf), r.device)[1] for _ in range(MESH_STEPS)]
    print(json.dumps({"pid": pid, "info": info, "mesh": repr(r.mesh), "first_step_is_mean_of_0_1": first,
                      "replayed": replayed, "step_ms": step_ms, "gather_ms": gather_ms, "setup_s": setup_s,
                      "mean": float(r._framebuffer.mean())}), flush=True)
    torch.distributed.destroy_process_group()


def nccl_world_of_one(addr: str, width: int, height: int) -> None:
    """A process group of one process on NCCL (NCCL refuses two ranks on
    one card): multihost.all_gather of a frame-sized CUDA buffer of two
    positions goes through NCCL unstaged and returns it unchanged. Prints
    one JSON line."""
    import torch

    from volxel_tpu_torch.parallel import multihost

    torch.distributed.init_process_group("nccl", init_method=f"tcp://{addr}", world_size=1, rank=0)
    buf = torch.rand((2, width * height, 3), device="cuda")
    gathered, ms = fenced_ms(lambda: multihost.all_gather(buf), "cuda")
    ok = (torch.distributed.get_backend() == "nccl" and len(gathered) == 1 and gathered[0].is_cuda
          and bits_equal(gathered[0], buf))
    print(json.dumps({"nccl_all_gather_equal": ok, "ms": ms}), flush=True)
    torch.distributed.destroy_process_group()


def worker_pair(flags, size: int, width: int, height: int, timeout: float, what: str, count: int = 2) -> list[dict]:
    """Run `chip_smoke.py` with flags(addr, pid) for pids 0 .. count - 1
    (two by default) at once, joined at a free localhost port, each under
    `timeout`; fails unless all exit 0. Returns the JSON record each
    printed last."""
    addr = f"127.0.0.1:{free_port()}"
    root = Path(__file__).resolve().parent
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, str(root / "chip_smoke.py"), *flags(addr, pid), "--size", str(size),
                               "--width", str(width), "--height", str(height)],
                              cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in range(count)]
    outs = []
    try:
        for p in procs:
            outs.append((p, *p.communicate(timeout=timeout)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out, err in outs:
        if p.returncode != 0:
            raise SystemExit(f"{what} exited {p.returncode}:\n{out[-2000:]}\n{err[-4000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for _, out, _ in outs]


def mesh_processes(size: int, width: int, height: int) -> None:
    """Two processes on the card (mesh_worker), over gloo: each reports 2
    processes, a first step equal to the mean of samples 0 and 1 and the
    replayed framebuffer after MESH_STEPS steps, and the ms of each step."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    for rec in worker_pair(lambda addr, pid: ["--mesh-worker", addr, str(pid)], size, width, height,
                           MESH_WORKER_TIMEOUT, "mesh worker"):
        if not (rec["info"]["process_count"] == 2 and rec["info"]["distributed"] and rec["first_step_is_mean_of_0_1"]
                and rec["replayed"]):
            raise SystemExit(f"mesh worker {rec['pid']}: {rec}")
        log(f"two processes over gloo, sp=2 across them ({width}x{height}, default): process {rec['pid']} "
            f"{rec['info']}, {rec['mesh']}; setup {rec['setup_s']:.2f} s; steps of 2 samples "
            + ", ".join(f"{ms:.3f}" for ms in rec["step_ms"]) + " ms; the all_gather of its own block alone "
            + ", ".join(f"{ms:.3f}" for ms in rec["gather_ms"]) + " ms; first step bit-equal to the mean of samples "
            f"0 and 1, {MESH_STEPS} steps to the replayed samples; mean radiance {rec['mean']:.6f}")
    log(f"two processes: {time.perf_counter() - t0:.1f} s in all")
    run = subprocess.run([sys.executable, str(root / "chip_smoke.py"), "--mesh-nccl", f"127.0.0.1:{free_port()}",
                          "--width", str(width), "--height", str(height)], cwd=root, capture_output=True, text=True,
                         timeout=MESH_WORKER_TIMEOUT)
    if run.returncode != 0 or not json.loads(run.stdout.strip().splitlines()[-1])["nccl_all_gather_equal"]:
        raise SystemExit(f"NCCL at world size 1 (rc {run.returncode}): {run.stdout[-1000:]}\n{run.stderr[-3000:]}")
    log(f"NCCL, one process: the all_gather of a {width}x{height} two-position frame buffer returned it unchanged "
        f"in {json.loads(run.stdout.strip().splitlines()[-1])['ms']:.3f} ms")


def mesh_step_statistics(grid, width: int, height: int, device="cuda") -> None:
    """step_statistics at width x height in the default and no_dda modes:
    the percentiles and the seconds, each leg one launch; then once more
    with every kernel it launches held bit-equal at every call
    (held_sample_kernels: the legs, budgets and events included, and the
    default mode's LUT fetch) and the same statistics."""
    import torch

    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.utils.stepstats import step_statistics

    cuda = torch.device(device).type == "cuda"
    r = bench_renderer(grid, width, height, device)
    step_statistics(r, "default")  # warm
    for mode, legs in (("default", ("dda_leg_sample", "dda_leg_shadow")),
                       ("no_dda", ("track_leg_sample", "track_leg_shadow"))):
        before = dict(kernels.LAUNCHES)
        stats, ms = fenced_ms(lambda: step_statistics(r, mode), device)
        calls = {k: kernels.LAUNCHES[k] - before[k] for k in legs}
        log(f"step_statistics ({mode}, {width}x{height}): {ms / 1000:.4f} s; sample {stats['sample']}; "
            f"transmittance {stats['transmittance']}; leg launches {calls}")
        if cuda and set(calls.values()) != {1}:
            raise SystemExit(f"step_statistics ({mode}) launched its legs {calls} times")
        if stats["sample"]["frac_at_cap"] or stats["transmittance"]["frac_at_cap"]:
            log(f"step_statistics ({mode}): lanes reached a cap")
        if cuda:
            held, tallies = held_sample_kernels(lambda: step_statistics(r, mode), mode)
            called = {name: tally["calls"] for name, tally in tallies if tally["calls"]}
            if held != stats or [called.get(name) for name in legs] != [1, 1]:
                raise SystemExit(f"step_statistics ({mode}) held: {held} against {stats}, calls {called}")
            log(f"step_statistics ({mode}): every kernel it launched bit-equal to its plain version at every call "
                f"({called}), budgets or events included")


def mesh_server(grid, device="cuda") -> None:
    """PreviewServer over a DistributedRenderer on the 2x2 mesh at
    MESH_SERVER_SIZE, stepped directly: progressive frames, the server's
    benchmark of MESH_BENCH_SAMPLES samples counted sp a step, a rotate
    command's drag preview (K7), then frames again; samples counted as
    frame_index * sp. Then, after the counts are read, on the server's
    renderer at the server's shapes: one frame (its four positions'
    calls) with every kernel held at every call and K4 at image()
    (hold_frame_kernels), and one drag preview at the server's scale with
    K7 and K4 held (hold_drag_preview)."""
    import torch

    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.api.server import PreviewServer
    from volxel_tpu_torch.parallel import make_mesh

    sp, px = MESH
    r = mesh_renderer(grid, *MESH_SERVER_SIZE, make_mesh(sp=sp, px=px, devices=[device] * (sp * px)))
    s = PreviewServer(r, port=0)
    outcomes = [s.step() for _ in range(3)]
    samples = r.frame_index * r.sp
    s._commands.put({"type": "benchmark", "samples": MESH_BENCH_SAMPLES})
    outcomes += [s.step() for _ in range(MESH_BENCH_SAMPLES // sp)]
    bench = s._benchmark
    before = kernels.LAUNCHES["shearwarp_intermediate"]
    s._commands.put({"type": "rotate", "by": [0.05, 0.02]})
    preview, preview_ms = fenced_ms(s.step, device)
    k7 = kernels.LAUNCHES["shearwarp_intermediate"] - before
    wait_until(lambda: time.time() > s._motion_until + 0.05, "end of the rotate's motion")
    outcomes += [s.step() for _ in range(2)]
    log(f"server over the {sp}x{px} mesh ({MESH_SERVER_SIZE[0]}x{MESH_SERVER_SIZE[1]}): steps {outcomes}, "
        f"{samples} samples after 3 frames; benchmark {bench}; rotate: {preview} in {preview_ms:.3f} ms, "
        f"K7 launches {k7}; then {r.samples_rendered()} samples")
    if samples != 3 * sp:
        raise SystemExit(f"server over the mesh: {samples} samples after 3 frames of {sp}")
    if bench["running"] or bench["done"] != MESH_BENCH_SAMPLES or preview != "preview" or set(outcomes) != {"frame"}:
        raise SystemExit(f"server over the mesh: benchmark {bench}, rotate {preview}, steps {outcomes}")
    cuda = torch.device(device).type == "cuda"
    if cuda and k7 != 1:
        raise SystemExit(f"server over the mesh: the drag preview launched K7 {k7} times")
    check_image(r.image(), *MESH_SERVER_SIZE, "the mesh server's image()")
    if cuda:
        hold_frame_kernels(r, "mesh server")
        hold_drag_preview(r, s.preview_scale, "mesh server")


def serve_mesh_cli(cli: tuple = CLI_SERVE) -> None:
    """`python -m volxel_tpu_torch serve ... --mesh ...` (`cli`, by default
    CLI_SERVE's 1,1,1) in a subprocess on an ephemeral port: /state counts
    samples and /frame.png is a frame of the size asked for; the process
    is stopped."""
    from volxel_tpu_torch.utils.png import decode_png

    port = free_port()
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "volxel_tpu_torch", *cli, "--port", str(port)], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"

    def state():
        if proc.poll() is not None:
            raise SystemExit(f"serve --mesh exited {proc.returncode}: {proc.communicate()[1][-3000:]}")
        try:
            st = json.loads(http(base, "/state")[2])
        except OSError:
            return None
        return st if st["samples"] >= 2 else None

    try:
        st = wait_until(state, f"{' '.join(cli)}: the second sample")
        img = decode_png(http(base, "/frame.png")[2])
    finally:
        proc.terminate()
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
    size = tuple(int(v) for v in cli[cli.index("--size") + 1].split("x"))
    if img.shape != (size[1], size[0], 3) or st["error"] is not None:
        raise SystemExit(f"serve --mesh: frame {img.shape}, state {st}")
    log(f"cli: {' '.join(cli)}: {st['samples']} samples served {time.perf_counter() - t0:.2f} s after the "
        f"start; /frame.png {img.shape}")


def mesh_two_cards(grid, width: int, height: int) -> None:
    """sp = 2 over cuda:0 and cuda:1 where the machine has two cards:
    MESH_STEPS steps bit-equal to the replayed single-card samples."""
    import torch

    from tests.torch_mesh import replayed_framebuffer
    from volxel_tpu_torch.parallel import make_mesh

    if torch.cuda.device_count() < 2:
        log("mesh over two cards: skipped, the machine has one card")
        return
    r = mesh_renderer(grid, width, height, make_mesh(sp=2, px=1, devices=["cuda:0", "cuda:1"]))
    step_ms = [fenced_ms(r.render_frame, "cuda")[1] for _ in range(MESH_STEPS)]
    torch.cuda.synchronize(1)
    if not bits_equal(r._framebuffer, replayed_framebuffer(r, MESH_STEPS)):
        raise SystemExit("mesh over two cards: the framebuffer differs from the replayed samples")
    log(f"mesh over cuda:0 and cuda:1 (sp=2, {width}x{height}): steps " + ", ".join(f"{ms:.3f}" for ms in step_ms)
        + " ms; bit-equal to the replayed single-card samples")


def mesh_path(grid, size: int, width: int, height: int) -> dict:
    """Phase 2d; returns the mesh path's launch counts."""
    import torch

    t_phase = time.perf_counter()
    launches = mesh_steps(grid, width, height)
    log(f"mesh: launches over the 2x2 mesh's steps in three modes {launches}")
    torch.cuda.empty_cache()
    mesh_views(grid, width, height)
    torch.cuda.empty_cache()
    mesh_processes(size, width, height)
    mesh_step_statistics(grid, width, height)
    mesh_server(grid)
    torch.cuda.empty_cache()
    serve_mesh_cli()
    mesh_two_cards(grid, width, height)
    torch.cuda.empty_cache()
    log(f"phase 2d (the mesh): {time.perf_counter() - t_phase:.1f} s")
    return launches


# phase 2e: render-time volume slabs (parallel/volshard.py). A
# DistributedRenderer whose SLAB_VZ positions along 'vz' name one card,
# loaded from the brick grid, beside a vz = 1 renderer on the same card.
SLAB_VZ = 4
SLAB_STEPS = 2  # steps a mode, each one sample (sp = 1)
SLAB_ROUNDS = 2  # held steps a mode in turns: vz = 1, then the slabs
# the legs of every mode: their registers and own SASS instructions as the
# parent commit's csrc builds them (examples/leg_sass.py on an H100 with
# CUDA 12.8); the slab forms are other kernels and leave these as they were
DENSE_LEG_SASS = {"dda_leg_sample_kernel": (64, 480), "dda_leg_shadow_kernelILb0E": (56, 500),
                  "dda_leg_shadow_kernelILb1E": (56, 499), "track_leg_sample_kernel": (85, 883),
                  "track_leg_shadow_kernel": (48, 297), "tile_march_sample_kernelILb1E": (56, 549),
                  "tile_march_sample_kernelILb0E": (56, 553), "tile_march_transmittance_kernelILb1E": (54, 1594),
                  "tile_march_transmittance_kernelILb0E": (56, 1612)}
# each leg's source and the TPU kernel its entry in the JSON line replaces
SLAB_LEG_SOURCES = {
    "dda_leg_sample": ("dda_leg.cu", "volxel_tpu/render/pyrmarch.py:313"),
    "dda_leg_shadow": ("dda_leg.cu", "volxel_tpu/render/pyrmarch.py:313"),
    "track_leg_sample": ("track_leg.cu", "volxel_tpu/render/mxu_gather.py:196"),
    "track_leg_shadow": ("track_leg.cu", "volxel_tpu/render/mxu_gather.py:196"),
    "tile_march_sample": ("tile_march.cu", "volxel_tpu/render/tilemarch.py:627"),
    "tile_march_transmittance": ("tile_march.cu", "volxel_tpu/render/mxu_gather.py:196"),
}


def field_bytes(field) -> int:
    """The bytes of a leg's field: the dense tensor, or a SlabGrid's slabs."""
    from volxel_tpu_torch.render.sampling import SlabGrid

    return sum(nbytes(s) for s in field.slabs) if isinstance(field, SlabGrid) else nbytes(field)


def slab_work(name: str):
    """compared_calls' work of leg `name` from its call's arguments and
    outputs: every lane's mask and words read and its outputs written once,
    each running lane's other per-lane operands read once, the LUT, the
    scalars (and the default legs' pyramid) once; and the work the outputs
    show: the default legs' march steps (cap - budget; their collisions'
    taps, which only the plain rounds count, are left out, so this bound is
    looser than phase 3's), the no_dda legs' events (eight 2-byte taps
    each), the raymarch legs' steps (one 2-byte tap each), the taps' bytes
    at most the field's."""
    import torch

    from volxel_tpu_torch.render import ddaleg, tilemarch, trackleg

    def work(args, got):
        if name.startswith("tile_march"):
            field, ipos, idir, start, dt, far, valid = args[:7]
            state, lut, scalars = args[-4:-1]
            if name == "tile_march_sample":
                _, hit, t, _ = got
                taken = torch.clamp(torch.round((t - start) / dt) + 1, 1, tilemarch.STEPS)
                steps = int(torch.where(hit, taken, float(tilemarch.STEPS))[valid].sum())
            else:
                steps = int(valid.sum()) * tilemarch.STEPS
            lanes = [a for a in args[1:7] if a is not valid]
            mask, taps, ops, shared = valid, 2 * steps, steps * OPS_TILE_STEP, (lut, scalars)
        elif name.startswith("dda_leg"):
            field, maj, _, scalars, lut = args[:5]
            state, mask = args[12:14]
            cap = ddaleg.DDA_SAMPLE_MAX_STEPS if name == "dda_leg_sample" else ddaleg.DDA_TRANSMITTANCE_MAX_STEPS
            steps = int(torch.where(mask, cap - got[-1], 0).sum())
            lanes = [*args[5:12], *([] if name == "dda_leg_sample" else [args[14]])]
            taps, ops, shared = 0, steps * OPS_DDA_STEP, (maj, lut, scalars)
        else:
            field, _, scalars, lut = args[:4]
            state, mask = args[8:10]
            events = int(torch.where(mask, trackleg.TRACKING_MAX_EVENTS - got[-1], 0).sum())
            lanes = [*args[4:8], *([] if name == "track_leg_sample" else [args[10]])]
            taps, ops, shared = 16 * events, events * OPS_COLLIDE, (lut, scalars)
        running = int(mask.sum())
        moved = (nbytes(mask, state, *got) + running * nbytes(*lanes) // max(mask.numel(), 1)
                 + min(field_bytes(field), taps) + nbytes(*shared))
        return moved, ops
    return work


def held_slab_step(r, what: str) -> dict:
    """One render_frame() of `r` with each kernel of its mode's sample held
    bit for bit against its plain version at every call
    (spec_sample_kernels; the legs' work by slab_work). Returns the
    tallies by name."""
    import volxel_tpu_torch.render.modes as modes

    checks = spec_sample_kernels(r.render_mode, r.settings.gradient_shading)
    with contextlib.ExitStack() as stack:
        tallies = [stack.enter_context(compared_calls(module, name, cuda_fn, plain_fn, outputs, mask_lanes,
                                                      slab_work(name) if module is modes else no_work))
                   for module, name, cuda_fn, plain_fn, outputs in checks]
        r.render_frame()
    for (_, name, *_), tally in zip(checks, tallies):
        if tally["calls"] == 0:
            raise SystemExit(f"{name} was not called in one {r.render_mode} step of {what}")
    return {name: tally for (_, name, *_), tally in zip(checks, tallies)}


def slab_renderer(grid, width: int, height: int, mesh, device):
    """A DistributedRenderer on `mesh` loaded by restart_from_grid (on a vz
    mesh the from-brick path), in bench.py's look; returns it, the load's
    seconds and the peak of the card's allocated bytes during the load
    above what the renderer holds after it."""
    import torch

    from volxel_tpu_torch.parallel.distributed import DistributedRenderer
    from volxel_tpu_torch.utils.profiling import fence_device

    r = DistributedRenderer(width, height, mesh=mesh)
    fence_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    r.restart_from_grid(grid)
    fence_device(device)
    seconds = time.perf_counter() - t0
    scratch = torch.cuda.max_memory_allocated(device) - torch.cuda.memory_allocated(device)
    r.settings.bounces = 1
    bench_look(r)
    return r, seconds, scratch


def slab_load(grid, width: int, height: int, device) -> tuple:
    """The SLAB_VZ renderer's load: its seconds, each slab's bytes and the
    load's peak above the slabs, which must stay below the whole field's
    bytes; then a vz = 1 renderer on the card. Returns both."""
    from volxel_tpu_torch.parallel import make_mesh

    bx, by, bz = grid.brick_count
    whole = bx * by * bz * 512 * 2
    r, seconds, scratch = slab_renderer(grid, width, height, make_mesh(sp=1, px=1, vz=SLAB_VZ,
                                                                       devices=[device] * SLAB_VZ), device)
    slabs = sorted((v, tuple(s.shape), nbytes(s)) for (_, v), s in r._slabbed.slabs.items())
    if len(slabs) != SLAB_VZ or any(b >= whole for *_, b in slabs) or scratch >= whole:
        raise SystemExit(f"slabs: {slabs}, the load's peak above them {scratch} B, the whole field {whole} B")
    if r._device_grid.dense is not None:
        raise SystemExit("slabs: the renderer holds a whole dense field")
    rep, rep_seconds, rep_scratch = slab_renderer(grid, width, height, make_mesh(sp=1, px=1, devices=[device]),
                                                  device)
    log(f"slabs: vz={SLAB_VZ} on one card loaded from the brick grid in {seconds:.3f} s (vz = 1: "
        f"{rep_seconds:.3f} s); slabs " + ", ".join(f"{v}: {shape} {b} B" for v, shape, b in slabs)
        + f"; the load's peak above what it keeps {scratch} B ({scratch / whole:.4f} of the whole field's "
        f"{whole} B; vz = 1: {rep_scratch} B)")
    return r, rep


def slab_steps(r, rep, device) -> tuple[dict, dict]:
    """SLAB_STEPS steps of `r` (the slabs) and `rep` (vz = 1) in each mode,
    each step timed: r's framebuffer bit-equal to rep's, each leg launched
    in its slab form SLAB_VZ times a bounce and never in its dense form in
    r's steps. Then, after the counts are read, SLAB_ROUNDS held steps of
    each in turns (held_slab_step): the legs' kernel ms at one step's calls
    in both forms. Returns the launches of r's steps and the slab forms'
    tallies (the last round's) by leg."""
    from volxel_tpu_torch import kernels

    launched = dict.fromkeys(kernels.LAUNCHES, 0)
    tallies = {}
    for mode, legs in MODE_LEGS.items():
        for x in (r, rep):
            x.render_mode = mode
        slab_ms, rep_ms = [], []
        for _ in range(SLAB_STEPS):
            before = dict(kernels.LAUNCHES)
            slab_ms.append(fenced_ms(r.render_frame, device)[1])
            for k in launched:
                launched[k] += kernels.LAUNCHES[k] - before[k]
            rep_ms.append(fenced_ms(rep.render_frame, device)[1])
        if not bits_equal(r._framebuffer, rep._framebuffer):
            raise SystemExit(f"slabs ({mode}): the framebuffer differs from vz = 1's "
                             f"(max abs {max_abs([r._framebuffer], [rep._framebuffer])})")
        bounces = r.settings.bounces * SLAB_STEPS
        wrong = {leg: (launched[leg], launched[f"{leg}_slabs"]) for leg in legs
                 if launched[leg] or launched[f"{leg}_slabs"] != SLAB_VZ * bounces}
        if wrong:
            raise SystemExit(f"slabs ({mode}): legs launched (dense, slab form) {wrong}")
        check_image(r.image(), *r._render_dims(), f"slabs ({mode}) image()")
        log(f"slabs vz={SLAB_VZ} ({mode}, {'x'.join(map(str, r._render_dims()))}): steps "
            + ", ".join(f"{ms:.3f}" for ms in slab_ms) + " ms; vz = 1 steps (one sample each) "
            + ", ".join(f"{ms:.3f}" for ms in rep_ms) + f" ms; framebuffer bit-equal to vz = 1's after "
            f"{SLAB_STEPS} steps; slab-form launches {[launched[f'{leg}_slabs'] for leg in legs]}")
        saved = dict(kernels.LAUNCHES)
        for rnd in range(SLAB_ROUNDS):
            dense = held_slab_step(rep, "vz = 1")
            slabbed = held_slab_step(r, f"vz = {SLAB_VZ}")
            for leg in legs:
                d, t = dense[leg], slabbed[leg]
                log(f"slabs round {rnd} ({mode}): {leg} bit-equal at all {t['calls']} calls of one step; slab "
                    f"form {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}) summed over them, dense form "
                    f"{d['ms']:.4f} ms over its {d['calls']} calls; bound {bound(t['bytes'], t['ops'])['bound_ms']:.4f} ms")
                tallies[leg] = t
        kernels.LAUNCHES.update(saved)  # the holds' launches are not the path's
        if not bits_equal(r._framebuffer, rep._framebuffer):
            raise SystemExit(f"slabs ({mode}): the held steps' framebuffers differ")
    return launched, tallies


def slab_variants(grid, r, rep, width: int, height: int, device) -> None:
    """On the slabs: two gradient-shaded default steps, timed in turns
    with vz = 1's and bit-equal to them; one (sp=2, px=1, vz=2) step bit-equal to an sp = 2 one; vz = 2
    over cuda:0 and cuda:1 where the machine has two cards."""
    import torch

    from volxel_tpu_torch.parallel import make_mesh

    for x in (r, rep):
        x.render_mode = "default"
        x.settings.gradient_shading = True
    ms, rep_ms = [], []
    for _ in range(2):  # in turns, so the two forms share the card's state
        ms.append(fenced_ms(r.render_frame, device)[1])
        rep_ms.append(fenced_ms(rep.render_frame, device)[1])
    if not bits_equal(r._framebuffer, rep._framebuffer):
        raise SystemExit("slabs: the gradient-shaded steps differ from vz = 1's")
    log(f"slabs vz={SLAB_VZ}: gradient-shaded default steps {', '.join(f'{v:.3f}' for v in ms)} ms beside "
        f"{', '.join(f'{v:.3f}' for v in rep_ms)} ms at vz = 1, bit-equal")
    pairs = [("sp=2, vz=2", make_mesh(sp=2, px=1, vz=2, devices=[device] * 4),
              make_mesh(sp=2, px=1, devices=[device] * 2))]
    if torch.cuda.device_count() >= 2:
        pairs.append(("vz=2 over cuda:0 and cuda:1", make_mesh(sp=1, px=1, vz=2, devices=["cuda:0", "cuda:1"]),
                      make_mesh(sp=1, px=1, devices=["cuda:0"])))
    else:
        log("slabs over two cards: skipped, the machine has one card")
    for what, mesh, flat in pairs:
        a = slab_renderer(grid, width, height, mesh, device)[0]
        b = slab_renderer(grid, width, height, flat, device)[0]
        ms = fenced_ms(a.render_frame, device)[1]
        b.render_frame()
        torch.cuda.synchronize()
        if not bits_equal(a._framebuffer, b._framebuffer):
            raise SystemExit(f"slabs ({what}): the step differs from the whole field's")
        log(f"slabs ({what}, default): one step {ms:.3f} ms, bit-equal to the whole field's")
        del a, b


def check_dense_leg_sass(found: dict, registers: dict) -> None:
    """Phase 2's registers and own SASS instructions of the legs' dense
    forms, as DENSE_LEG_SASS has them."""
    got = {}
    for key in DENSE_LEG_SASS:
        src = "dda_leg.cu" if key.startswith("dda") else "track_leg.cu" if key.startswith("track") else "tile_march.cu"
        fn = next(f for f in found[src] if key in f)
        got[key] = (registers[src][fn], found[src][fn]["own"][2])
    if got != DENSE_LEG_SASS:
        raise SystemExit(f"the legs' dense forms changed: (registers, own SASS) {got}, expected {DENSE_LEG_SASS}")
    log(f"the legs' dense forms as the parent commit builds them: (registers, own SASS) {got}")


def slab_path(grid, width: int, height: int, found: dict, registers: dict, device="cuda") -> tuple[dict, dict]:
    """Phase 2e, with every launch counter at 0 before it; returns the
    slab run's launch counts and the slab forms' tallies by leg."""
    import torch

    from volxel_tpu_torch import kernels

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    r, rep = slab_load(grid, width, height, device)
    launched, tallies = slab_steps(r, rep, device)
    slab_variants(grid, r, rep, width, height, device)
    del r, rep
    torch.cuda.empty_cache()
    serve_mesh_cli(CLI_SERVE_SLABS)
    check_dense_leg_sass(found, registers)
    log(f"phase 2e (render-time volume slabs): {time.perf_counter() - t_phase:.1f} s")
    return launched, tallies


def slab_entries(launched: dict, tallies: dict) -> list[dict]:
    """The JSON line's entries of the legs' slab forms, from phase 2e."""
    out = []
    for leg, t in tallies.items():
        src, replaces = SLAB_LEG_SOURCES[leg]
        e = entry(f"{leg}_slabs", f"volxel_tpu_torch/csrc/{src}", replaces, t["err"], t["ms"], t["plain_ms"],
                  t["bytes"], t["ops"])
        e["launches"] = launched[f"{leg}_slabs"]
        out.append(e)
    return out


# phase 2f: a vz = 2 row across two processes of the node (one process a
# card, here both on the one card), joined over gloo: each process decodes
# its own slab and maps the other's through CUDA IPC (parallel/nodeshare.py)
NODE_STEPS = 2  # counted steps a mode across the processes, each one sample
NODE_ROUNDS = 2  # timed rounds a mode: a step across the processes, then vz = 2 and vz = 1 in one process
NODE_SWAPS = 2  # timestep swaps, two steps each, with no host sync of the caller's between them
NODE_LANE_STRIDE = 16  # the held legs' lanes: every 16th lane of each call
NODE_WORKER_TIMEOUT = 300.0  # seconds, each of the two processes


@contextlib.contextmanager
def strided_holds(mode: str, stride: int):
    """While the block runs, each leg of a `mode` sample (modes.<leg>, as
    the sample calls it) also runs its CUDA wrapper and its plain version
    on every `stride`-th lane of each call: fails unless the two agree bit
    for bit on every output and the wrapper's equals the call's own on
    those lanes. The call itself returns what it returned. Yields {leg:
    tally}: the calls, the lanes held and the first call's arguments."""
    import torch

    import volxel_tpu_torch.render.modes as modes

    checks = [c for c in spec_sample_kernels(mode) if c[0] is modes]
    originals = {name: getattr(modes, name) for _, name, *_ in checks}
    tallies = {name: {"calls": 0, "lanes": 0, "first_args": None} for name in originals}

    def held(name, cuda_fn, plain_fn, outputs):
        def call(*args):
            got = originals[name](*args)
            n = mask_lanes(args)
            sub = tuple(a[::stride].contiguous() if isinstance(a, torch.Tensor) and a.dim() and a.shape[0] == n
                        else a for a in args)
            kernel, plain = cuda_fn(*sub), plain_fn(*sub)
            bad = [nm for nm, k, w, full in zip(outputs, kernel, plain, got)
                   if not (bits_equal(k, w) and bits_equal(k, full[::stride]))]
            if bad:
                raise SystemExit(f"{name} through a mapped slab, call {tallies[name]['calls']}: {bad} differ on every "
                                 f"{stride}th lane (max abs {max_abs(kernel, plain)})")
            tally = tallies[name]
            tally["calls"] += 1
            tally["lanes"] += mask_lanes(sub)
            if tally["first_args"] is None:
                tally["first_args"] = args
            return got
        return call

    for _, name, cuda_fn, plain_fn, outputs in checks:
        setattr(modes, name, held(name, cuda_fn, plain_fn, outputs))
    try:
        yield tallies
    finally:
        for name, fn in originals.items():
            setattr(modes, name, fn)


def first_call_ms(mode: str, held: dict, own: dict | None) -> dict:
    """Each leg's CUDA wrapper at the first call that strided_holds saw
    (`held`), timed by device_ms; with `own`, the same leg's first call
    there too, in turns: held, own, own, held."""
    out = {}
    for leg, tally in held.items():
        cuda_fn = next(c[2] for c in spec_sample_kernels(mode) if c[1] == leg)
        calls = [tally["first_args"]] + ([own[leg]["first_args"]] * 2 + [tally["first_args"]] if own else [])
        ms = [device_ms(lambda args=args: cuda_fn(*args), KERNEL_REPS)[1] for args in calls]
        out[leg] = {"mapped": [ms[0], *ms[3:]], "own": ms[1:3]}
    return out


def node_worker(addr: str, pid: int, size: int, width: int, height: int, cards: tuple) -> None:
    """One of phase 2f's two processes: process p on device cards[p],
    joined over gloo where the two share a card (NCCL refuses that) and
    over NCCL where each has its own, renders its part of a (1, 1, 2)
    mesh's row with its own slab and the other's mapped. Rank 0 holds a
    vz = 1 and a vz = 2 renderer of its own beside it. Prints one JSON line: the device bytes of the load,
    each mode's launches, frames bit-equal to vz = 1, step ms in turns,
    the legs held on strided lanes through the mapped slab and their kernel
    ms beside the one-process slab form's, and the timestep swaps."""
    import torch

    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.grid import construct_brick_grid
    from volxel_tpu_torch.parallel import initialize_multihost, make_mesh, multihost
    from volxel_tpu_torch.parallel.distributed import DistributedRenderer
    from volxel_tpu_torch.render.sampling import device_grid_from_brick
    from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume
    from volxel_tpu_torch.utils.profiling import fence_device

    t0 = time.perf_counter()
    device = torch.device(cards[pid])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    if not initialize_multihost(addr, 2, pid, backend="gloo" if cards[0] == cards[1] else "nccl"):
        raise SystemExit("node worker: initialize_multihost did not join the group")
    vol = synthetic_ct_volume((size,) * 3, bits_stored=12, seed=0)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    del vol
    bx, by, bz = grid.brick_count
    mesh = make_mesh(sp=1, px=1, vz=2, devices=list(enumerate(cards)))
    r = DistributedRenderer(width, height, mesh=mesh, device=device)

    def allocated():
        return torch.cuda.memory_allocated(device) if cuda else 0

    fence_device(device)
    base = allocated()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t_load = time.perf_counter()
    r.restart_from_grid(grid)
    fence_device(device)
    rec = {"pid": pid, "device": str(device), "backend": torch.distributed.get_backend(),
           "load_s": time.perf_counter() - t_load,
           "whole_bytes": bx * by * bz * 512 * 2, "slab_bytes": (-(-bz * 8 // 2) + 4) * by * bx * 128,
           "held_bytes": allocated() - base,
           "peak_bytes": torch.cuda.max_memory_allocated(device) - base if cuda else 0,
           "own": sorted([str(c), v, nbytes(t)] for (c, v), t in r._slabbed.slabs.items()
                         if (c, v) not in r._slabbed.mapped),
           "mapped": sorted((str(c), v) for c, v in r._slabbed.mapped)}
    r.settings.bounces = 1
    bench_look(r)
    reps = {}
    if pid == 0:
        for vz in (1, 2):
            reps[vz] = DistributedRenderer(width, height, mesh=make_mesh(sp=1, px=1, vz=vz, devices=[(0, device)] * vz),
                                           device=device)
            reps[vz].restart_from_grid(grid)
            reps[vz].settings.bounces = 1
            bench_look(reps[vz])
    rec["setup_s"] = time.perf_counter() - t0
    rec["modes"] = {}
    for mode, legs in MODE_LEGS.items():
        out = rec["modes"][mode] = {}
        for x in (r, *reps.values()):
            x.render_mode = mode
        kernels.reset_launch_counts()
        for _ in range(NODE_STEPS):
            r.render_frame()
        fence_device(device)
        out["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        for _ in range(NODE_STEPS):
            for x in reps.values():
                x.render_frame()
        out["equal"] = pid != 0 or bits_equal(r._framebuffer, reps[1]._framebuffer)
        out["step_ms"], out["vz2_ms"], out["vz1_ms"] = [], [], []
        for _ in range(NODE_ROUNDS):  # in turns: the other process waits at the barrier while rank 0 runs its own
            multihost.host_barrier()
            out["step_ms"].append(fenced_ms(r.render_frame, device)[1])
            if pid == 0:
                out["vz2_ms"].append(fenced_ms(reps[2].render_frame, device)[1])
                out["vz1_ms"].append(fenced_ms(reps[1].render_frame, device)[1])
        multihost.host_barrier()
        out["equal_after_rounds"] = pid != 0 or (bits_equal(r._framebuffer, reps[1]._framebuffer)
                                                 and bits_equal(reps[2]._framebuffer, reps[1]._framebuffer))
        # each leg through the table holding the mapped slab, on strided lanes
        with strided_holds(mode, NODE_LANE_STRIDE) as held:
            r.render_frame()
        own = None
        if pid == 0:  # the one-process vz = 2 mesh's position 0 renders the same lanes with its own slabs
            with strided_holds(mode, NODE_LANE_STRIDE) as own:
                reps[2].render_frame()
        out["held"] = {leg: {k: t[k] for k in ("calls", "lanes")} for leg, t in held.items()}
        out["kernel_ms"] = {}
        for turn in (0, 1):  # each process times its first calls while the other waits
            multihost.host_barrier()
            if turn == pid:
                out["kernel_ms"] = first_call_ms(mode, held, own)
        multihost.host_barrier()
        del held, own  # their first calls' arguments hold the slabs
        for x in reps.values():  # keep the step counts level with r's
            x.render_frame()
    # timestep swaps: each process cuts its slab from a whole field on its
    # card (time series), the old shared slabs released in between
    for x in (r, *reps.values()):
        x.render_mode = "default"
    fence_device(device)
    before_swaps = allocated()
    whole = device_grid_from_brick(grid, device)
    steps = [whole._replace(dense=(whole.dense.float() * (1.0 - 0.3 * t)).to(torch.bfloat16)) for t in (1, 2)]
    del whole
    frames = []
    t_swaps = time.perf_counter()
    for step in steps:
        for x in (r, *([reps[1]] if pid == 0 else [])):
            x._device_grid = step
            x.restart_rendering()
        for _ in range(2):
            r.render_frame()
            if pid == 0:
                reps[1].render_frame()
        frames.append((r._framebuffer.clone(), reps[1]._framebuffer.clone() if pid == 0 else None))
    fence_device(device)
    rec["swaps_s"] = time.perf_counter() - t_swaps
    rec["swaps_equal"] = pid != 0 or all(bits_equal(a, b) for a, b in frames)
    rec["swaps_mapped"] = sorted((str(c), v) for c, v in r._slabbed.mapped)
    # what the swaps left beyond the new fields and the frames kept here:
    # about 0 where each swap freed the slab it replaced
    kept = sum(nbytes(step.dense) for step in steps) + sum(nbytes(*(f for f in pair if f is not None))
                                                            for pair in frames)
    rec["swaps_delta_bytes"] = allocated() - before_swaps - kept
    held_before_close = allocated()
    r.close()
    fence_device(device)
    rec["close_freed_bytes"] = held_before_close - allocated()
    rec["seconds"] = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)
    torch.distributed.destroy_process_group()


def node_processes(size: int, width: int, height: int, cards: tuple) -> list[dict]:
    """Phase 2f's two processes (node_worker) on cards[0] and cards[1];
    fails unless both exit 0. Returns their records."""
    return worker_pair(lambda addr, pid: ["--node-worker", addr, str(pid), ",".join(cards)], size, width, height,
                       NODE_WORKER_TIMEOUT, f"node worker on {cards}")


def node_slab_path(size: int, width: int, height: int) -> dict:
    """Phase 2f: a vz = 2 row across two processes on the card (and over
    cuda:0 and cuda:1 where the machine has two cards). Fails unless each
    process holds one slab of its own and maps the other's, rank 0's
    frames are bit-equal to vz = 1's in every mode, each process launched
    every leg of each mode in its slab form and none in its dense form,
    every held leg is bit-equal on its strided lanes, and the timestep
    swaps stay bit-equal. Returns rank 0's step ms by mode on the one card
    (phase 2g prints them beside its own)."""
    import torch

    t_phase = time.perf_counter()
    within = {}
    cuda = torch.cuda.is_available()
    runs = [("cuda:0", "cuda:0")] + ([("cuda:0", "cuda:1")] if torch.cuda.device_count() >= 2 else [])
    for cards in runs:
        for rec in node_processes(size, width, height, cards):
            pid, whole = rec["pid"], rec["whole_bytes"]
            where = f"vz = 2 across two processes on {cards[0]} and {cards[1]} ({rec['backend']}), process {pid}"
            if rec["own"] != [[cards[pid], pid, rec["slab_bytes"]]] or len(rec["mapped"]) != 1:
                raise SystemExit(f"{where}: own slabs {rec['own']} (expected one of {rec['slab_bytes']} B), mapped "
                                 f"{rec['mapped']}")
            if rec["held_bytes"] >= whole:
                raise SystemExit(f"{where}: holds {rec['held_bytes']} B after the load, the whole field is {whole} B")
            log(f"{where}: loaded in {rec['load_s']:.3f} s (setup {rec['setup_s']:.2f} s); holds its slab "
                f"{rec['own'][0][2]} B and maps {rec['mapped']}; device bytes after the load {rec['held_bytes']} "
                f"(torch.cuda.memory_allocated above the renderer's), the load's peak {rec['peak_bytes']}; "
                f"the whole field {whole} B")
            for mode, legs in MODE_LEGS.items():
                m = rec["modes"][mode]
                if pid == 0 and cards == runs[0]:
                    within[mode] = m["step_ms"]
                wrong = {leg: (m["launches"].get(leg, 0), m["launches"].get(f"{leg}_slabs", 0)) for leg in legs
                         if m["launches"].get(leg, 0) or m["launches"].get(f"{leg}_slabs", 0) != NODE_STEPS}
                if wrong or not (m["equal"] and m["equal_after_rounds"]):
                    raise SystemExit(f"{where} ({mode}): legs launched (dense, slab form) {wrong}, frames bit-equal "
                                     f"to vz = 1: {m['equal']}, after the rounds {m['equal_after_rounds']}")
                if any(t["calls"] == 0 for t in m["held"].values()):
                    raise SystemExit(f"{where} ({mode}): a leg was not held: {m['held']}")
                log(f"{where} ({mode}, {width}x{height}): launches of its two steps {m['launches']}; "
                    + ("frames bit-equal to a one-process vz = 1 renderer's; " if pid == 0 else "")
                    + "steps across the processes " + ", ".join(f"{v:.3f}" for v in m["step_ms"]) + " ms"
                    + ("; in turns with one-process vz = 2 " + ", ".join(f"{v:.3f}" for v in m["vz2_ms"])
                       + " ms and vz = 1 " + ", ".join(f"{v:.3f}" for v in m["vz1_ms"]) + " ms" if pid == 0 else ""))
                for leg, t in m["held"].items():
                    ms = m["kernel_ms"][leg]
                    log(f"{where} ({mode}): {leg} through the table holding the mapped slab bit-equal to its plain "
                        f"version on every {NODE_LANE_STRIDE}th lane of all {t['calls']} calls ({t['lanes']} lanes); "
                        f"kernel " + ", ".join(f"{v:.4f}" for v in ms["mapped"]) + " ms at its first call"
                        + (", the one-process slab form at the same lanes " + ", ".join(f"{v:.4f}" for v in ms["own"])
                           + " ms (in turns)" if ms["own"] else ""))
            if (not rec["swaps_equal"] or len(rec["swaps_mapped"]) != 1
                    or (cuda and not rec["swaps_delta_bytes"] < rec["slab_bytes"] <= rec["close_freed_bytes"])):
                raise SystemExit(f"{where}: the timestep swaps: bit-equal {rec['swaps_equal']}, mapped "
                                 f"{rec['swaps_mapped']}, device bytes they left {rec['swaps_delta_bytes']}, "
                                 f"close() freed {rec['close_freed_bytes']} (a slab is {rec['slab_bytes']})")
            log(f"{where}: {NODE_SWAPS} timestep swaps of two steps each in {rec['swaps_s']:.3f} s, no host sync "
                + ("of the caller's, frames bit-equal to vz = 1's" if pid == 0 else "of the caller's")
                + f"; device bytes they left beyond the new fields and the kept frames {rec['swaps_delta_bytes']}"
                f" (each swap freed the slab it replaced); close() freed {rec['close_freed_bytes']}; "
                f"{rec['seconds']:.1f} s in all")
    if len(runs) == 1:
        log("vz = 2 across two processes on two cards: skipped, the machine has one card")
    log(f"phase 2f (slabs across the processes of a node): {time.perf_counter() - t_phase:.1f} s")
    return within


# phase 2g: a vz row across nodes (parallel/migrate.py), rehearsed on one
# machine: the processes are fed two node identities, so no process can load
# a slab of the other "node"; a lane that reaches one parks, moves to the
# slab's owner and is resumed there by the leg's park form
CROSS_NODES = ("host-A/fed", "host-B/fed")
CROSS_STEPS = 2  # counted steps a mode across the nodes, each one sample
CROSS_ROUNDS = 2  # timed rounds a mode: a step across the nodes, then vz = 1 in one process
CROSS_LANE_STRIDE = 16  # the held park forms' lanes: every 16th lane of each call
CROSS_WORKER_TIMEOUT = 300.0  # seconds, each process
MIXED_SIZE, MIXED_DIMS = 256, (960, 540)  # the [A, A, B, B] layout's volume and frame


@contextlib.contextmanager
def held_park_forms(stride: int):
    """While the block runs, each park form that parallel.migrate calls
    also runs its CUDA wrapper and its plain version on every `stride`-th
    lane of the call: fails unless the two agree bit for bit on every
    output and the wrapper's equals the call's own there. Yields {leg:
    tally}: calls, lanes held, lanes parked, and each leg's first call (its
    field and arguments, as migrate.Row.leg_call got them)."""
    import torch

    from volxel_tpu_torch.parallel import migrate
    from volxel_tpu_torch.render import ddaleg, tilemarch, trackleg

    modules = {"dda": ddaleg, "track": trackleg, "tile": tilemarch}
    tallies = {name: {"calls": 0, "lanes": 0, "parked": 0, "first": None} for name in migrate.LEGS}
    originals = {leg.park: getattr(migrate, leg.park) for leg in migrate.LEGS.values()}
    leg_call = migrate.Row.leg_call

    def recorded(row, name, field, *args):
        if tallies[name]["first"] is None:
            tallies[name]["first"] = (field, args)
        return leg_call(row, name, field, *args)

    def held(name, leg):
        module = modules[name.split("_")[0]]
        cuda_fn, plain_fn = getattr(module, f"{leg.park}_cuda"), getattr(module, f"{leg.park}_plain")
        at = leg.park_args.index("ipos") + 1

        def call(*args):
            got = originals[leg.park](*args)
            n = args[at].shape[0]
            sub = tuple(a[::stride].contiguous() if i and isinstance(a, torch.Tensor) and a.dim() and a.shape[0] == n
                        else a for i, a in enumerate(args))
            kernel, plain = cuda_fn(*sub), plain_fn(*sub)
            bad = [nm for nm, k, w, full in zip(leg.outs, kernel, plain, got)
                   if not (bits_equal(k, w) and bits_equal(k, full[::stride]))]
            tally = tallies[name]
            if bad:
                raise SystemExit(f"{leg.park} across nodes, call {tally['calls']}: {bad} differ on every {stride}th "
                                 f"lane (max abs {max_abs(kernel, plain)})")
            tally["calls"] += 1
            tally["lanes"] += sub[at].shape[0]
            tally["parked"] += int((got[-1] >= 0).sum())
            return got
        return call

    migrate.Row.leg_call = recorded
    for name, leg in migrate.LEGS.items():
        setattr(migrate, leg.park, held(name, leg))
    try:
        yield tallies
    finally:
        migrate.Row.leg_call = leg_call
        for park, fn in originals.items():
            setattr(migrate, park, fn)


def park_times(held: dict, whole) -> dict:
    """Each leg's park form at its first call (held_park_forms), timed by
    device_ms beside its plain park form; with `whole` (a SlabGrid of every
    slab, on this card), its slab form at the same lanes, in turns (park,
    slab, slab, park), and the slab form's bytes and operations
    (slab_work). {leg: {"park": [ms, ms], "plain": ms, "slab": [ms, ms] or
    None, "bytes", "ops"}}."""
    from volxel_tpu_torch.parallel import migrate
    from volxel_tpu_torch.render import ddaleg, tilemarch, trackleg

    modules = {"dda": ddaleg, "track": trackleg, "tile": tilemarch}
    out = {}
    for name, tally in held.items():
        if tally["first"] is None:
            continue
        field, args = tally["first"]
        leg = migrate.LEGS[name]
        module = modules[name.split("_")[0]]
        consts, lanes = migrate.home_lanes(leg, args)
        park_args = migrate.park_args(leg, consts, lanes)
        park_fn = getattr(module, f"{leg.park}_cuda")
        rec = {"slab": None, "bytes": 0, "ops": 0}
        rec["plain"] = device_ms(lambda: getattr(module, f"{leg.park}_plain")(field, *park_args))[1]
        park = [device_ms(lambda: park_fn(field, *park_args), KERNEL_REPS)[1]]
        if whole is not None:
            slab_fn = getattr(module, f"{name}_cuda")
            got, ms = device_ms(lambda: slab_fn(whole, *args), KERNEL_REPS)
            rec["slab"] = [ms, device_ms(lambda: slab_fn(whole, *args), KERNEL_REPS)[1]]
            rec["bytes"], rec["ops"] = slab_work(name)((whole, *args), got)
        park.append(device_ms(lambda: park_fn(field, *park_args), KERNEL_REPS)[1])
        rec["park"] = park
        out[name] = rec
    return out


def cross_worker(addr: str, pid: int, size: int, width: int, height: int, cards: tuple, nodes: tuple) -> None:
    """One of phase 2g's processes: process p on device cards[p], fed node
    identity nodes[p], joined over gloo where processes share a card (NCCL
    refuses that) and over NCCL where each has its own; it renders its part
    of a (1, 1, len(cards)) row whose slabs on the other node are absent.
    Rank 0 holds a vz = 1 renderer (and, on the two-process layout, a
    one-process renderer of the row's slabs) beside it. On two processes
    it also holds the park forms on strided lanes and times them. Prints
    one JSON line: the load, each mode's launches and leg calls (lanes
    parked, moved and returned, rounds, bytes sent), frames bit-equal to
    vz = 1, step ms in turns, the held park forms and their ms."""
    import torch

    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.grid import construct_brick_grid
    from volxel_tpu_torch.parallel import initialize_multihost, make_mesh, migrate, multihost
    from volxel_tpu_torch.parallel.distributed import DistributedRenderer
    from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume
    from volxel_tpu_torch.utils.profiling import fence_device

    t0 = time.perf_counter()
    count = len(cards)
    device = torch.device(cards[pid])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    backend = "gloo" if len(set(cards)) < count else "nccl"
    if not initialize_multihost(addr, count, pid, backend=backend):
        raise SystemExit("cross worker: initialize_multihost did not join the group")
    found = list(multihost._node_ids)
    multihost._node_ids[:] = list(nodes)  # fed: every process runs on this one machine
    vol = synthetic_ct_volume((size,) * 3, bits_stored=12, seed=0)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    del vol
    mesh = make_mesh(sp=1, px=1, vz=count, devices=list(enumerate(cards)))
    r = DistributedRenderer(width, height, mesh=mesh, device=device)

    def allocated():
        return torch.cuda.memory_allocated(device) if cuda else 0

    fence_device(device)
    base = allocated()
    r.restart_from_grid(grid)
    fence_device(device)
    slab_grid = r._slabbed.local_grid()
    rec = {"pid": pid, "device": str(device), "backend": torch.distributed.get_backend(), "found_nodes": found,
           "fed_nodes": list(nodes), "held_bytes": allocated() - base,
           "absent": [v for v, s in enumerate(slab_grid.slabs) if s is None],
           "mapped": sorted((str(c), v) for c, v in r._slabbed.mapped), "row": slab_grid.row is not None}
    del slab_grid
    r.settings.bounces = 1
    bench_look(r)
    full = count == 2
    reps = {}
    if pid == 0:
        for vz in (1, count) if full else (1,):
            reps[vz] = DistributedRenderer(width, height, mesh=make_mesh(sp=1, px=1, vz=vz, devices=[(0, device)] * vz),
                                           device=device)
            reps[vz].restart_from_grid(grid)
            reps[vz].settings.bounces = 1
            bench_look(reps[vz])
    rec["setup_s"] = time.perf_counter() - t0
    rec["modes"] = {}
    for mode in MODE_LEGS:
        out = rec["modes"][mode] = {}
        for x in (r, *reps.values()):
            x.render_mode = mode
        kernels.reset_launch_counts()
        migrate.CALLS.clear()
        for _ in range(CROSS_STEPS):
            r.render_frame()
        fence_device(device)
        out["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        out["calls"] = [[c[k] for k in ("leg", "lanes", "running", "parked", "moved", "returned", "rounds", "bytes")]
                        for c in migrate.CALLS]
        if pid == 0:
            for _ in range(CROSS_STEPS):
                reps[1].render_frame()
        out["equal"] = pid != 0 or bits_equal(r._framebuffer, reps[1]._framebuffer)
        out["step_ms"], out["vz1_ms"] = [], []
        for _ in range(CROSS_ROUNDS):  # in turns: the others wait at the barrier while rank 0 runs vz = 1
            multihost.host_barrier()
            out["step_ms"].append(fenced_ms(r.render_frame, device)[1])
            if pid == 0:
                out["vz1_ms"].append(fenced_ms(reps[1].render_frame, device)[1])
        multihost.host_barrier()
        out["equal_after_rounds"] = pid != 0 or bits_equal(r._framebuffer, reps[1]._framebuffer)
        if not full:
            continue
        saved = dict(kernels.LAUNCHES)
        with held_park_forms(CROSS_LANE_STRIDE) as held:
            r.render_frame()
        out["held"] = {leg: {k: t[k] for k in ("calls", "lanes", "parked")} for leg, t in held.items()
                       if t["calls"]}
        out["kernel_ms"] = {}
        for turn in range(count):  # each process times its park forms while the others wait
            multihost.host_barrier()
            if turn == pid:
                whole = reps[count]._render_grid().local_grid() if pid == 0 else None
                out["kernel_ms"] = park_times(held, whole)
                del whole
        multihost.host_barrier()
        del held  # its first calls' arguments hold the slabs
        kernels.LAUNCHES.update(saved)  # the holds' launches are not the path's
        if pid == 0:
            reps[1].render_frame()  # keep the step counts level with r's
    r.close()
    rec["seconds"] = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)
    torch.distributed.destroy_process_group()


def cross_processes(size: int, width: int, height: int, cards: tuple, nodes: tuple) -> list[dict]:
    """Phase 2g's processes (cross_worker), one a card of `cards` with the
    fed node identities `nodes`; fails unless all exit 0."""
    return worker_pair(lambda addr, pid: ["--cross-worker", addr, str(pid), ",".join(cards), ",".join(nodes)], size,
                       width, height, CROSS_WORKER_TIMEOUT, f"cross worker on {cards}", count=len(cards))


def cross_node_path(size: int, width: int, height: int, within: dict) -> list[dict]:
    """Phase 2g: a vz = 2 row across two fed nodes on the card (and over
    cuda:0 and cuda:1 on NCCL where the machine has two cards), then four
    processes [A, A, B, B] at MIXED_SIZE and MIXED_DIMS on the card (and
    over cuda:0-3 on NCCL where the machine has four cards). Fails unless each
    process finds the other node's slabs absent and maps no slab across
    nodes (its node mate's only), launches every park form of each mode and
    no other form of its legs, rank 0's frames are bit-equal to vz = 1's in
    every mode, lanes moved, and every held park form is bit-equal to its
    plain version. Prints each leg call's lanes parked, moved and returned,
    rounds and bytes, the step ms beside phase 2f's (`within`) and vz = 1,
    the park forms' kernel ms beside the slab forms' at the same lanes.
    Returns the park forms' entries of the JSON line (the one-card pair's
    rank 0)."""
    import torch

    from volxel_tpu_torch.parallel import migrate

    t_phase = time.perf_counter()
    runs = [(("cuda:0", "cuda:0"), CROSS_NODES, size, width, height)]
    if torch.cuda.device_count() >= 2:
        runs.append((("cuda:0", "cuda:1"), CROSS_NODES, size, width, height))
    mixed = (CROSS_NODES[0],) * 2 + (CROSS_NODES[1],) * 2
    runs.append((("cuda:0",) * 4, mixed, MIXED_SIZE, *MIXED_DIMS))
    if torch.cuda.device_count() >= 4:
        runs.append((tuple(f"cuda:{i}" for i in range(4)), mixed, MIXED_SIZE, *MIXED_DIMS))
    entries = []
    for cards, nodes, sz, w, h in runs:
        count = len(cards)
        recs = cross_processes(sz, w, h, cards, nodes)
        moved = sum(c[4] for rec in recs for m in rec["modes"].values() for c in m["calls"])
        for rec in recs:
            pid = rec["pid"]
            where = f"vz = {count} across fed nodes {nodes} on {','.join(cards)} ({rec['backend']}), process {pid}"
            other = [v for v in range(count) if nodes[v] != nodes[pid]]
            mates = [v for v in range(count) if nodes[v] == nodes[pid] and v != pid]
            if (rec["absent"] != other or [v for _, v in rec["mapped"]] != mates or not rec["row"]
                    or len(set(rec["found_nodes"])) != 1):
                raise SystemExit(f"{where}: absent slabs {rec['absent']} (expected {other}), mapped {rec['mapped']} "
                                 f"(expected {mates}), row {rec['row']}, nodes found {rec['found_nodes']}")
            log(f"{where}: one machine ({rec['found_nodes'][0]}), node identities fed {rec['fed_nodes']}; slabs "
                f"absent {rec['absent']}, mapped within the node {rec['mapped']}; device bytes after the load "
                f"{rec['held_bytes']}; setup {rec['setup_s']:.2f} s")
            for mode, legs in MODE_LEGS.items():
                m = rec["modes"][mode]
                launched = m["launches"]
                wrong = {leg: [launched.get(f"{leg}{form}", 0) for form in ("", "_slabs", "_slabs_park")]
                         for leg in legs if launched.get(leg, 0) or launched.get(f"{leg}_slabs", 0)
                         or launched.get(f"{leg}_slabs_park", 0) < CROSS_STEPS}
                if wrong or not (m["equal"] and m["equal_after_rounds"]):
                    raise SystemExit(f"{where} ({mode}): legs launched (dense, slab, park form) {wrong}; frames "
                                     f"bit-equal to vz = 1: {m['equal']}, after the rounds {m['equal_after_rounds']}")
                if count == 2 and (set(m["held"]) != set(legs) or any(t["calls"] == 0 for t in m["held"].values())):
                    raise SystemExit(f"{where} ({mode}): a park form was not held: {m['held']}")
                log(f"{where} ({mode}, {w}x{h}): launches of its {CROSS_STEPS} steps {launched}"
                    + ("; frames bit-equal to a one-process vz = 1 renderer's" if pid == 0 else ""))
                for leg, lanes, running, parked, sent, returned, rounds, nbytes_sent in m["calls"]:
                    log(f"{where} ({mode}) {leg} call: {lanes} lanes, {running} running, {parked} parked here "
                        f"({parked / max(running, 1):.4f} of the running), {sent} moved and {returned} returned by "
                        f"this process, {rounds} rounds, {nbytes_sent} bytes sent")
                log(f"{where} ({mode}): steps across the nodes " + ", ".join(f"{v:.3f}" for v in m["step_ms"])
                    + " ms" + ("; in turns with one-process vz = 1 " + ", ".join(f"{v:.3f}" for v in m["vz1_ms"])
                               + " ms" if pid == 0 else "")
                    + ("; phase 2f's within-node step " + ", ".join(f"{v:.3f}" for v in within.get(mode, []))
                       + " ms" if pid == 0 and cards == runs[0][0] else ""))
                for leg, t in m.get("held", {}).items():
                    k = m["kernel_ms"][leg]
                    log(f"{where} ({mode}): {leg}'s park form bit-equal to its plain version on every "
                        f"{CROSS_LANE_STRIDE}th lane of all {t['calls']} calls ({t['lanes']} lanes held, "
                        f"{t['parked']} lanes parked in those calls); at its first call kernel "
                        + ", ".join(f"{v:.4f}" for v in k["park"]) + f" ms, plain {k['plain']:.4f} ms"
                        + (", the slab form at the same lanes on every slab " + ", ".join(f"{v:.4f}" for v in k["slab"])
                           + f" ms (in turns); bound {bound(k['bytes'], k['ops'])['bound_ms']:.4f} ms"
                           if k["slab"] else ""))
                    if pid == 0 and cards == runs[0][0]:
                        src, replaces = SLAB_LEG_SOURCES[leg]
                        e = entry(f"{leg}_slabs_park", f"volxel_tpu_torch/csrc/{src}", replaces, 0.0,
                                  min(k["park"]), k["plain"], k["bytes"], k["ops"])
                        e["launches"] = launched[f"{leg}_slabs_park"]
                        entries.append(e)
            log(f"{where}: {rec['seconds']:.1f} s in all")
        if moved == 0:
            raise SystemExit(f"vz = {count} across fed nodes on {cards}: no lane moved")
    if torch.cuda.device_count() < 2:
        log("vz = 2 across fed nodes on two cards: skipped, the machine has one card")
    if torch.cuda.device_count() < 4:
        log("[A, A, B, B] across fed nodes on four cards over NCCL: skipped, the machine has "
            f"{torch.cuda.device_count()} card(s)")
    if len(entries) != len(migrate.LEGS):
        raise SystemExit(f"phase 2g: park-form entries for {[e['name'] for e in entries]} only")
    log(f"phase 2g (slabs across nodes, fed identities on one machine): {time.perf_counter() - t_phase:.1f} s")
    return entries


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512, help="volume edge in voxels")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--parity-size", type=int, default=64)
    ap.add_argument("--mesh-worker", nargs=2, metavar=("ADDR", "PID"), help=argparse.SUPPRESS)
    ap.add_argument("--mesh-nccl", metavar="ADDR", help=argparse.SUPPRESS)
    ap.add_argument("--node-worker", nargs=3, metavar=("ADDR", "PID", "DEVICES"), help=argparse.SUPPRESS)
    ap.add_argument("--cross-worker", nargs=4, metavar=("ADDR", "PID", "DEVICES", "NODES"), help=argparse.SUPPRESS)
    ap.add_argument("--cross-nodes-only", action="store_true",
                    help="build the kernels and run phase 2g alone (its NCCL runs need two and four cards)")
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

    if args.mesh_worker:  # one of phase 2d's two processes
        mesh_worker(args.mesh_worker[0], int(args.mesh_worker[1]), args.size, args.width, args.height)
        return 0
    if args.mesh_nccl:  # phase 2d's NCCL process group of one
        nccl_world_of_one(args.mesh_nccl, args.width, args.height)
        return 0
    if args.node_worker:  # one of phase 2f's two processes
        addr, pid, cards = args.node_worker
        node_worker(addr, int(pid), args.size, args.width, args.height, tuple(cards.split(",")))
        return 0
    if args.cross_worker:  # one of phase 2g's processes
        addr, pid, cards, nodes = args.cross_worker
        cross_worker(addr, int(pid), args.size, args.width, args.height, tuple(cards.split(",")),
                     tuple(nodes.split(",")))
        return 0

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
    if args.cross_nodes_only:
        cross_node_path(args.size, args.width, args.height, {})
        print(json.dumps({"ok": True, "phases": ["2g"], "device": {"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
        return 0
    sass, sass_bodies, registers = check_sass()

    t0 = time.perf_counter()
    vol = synthetic_ct_volume((args.size,) * 3, bits_stored=12, seed=0)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    del vol
    log(f"scene: {args.size}^3 synthetic CT volume, brick grid built in {time.perf_counter() - t0:.2f} s")

    with tempfile.TemporaryDirectory(prefix="volxel_smoke_") as tmpdir:
        # phase 2b: ingest and the reference benchmark, through the entry points
        zip_path, env_path = ingest_and_reference_benchmark(args.size, ENV_SIZE, args.width, args.height,
                                                            REFERENCE_SPEC, Path(tmpdir))
        torch.cuda.empty_cache()
        # phase 2c: the app path, with the counters at 0 before the server's
        app_server(zip_path, env_path)
        torch.cuda.empty_cache()
        gradient_and_debug_hits(grid, args.width, args.height)
        cli_path(Path(tmpdir))
    torch.cuda.empty_cache()
    # phase 2d: the mesh, with the counters at 0 before the 2x2 mesh's steps
    mesh_path(grid, args.size, args.width, args.height)
    # phase 2e: render-time volume slabs, with the counters at 0 before it
    slab_launches, slab_tallies = slab_path(grid, args.width, args.height, sass, registers)
    torch.cuda.empty_cache()
    # phase 2f: a vz row across two processes, each with the counters at 0 before its steps
    within = node_slab_path(args.size, args.width, args.height)
    # phase 2g: a vz row across two fed nodes, each process with the counters at 0 before its steps
    park_entries = cross_node_path(args.size, args.width, args.height, within)

    # phase 3: each kernel against its plain version at the main paths' shapes
    r = bench_renderer(grid, args.width, args.height, "cuda")
    check_neg_log1m()
    results = [*check_legs(r, sass_bodies["dda_leg.cu"], registers["dda_leg.cu"]), *check_track_legs(r, sass_bodies["track_leg.cu"], registers["track_leg.cu"]),
               *check_gather(r), check_pyramid(r), check_tonemap(r.settings.exposure, r.settings.gamma, sass),
               check_shearwarp(r), *check_rng(args.width, args.height), *check_env(r, args.width, args.height)]
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
    results += slab_entries(slab_launches, slab_tallies) + park_entries
    torch.cuda.empty_cache()

    # phase 5: card against CPU at a small size, in every mode and the preview
    for mode in ("default", "raymarch", "no_dda"):
        parity(grid, args.parity_size, mode)
        parity(grid, args.parity_size, mode, "gradient_shading")
        parity(grid, args.parity_size, mode, "debug_hits")
    preview_parity(grid, args.parity_size)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in results]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
