#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from volxel_tpu_torch/csrc and print the time;
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes, and time both with CUDA events:
   - the DDA march at every call of one 1080p default-mode sample of the
     512^3 scene (bit-equal on every output of every lane), its summed
     event time beside the torch.profiler device time of the same sample;
   - the importance pyramid on the default environment's 512^2 base (rtol
     1e-6) and the tonemap on a 1920x1080x3 buffer (atol 1e-6);
   - the raymarch step loop at every call of one 1080p raymarch sample
     (bit-equal on state, hit, t and rgb of every lane), and the
     nearest-tap sums on that sample's camera rays at 64 steps (bit-equal);
4. run the main paths through the Renderer: the 512^3 synthetic CT volume
   in the benchmark framing (bench.py), 1920x1080, 5 warm-up + 3
   accumulated frames, then image(), in the default mode and in the
   raymarch mode, each with every launch counter at 0 before it; check the
   output and that every kernel of the path launched; in both modes split
   one sample into its camera and shadow legs and profile one; time one
   1080p no_dda frame;
5. render the same scene at 64x64 on the card and on the CPU (plain
   versions) in each of the three modes and hold the images to the parity
   contract of tests/test_parity_oracle.py.

The second-to-last line is a JSON object with one entry per kernel, the
last line {"ok": true, "device": {...}}. Without a CUDA device, or without
the volxel_tpu_torch package beside it, the script fails before printing
any result.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
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
# spread over them (the DDA march's calls take ~30 us on average at 1080p)
KERNEL_REPS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_renderer(grid, width: int, height: int, device, mode: str = "default"):
    from volxel_tpu_torch import Renderer

    r = Renderer(width, height, device=device)
    r.restart_from_grid(grid)
    r.render_mode = mode
    r.camera.rotate_around_view(0.6, 0.4)
    r.camera.zoom(2.0)
    r.settings.bounces = 1
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


def profiled_device_ms(fn, name: str) -> float:
    """Summed device time (ms) of the kernels whose name contains `name`
    over one call of `fn`, read by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages() if name in e.key) / 1000


def bits_equal(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs(got, want) -> float:
    """Largest |difference| over the outputs; lanes outside the box carry
    NaN/inf through unchanged, so those count as 0."""
    return max(float((a.double() - b.double()).abs().nan_to_num(0.0).max()) for a, b in zip(got, want))


def sample_operands(r):
    config = r._config()
    inv_view, inv_proj, light_dir = r._camera_operands(config)
    return (config, r._device_grid, r.volume_params(), r._lut, r.environment.state, inv_view, inv_proj, light_dir)


def check_every_call(r, name: str, cuda_fn, plain_fn, outputs, lanes_arg: int) -> dict:
    """Render one sample of `r` with modes.<name> replaced by a stand-in
    that sends each call's inputs through the kernel and the plain version,
    raises unless they agree bit for bit on every output of every lane, and
    returns the kernel's result. Returns the tally: calls, the lanes counted
    by the bool argument `lanes_arg`, the times summed over the calls, the
    largest difference, and the first call's arguments. The plain versions
    synchronize at every step (to test whether any lane still runs), so
    their time includes the host's share."""
    import volxel_tpu_torch.render.modes as modes
    from volxel_tpu_torch.render.pathtrace import render_sample

    tally = {"calls": 0, "lanes": 0, "ms": 0.0, "plain_ms": 0.0, "err": 0.0, "first_args": None}

    def compared(*args):
        got, ms = device_ms(lambda: cuda_fn(*args), KERNEL_REPS)
        want, plain_ms = device_ms(lambda: plain_fn(*args))
        bad = [nm for nm, a, b in zip(outputs, got, want) if not bits_equal(a, b)]
        err = max_abs(got, want)
        if bad:
            raise SystemExit(f"{name} call {tally['calls']}: kernel differs from its plain version "
                             f"in {bad} (max abs {err})")
        tally["calls"] += 1
        tally["lanes"] += int(args[lanes_arg].sum())
        tally["ms"] += ms
        tally["plain_ms"] += plain_ms
        tally["err"] = max(tally["err"], err)
        if tally["first_args"] is None:
            tally["first_args"] = args
        return got

    operands = sample_operands(r)
    original = getattr(modes, name)
    setattr(modes, name, compared)
    try:
        render_sample(*operands, 0)
    finally:
        setattr(modes, name, original)
    config = operands[0]
    log(f"{name}: bit-equal at all {tally['calls']} calls of one {config.width}x{config.height} {config.mode} "
        f"sample ({tally['lanes']} lanes in all); kernel {tally['ms']:.4f} ms, plain {tally['plain_ms']:.4f} ms "
        f"summed over the calls")
    return tally


def check_march(r) -> dict:
    """K1 at every call of one full 1080p sample (camera march and NEE
    shadow marches; lanes counted: the running ones), and its summed event
    time beside the profiler's device time of the same sample."""
    from volxel_tpu_torch.render.pathtrace import render_sample
    from volxel_tpu_torch.render.pyrmarch import pyr_march_cuda, pyr_march_plain

    tally = check_every_call(r, "pyr_march", pyr_march_cuda, pyr_march_plain,
                             ("t", "tau", "mip", "maj", "kind", "budget"), 10)
    operands = sample_operands(r)
    prof_ms = profiled_device_ms(lambda: render_sample(*operands, 0), "pyr_march_kernel")
    log(f"pyr_march: summed event time {tally['ms']:.4f} ms, profiler device time {prof_ms:.4f} ms over the same "
        f"sample (event/profiler {tally['ms'] / max(prof_ms, 1e-9):.3f})")
    return {"name": "pyr_march", "route": "cuda", "source": "volxel_tpu_torch/csrc/pyr_march.cu",
            "replaces": "volxel_tpu/render/pyrmarch.py:313", "max_abs_err": tally["err"],
            "ms": tally["ms"], "plain_ms": tally["plain_ms"]}


def check_pyramid(r) -> dict:
    """K3 on the default environment's 512^2 importance base."""
    import torch

    from volxel_tpu_torch.render.pallas_ops import build_importance_pyramid_cuda, build_importance_pyramid_plain

    base = r.environment.state.imp_mips[0]
    got = build_importance_pyramid_cuda(base)
    want = build_importance_pyramid_plain(base)
    torch.cuda.synchronize()
    err = 0.0
    for a, b in zip(got, want):
        if not torch.allclose(a, b, rtol=1e-6, atol=0.0):
            raise SystemExit(f"importance pyramid level {tuple(a.shape)} differs beyond rtol 1e-6")
        err = max(err, float((a - b).abs().max()))
    _, ms = device_ms(lambda: build_importance_pyramid_cuda(base), 50)
    _, plain_ms = device_ms(lambda: build_importance_pyramid_plain(base), 50)
    log(f"importance_pyramid: within rtol 1e-6 (max abs {err:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "importance_pyramid", "route": "cuda",
            "source": "volxel_tpu_torch/csrc/importance_pyramid.cu",
            "replaces": "volxel_tpu/render/pallas_ops.py:60", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms}


def check_tonemap(exposure: float, gamma: float) -> dict:
    """K4 on a 1920x1080x3 buffer of seeded radiances."""
    import torch

    from volxel_tpu_torch.render.pallas_ops import tonemap_cuda, tonemap_plain

    fb = np.random.default_rng(1).uniform(0.0, 4.0, (1920 * 1080, 3)).astype(np.float32)
    fb = torch.from_numpy(fb).cuda()
    got = tonemap_cuda(fb, exposure, gamma)
    want = tonemap_plain(fb, exposure, gamma)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= 1e-6:
        raise SystemExit(f"tonemap kernel differs from its plain version by {err} > 1e-6")
    _, ms = device_ms(lambda: tonemap_cuda(fb, exposure, gamma), 50)
    _, plain_ms = device_ms(lambda: tonemap_plain(fb, exposure, gamma), 50)
    log(f"tonemap: within atol 1e-6 (max abs {err:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "tonemap", "route": "cuda", "source": "volxel_tpu_torch/csrc/tonemap.cu",
            "replaces": "volxel_tpu/render/pallas_ops.py:115", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms}


def check_tile_march(r) -> list[dict]:
    """K5 at every call of one 1080p raymarch sample (the camera leg of
    each bounce; lanes counted: those inside the box), bit-equal on state,
    hit, t and rgb of every lane, and K6 on that sample's camera rays at 64
    steps, bit-equal."""
    from volxel_tpu_torch.render.tilemarch import (
        STEPS,
        tile_march_sample_cuda,
        tile_march_sample_plain,
        tile_march_sums_cuda,
        tile_march_sums_plain,
    )

    tally = check_every_call(r, "tile_march_sample", tile_march_sample_cuda, tile_march_sample_plain,
                             ("state", "hit", "t", "rgb"), 6)
    sample = {"name": "tile_march_sample", "route": "cuda", "source": "volxel_tpu_torch/csrc/tile_march.cu",
              "replaces": "volxel_tpu/render/tilemarch.py:627", "max_abs_err": tally["err"], "ms": tally["ms"],
              "plain_ms": tally["plain_ms"]}

    dense, ipos, idir, start, dt, far, valid, _, _, _, _, extent = tally["first_args"]
    args = (dense, ipos, idir, start, dt, far, valid, extent, STEPS)
    got, ms = device_ms(lambda: tile_march_sums_cuda(*args), KERNEL_REPS)
    want, plain_ms = device_ms(lambda: tile_march_sums_plain(*args))
    err = max_abs([got], [want])
    if not bits_equal(got, want):
        raise SystemExit(f"tile_march_sums differs from its plain version (max abs {err})")
    log(f"tile_march_sums: bit-equal on the {ipos.shape[0]} camera rays of that sample at {STEPS} steps "
        f"(mean sum {float(got.mean()):.4f}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    sums = {"name": "tile_march_sums", "route": "cuda", "source": "volxel_tpu_torch/csrc/tile_march.cu",
            "replaces": "volxel_tpu/render/tilemarch.py:293", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return [sample, sums]


# the kernels each mode's main path must launch
PATH_KERNELS = {
    "default": ("pyr_march", "importance_pyramid", "tonemap"),
    "raymarch": ("tile_march_sample", "importance_pyramid", "tonemap"),
}


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
    per_sample = {k: (kernels.LAUNCHES[k] - launches_before[k]) / ACCUMULATED_FRAMES for k in PATH_KERNELS[mode][:1]}
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
    log(f"main path output ({mode}): mean radiance {mean:.6f}, image mean {float(img.mean()):.6f}")
    return launches


def breakdown(grid, width: int, height: int, mode: str) -> None:
    """One sample with a synchronize around each leg (the mode's
    sample_volume and transmittance), then one unprofiled and one profiled
    sample: device busy time, idle share and the largest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import volxel_tpu_torch.render.pathtrace as pathtrace

    r = bench_renderer(grid, width, height, "cuda", mode)
    r.render_frame()  # warm
    legs = {"camera": 0.0, "shadow": 0.0}

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            legs[name] += (time.perf_counter() - t0) * 1000
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
    log(f"{mode} legs: one sample {total:.3f} ms with a synchronize around each leg: camera leg "
        f"{legs['camera']:.3f} ms, shadow leg {legs['shadow']:.3f} ms, rest {total - legs['camera'] - legs['shadow']:.3f} ms")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render_frame()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1000
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r.render_frame()
        torch.cuda.synchronize()
    # device-side events only: a CPU op's device time repeats its kernels'
    device = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    busy = sum(e.device_time_total for e in device) / 1000
    count = sum(e.count for e in device)
    top = sorted(device, key=lambda e: -e.device_time_total)[:4]
    log(f"{mode} profile: one sample, {count} device kernels, device busy {busy:.3f} ms against an unprofiled "
        f"sample of {wall:.3f} ms (idle share {1 - busy / wall:.3f}); largest: "
        + "; ".join(f"{e.key[:70]} {e.device_time_total / 1000:.3f} ms x{e.count}" for e in top))


def no_dda_frame(grid, width: int, height: int) -> None:
    """One 1080p no_dda frame (delta and ratio tracking in PyTorch; no
    kernel of this repo runs in that mode's traversal)."""
    import torch

    r = bench_renderer(grid, width, height, "cuda", "no_dda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fb = r.render_frame()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000
    mean = float(fb.mean())
    if not (bool(torch.isfinite(fb).all()) and mean > 0.0):
        raise SystemExit(f"no_dda frame not finite or mean radiance {mean} <= 0")
    log(f"no_dda: one {width}x{height} frame {ms:.3f} ms, mean radiance {mean:.6f}")


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

    t0 = time.perf_counter()
    vol = synthetic_ct_volume((args.size,) * 3, bits_stored=12, seed=0)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    del vol
    log(f"scene: {args.size}^3 synthetic CT volume, brick grid built in {time.perf_counter() - t0:.2f} s")

    # phase 3: each kernel against its plain version at the main paths' shapes
    r = bench_renderer(grid, args.width, args.height, "cuda")
    results = [check_march(r), check_pyramid(r), check_tonemap(r.settings.exposure, r.settings.gamma)]
    del r
    r = bench_renderer(grid, args.width, args.height, "cuda", "raymarch")
    results += check_tile_march(r)
    del r
    torch.cuda.empty_cache()

    # phase 4: the main paths, each with the counters at 0 before it
    launches = {"default": main_path(grid, args.width, args.height, "default")}
    torch.cuda.empty_cache()
    launches["raymarch"] = main_path(grid, args.width, args.height, "raymarch")
    for entry in results:
        # K6 lies on no render path: its count from either run is 0
        mode = "raymarch" if entry["name"].startswith("tile_march") else "default"
        entry["launches"] = launches[mode][entry["name"]]
    for mode in ("default", "raymarch"):
        breakdown(grid, args.width, args.height, mode)
    no_dda_frame(grid, args.width, args.height)
    torch.cuda.empty_cache()

    # phase 5: card against CPU at a small size, in every mode
    for mode in ("default", "raymarch", "no_dda"):
        parity(grid, args.parity_size, mode)

    kinds = [
        {k: e[k] for k in ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")}
        for e in results
    ]
    print(json.dumps({"kernels": kinds}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
