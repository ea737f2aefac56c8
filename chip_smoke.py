#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from volxel_tpu_torch/csrc and print the time;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes — the DDA march at every call of one 1080p sample of
   the 512^3 scene (bit-equal on every output of every lane), the importance
   pyramid on the default environment's 512^2 base (rtol 1e-6), the
   tonemap on a 1920x1080x3 buffer (atol 1e-6) — and time both with CUDA
   events;
4. run the main path through the Renderer: the 512^3 synthetic CT volume in
   the benchmark framing (bench.py), 1920x1080, 5 warm-up + 3 accumulated
   frames, then image(); check the output and that every kernel launched;
5. render the same scene at 64x64 on the card and on the CPU (plain
   versions) and hold the images to the parity contract of
   tests/test_parity_oracle.py.

The second-to-last line is a JSON object with one entry per kernel, the
last line {"ok": true, "device": {...}}. Without a CUDA device, or without
the volxel_tpu_torch package beside it, the script fails before printing
any result.
"""

from __future__ import annotations

import argparse
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


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_renderer(grid, width: int, height: int, device):
    from volxel_tpu_torch import Renderer

    r = Renderer(width, height, device=device)
    r.restart_from_grid(grid)
    r.camera.rotate_around_view(0.6, 0.4)
    r.camera.zoom(2.0)
    r.settings.bounces = 1
    r.set_transfer_colors(BENCH_TRANSFER)
    r.settings.sample_range = list(BENCH_SAMPLE_RANGE)
    r.restart_rendering()
    return r


# a device-side spin queued ahead of a timed region, so the host has
# enqueued the region's launches before the card reaches its start event
# and the events measure device time, not launch latency (~0.5 ms at the
# H100's 1980 MHz boost clock)
PRE_ROLL_CYCLES = 1_000_000


def time_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` calls, by CUDA events, after a
    warm-up call and a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(PRE_ROLL_CYCLES * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bits_equal(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def check_march(r) -> dict:
    """K1 at every call of one full 1080p sample (camera march and NEE
    shadow marches): each call's inputs go through the kernel and the
    plain version, which must agree bit for bit on every output of every
    lane. The times are summed over the sample's calls; the plain version
    synchronizes at every step (to test whether any lane still marches), so
    its time includes the host's share."""
    import torch

    import volxel_tpu_torch.render.modes as modes
    from volxel_tpu_torch.render.pathtrace import render_sample
    from volxel_tpu_torch.render.pyrmarch import pyr_march_cuda, pyr_march_plain

    names = ("t", "tau", "mip", "maj", "kind", "budget")
    tally = {"calls": 0, "lanes": 0, "ms": 0.0, "plain_ms": 0.0, "err": 0.0}

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(PRE_ROLL_CYCLES)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    def compared(*args):
        got, ms = timed(lambda: pyr_march_cuda(*args))
        want, plain_ms = timed(lambda: pyr_march_plain(*args))
        bad = [nm for nm, a, b in zip(names, got, want) if not bits_equal(a, b)]
        # lanes outside the box carry NaN/inf through unchanged: count them as 0
        err = max(float((a.double() - b.double()).abs().nan_to_num(0.0).max()) for a, b in zip(got, want))
        if bad:
            raise SystemExit(f"pyr_march call {tally['calls']}: kernel differs from its plain version "
                             f"in {bad} (max abs {err})")
        tally["calls"] += 1
        tally["lanes"] += int(args[10].sum())
        tally["ms"] += ms
        tally["plain_ms"] += plain_ms
        tally["err"] = max(tally["err"], err)
        return got

    config = r._config()
    inv_view, inv_proj, light_dir = r._camera_operands(config)
    operands = (config, r._device_grid, r.volume_params(), r._lut, r.environment.state, inv_view, inv_proj,
                light_dir)
    original = modes.pyr_march
    modes.pyr_march = compared
    try:
        render_sample(*operands, 0)
    finally:
        modes.pyr_march = original
    log(f"pyr_march: bit-equal at all {tally['calls']} calls of one {config.width}x{config.height} sample "
        f"({tally['lanes']} running lanes in all); kernel {tally['ms']:.4f} ms, plain {tally['plain_ms']:.4f} ms "
        f"summed over the calls")
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
    ms = time_ms(lambda: build_importance_pyramid_cuda(base), 50)
    plain_ms = time_ms(lambda: build_importance_pyramid_plain(base), 50)
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
    ms = time_ms(lambda: tonemap_cuda(fb, exposure, gamma), 50)
    plain_ms = time_ms(lambda: tonemap_plain(fb, exposure, gamma), 50)
    log(f"tonemap: within atol 1e-6 (max abs {err:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "tonemap", "route": "cuda", "source": "volxel_tpu_torch/csrc/tonemap.cu",
            "replaces": "volxel_tpu/render/pallas_ops.py:115", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms}


def main_path(grid, width: int, height: int) -> dict:
    """The Renderer from construction to image(), with every launch counter
    at 0 just before it starts."""
    import torch

    from volxel_tpu_torch import kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    r = bench_renderer(grid, width, height, "cuda")
    for _ in range(WARMUP_FRAMES):
        r.render_frame()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    march_before = kernels.LAUNCHES["pyr_march"]
    for _ in range(ACCUMULATED_FRAMES):
        r.render_frame()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rounds = (kernels.LAUNCHES["pyr_march"] - march_before) / ACCUMULATED_FRAMES
    img = r.image()
    launches = dict(kernels.LAUNCHES)
    raw = r._framebuffer
    log(f"main path: {width}x{height}, setup + {WARMUP_FRAMES} warm-up frames {t1 - t0:.3f} s, "
        f"{(t2 - t1) * 1000 / ACCUMULATED_FRAMES:.3f} ms/sample over {ACCUMULATED_FRAMES} accumulated frames, "
        f"{rounds:.1f} march launches per sample, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    log(f"launches: {launches}")
    if img.shape != (height, width, 3) or not np.isfinite(img).all():
        raise SystemExit(f"image() gave shape {img.shape} or non-finite values")
    mean = float(raw.mean())
    if not (bool(torch.isfinite(raw).all()) and mean > 0.0):
        raise SystemExit(f"framebuffer not finite or mean radiance {mean} <= 0")
    for name, count in launches.items():
        if count <= 0:
            raise SystemExit(f"kernel {name} was not launched on the main path")
    log(f"main path output: mean radiance {mean:.6f}, image mean {float(img.mean()):.6f}")
    return launches


def parity(grid, size: int) -> None:
    """The same scene on the card and on the CPU, held to the slice contract."""
    images = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        r = bench_renderer(grid, size, size, device)
        for _ in range(PARITY_FRAMES):
            r.render_frame()
        images[device] = r._framebuffer.cpu().numpy().astype(np.float64)
        log(f"parity render on {device}: {time.perf_counter() - t0:.2f} s")
    gpu, cpu = images["cuda"], images["cpu"]
    rel = np.abs(gpu - cpu) / (np.abs(cpu) + 1e-3)
    tight = float((rel.max(axis=-1) < 1e-3).mean())
    median = float(np.median(rel))
    means = (float(gpu.mean()), float(cpu.mean()))
    log(f"parity {size}x{size}: {tight:.4%} of pixels within 0.1%, median rel {median:.3e}, "
        f"means {means[0]:.6f} (card) {means[1]:.6f} (cpu)")
    if not (tight > 0.98 and median < 1e-4 and abs(means[0] - means[1]) < 5e-3 * max(means[1], 1e-3)):
        raise SystemExit("card and CPU renders disagree beyond the parity contract")


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

    # phase 3: each kernel against its plain version at the main path's shapes
    r = bench_renderer(grid, args.width, args.height, "cuda")
    results = [check_march(r), check_pyramid(r), check_tonemap(r.settings.exposure, r.settings.gamma)]
    del r
    torch.cuda.empty_cache()

    # phase 4: the main path
    launches = main_path(grid, args.width, args.height)
    for entry in results:
        entry["launches"] = launches[entry["name"]]

    # phase 5: card against CPU at a small size
    parity(grid, args.parity_size)

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
