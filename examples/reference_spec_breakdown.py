"""Where a sample of the reference benchmark spec goes, on one card.

    python examples/reference_spec_breakdown.py [--size 512] [--frames 20]

Loads chip_smoke.py phase 2b's inputs through the port's entry points (the
fixture writers' --size^3 12-bit DICOM zip and 2048x1024 HDR map, through
Renderer.from_attributes) and, for each entry of
tests/fixtures/reference_benchmark.json (one per mode; 1536x864, bounces
1), measures three scenes after 5 warm-up frames:

- "spec": the spec's settings on the loaded map;
- "spec, default env": the same on the default 8x6 environment;
- "bench framing": chip_smoke.py's phase-4 scene (its camera, transfer and
  sample range, the default environment) at the spec's 1536x864.

For each: --frames frames each ended by torch.cuda.synchronize(), as
api/benchmark.run_single_benchmark times them (mean, median, min, max ms);
--frames frames with one synchronize at the end (ms a frame, and the
host's mean time inside render_frame(), the enqueue); one sample with a
synchronize around each leg (chip_smoke.leg_split); one profiled
sample (chip_smoke.log_device_profile: device kernels, busy ms, idle
share). Prints the card's name and power limit first and one JSON line
per scene and mode.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

WARMUP = 5


def measure(r, frames: int) -> dict:
    import torch

    for _ in range(WARMUP):
        r.render_frame()
    torch.cuda.synchronize()
    fenced = []
    for _ in range(frames):
        t0 = time.perf_counter()
        r.render_frame()
        torch.cuda.synchronize()
        fenced.append((time.perf_counter() - t0) * 1000)
    enqueue = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        t1 = time.perf_counter()
        r.render_frame()
        enqueue.append((time.perf_counter() - t1) * 1000)
    torch.cuda.synchronize()
    streamed = (time.perf_counter() - t0) * 1000 / frames
    out = {"fenced_mean_ms": float(np.mean(fenced)), "fenced_median_ms": float(np.median(fenced)),
           "fenced_min_ms": min(fenced), "fenced_max_ms": max(fenced), "streamed_ms": streamed,
           "enqueue_mean_ms": float(np.mean(enqueue))}
    total, legs, _, _ = chip_smoke.leg_split(r)
    out.update({"sample_ms": total, "camera_ms": legs["camera"], "shadow_ms": legs["shadow"],
                "rest_ms": total - legs["camera"] - legs["shadow"]})
    _, wall = chip_smoke.timed_call(r.render_frame)
    w, h = r._render_dims()
    chip_smoke.log_device_profile(f"{r.render_mode} ({w}x{h})", r.render_frame, wall)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("reference_spec_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from volxel_tpu_torch import Renderer
    from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume, synthetic_env_hdr, write_dicom_zip

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    spec = json.loads(chip_smoke.REFERENCE_SPEC.read_text())
    settings = spec["sharedSettings"][0]
    with tempfile.TemporaryDirectory(prefix="volxel_spec_") as tmpdir:
        tmp = Path(tmpdir)
        vol = synthetic_ct_volume((args.size,) * 3, bits_stored=12, seed=0)
        (tmp / "ct.zip").write_bytes(write_dicom_zip(vol, bits_stored=12))
        del vol
        env_bytes = synthetic_env_hdr(*chip_smoke.ENV_SIZE)
        (tmp / "sky.hdr").write_bytes(env_bytes)
        r = Renderer.from_attributes(width=1920, height=1080, zip_path=tmp / "ct.zip", env_path=tmp / "sky.hdr")
    w = round(1920 * settings["display"]["resolutionFactor"])
    h = round(1080 * settings["display"]["resolutionFactor"])
    for entry in spec["benchmarks"]:
        mode = entry["renderMode"]
        for scene in ("spec", "spec, default env", "bench framing"):
            if scene == "bench framing":
                s = chip_smoke.bench_renderer(r.grid, w, h, "cuda", mode)
            else:
                if scene == "spec, default env":
                    r.load_env_default()
                r.restore_settings(settings)
                r.render_mode = mode
                s = r
            out = {"scene": scene, "mode": mode, "width": s._render_dims()[0], "height": s._render_dims()[1]}
            out.update(measure(s, args.frames))
            print(json.dumps(out), flush=True)
            if scene == "spec, default env":
                r.load_env(env_bytes)
            del s
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
