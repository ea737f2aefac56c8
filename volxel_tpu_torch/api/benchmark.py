"""Declarative benchmark harness (reference viewer.ts:72-109, 840-890): the
PyTorch counterpart of volxel_tpu.api.benchmark.

Runs VolxelBenchmark-shaped JSON specs: a list of scenarios (volume +
environment + settings + render mode), each rendered for `samples`
progressive frames with device fencing (`torch.cuda.synchronize` on a
renderer on the card, standing in for gl.finish, viewer.ts:1213-1218),
producing VolxelBenchmarkResult-shaped records with a device fingerprint.
The records keep the JAX package's keys; in the fingerprint the JAX
version becomes the torch and CUDA versions, and a card's record also
carries its power limit, as nvidia-smi reads it (null where nvidia-smi
cannot be run).
"""

from __future__ import annotations

import datetime
import functools
import json
import platform
import subprocess
import time
from pathlib import Path

import torch

from volxel_tpu_torch.api.renderer import Renderer
from volxel_tpu_torch.api.settings import verify_settings
from volxel_tpu_torch.utils.profiling import fence_device


@functools.lru_cache(maxsize=None)
def _power_limit(index: int) -> str | None:
    """The card's power limit as nvidia-smi gives it, e.g. "700.00 W", read
    once a process; None where nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def device_fingerprint(device="cuda") -> dict:
    """VolxelBenchmarkDeviceResult analog (viewer.ts:225-242) for the
    device a renderer draws on."""
    device = torch.device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        count = torch.cuda.device_count()
        accelerator = {"platform": "gpu", "kind": torch.cuda.get_device_name(index), "count": count}
    else:
        count = 1
        accelerator = {"platform": device.type, "kind": platform.processor() or platform.machine(),
                       "count": count}
    out = {
        "platform": platform.platform(),
        "pythonVersion": platform.python_version(),
        "torchVersion": torch.__version__,
        "cudaVersion": torch.version.cuda,
        "deviceCount": count,
        "accelerator": accelerator,
    }
    if device.type == "cuda":
        out["powerLimit"] = _power_limit(index)
    return out


def run_single_benchmark(
    renderer: Renderer,
    name: str | None = None,
    warmup: int = 1,
) -> dict:
    """Render maxSamples frames with fencing; report per-sample timing."""
    samples = int(renderer.settings.max_samples)
    renderer.restart_rendering()
    # first frames outside the timed region (the reference's first-frame jank)
    for _ in range(warmup):
        renderer.render_frame()
        fence_device(renderer.device)
    renderer.restart_rendering()

    total = 0.0
    for _ in range(samples):
        t0 = time.perf_counter()
        renderer.render_frame()
        fence_device(renderer.device)
        total += time.perf_counter() - t0

    w, h = renderer._render_dims()
    return {
        "name": name,
        "settings": renderer.settings.to_json_dict(),
        "totalTime": total * 1000.0,
        "timePerSample": total * 1000.0 / max(samples, 1),
        "viewport": [0, 0, w, h],
        "device": device_fingerprint(renderer.device),
        "timestamp": datetime.datetime.now(datetime.timezone.utc).isoformat(),
    }


def run_benchmark_collection(
    spec: dict,
    renderer: Renderer,
    load_zip=None,
    load_env=None,
) -> list[dict]:
    """Run a VolxelBenchmark spec (viewer.ts startBenchmark, :864-890).

    spec: {"sharedSettings": [SettingsExport...],
           "benchmarks": [{"zip"?, "env"?, "renderMode", "settings": int|export, "name"?}]}
    load_zip/load_env: callables resolving the spec's resource strings to
    bytes (the reference fetches URLs; here the host supplies a resolver).
    """
    results = []
    for entry in spec.get("benchmarks", []):
        if entry.get("zip") and load_zip is not None:
            data = load_zip(entry["zip"])
            if data is not None:
                renderer.restart_from_zip(data)
        if entry.get("env") and load_env is not None:
            data = load_env(entry["env"])
            if data is not None:
                renderer.load_env(data)
        apply_entry_settings(spec, entry, renderer)
        results.append(run_single_benchmark(renderer, name=entry.get("name")))
    return results


def apply_entry_settings(spec: dict, entry: dict, renderer: Renderer) -> None:
    """Put a spec entry's settings (an export, or an index into the spec's
    sharedSettings) and its render mode on the renderer."""
    settings = entry["settings"]
    if isinstance(settings, int):
        settings = spec["sharedSettings"][settings]
    renderer.restore_settings(verify_settings(settings))
    renderer.render_mode = entry["renderMode"]


def save_benchmark(results: list[dict], path) -> None:
    Path(path).write_text(json.dumps(results, indent=2))
