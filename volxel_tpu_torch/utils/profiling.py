"""Tracing / profiling utilities: the PyTorch counterpart of
volxel_tpu.utils.profiling.

The reference's instrumentation is gl.finish-fenced frame timers
(viewer.ts:1213-1218), ingest wall-clock logs (lib.rs:144-179), and a
device fingerprint. Here:

  * StageTimer — labelled wall-clock stages, fenced on the card when the
    stage names a CUDA tensor, printed like the reference's staged console
    logs
  * trace() — context manager around torch.profiler, written as a Chrome
    trace (open it in Perfetto or chrome://tracing)
  * frame_stats — summarize fenced per-frame timings
  * fence_device — wait for a card's queued work; nothing on the CPU
"""

from __future__ import annotations

import contextlib
import logging
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("volxel_tpu_torch")


def fence_device(device) -> None:
    """Wait until the card `device` has run everything queued on it (the
    gl.finish of the reference's timers); a CPU device needs no wait."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageTimer:
    """Labelled stage timings with optional device fencing."""

    def __init__(self, log: bool = True):
        self.stages: list[tuple[str, float]] = []
        self._log = log

    @contextlib.contextmanager
    def stage(self, name: str, fence=None):
        """Time the block. `fence`, a tensor, makes the stage wait for its
        device when it lies on the card; a CPU tensor needs no wait."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                fence_device(fence.device)
            dt = time.perf_counter() - t0
            self.stages.append((name, dt))
            if self._log:
                logger.info("%s: %.3fs", name, dt)

    def report(self) -> dict:
        return {name: dt for name, dt in self.stages}


@contextlib.contextmanager
def trace(log_dir=None):
    """torch.profiler trace around a code region, the card's kernels
    included where there is a card; written to `log_dir`/trace.json (a new
    temporary directory when None). Yields the directory."""
    out = Path(log_dir) if log_dir is not None else Path(tempfile.mkdtemp(prefix="volxel_trace_"))
    out.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield out
    prof.export_chrome_trace(str(out / "trace.json"))


def frame_stats(times_s: list[float]) -> dict:
    """Summary stats of fenced frame times, in milliseconds."""
    ts = np.asarray(times_s) * 1000.0
    return {
        "frames": len(ts),
        "mean_ms": float(ts.mean()),
        "median_ms": float(np.median(ts)),
        "min_ms": float(ts.min()),
        "max_ms": float(ts.max()),
        "p95_ms": float(np.percentile(ts, 95)),
    }
