"""The harness's arithmetic over frame times (copies, never imports, of
the program's: frame_stats in utils/profiling.py, the per-sample mean of
api/benchmark.py)."""

from __future__ import annotations

import numpy as np


def ms_per_sample(window_s: float, frames: int) -> float:
    """Window wall time over the samples completed in it, in ms."""
    return 1000.0 * window_s / frames


def p95_ms(times_s) -> float:
    """95th percentile of fenced frame times, in ms (frame_stats' p95)."""
    return float(np.percentile(np.asarray(times_s, np.float64) * 1000.0, 95))


def before_profiling(frames) -> list:
    """The window's frames before its first profiled one: once a profiler
    has recorded the device in a process, later launches cost the host
    more, so a host time read after it reads high."""
    first = next((i for i, f in enumerate(frames) if f.traced), len(frames))
    return frames[:first]
