"""Histogram visualization data (elements/histogramViewer.ts:139-171).

The reference renders onto a Canvas2D; here the same math produces plain
arrays any frontend (matplotlib, terminal, web) can draw:
  * bar height per density bin: log10(count) / log10(max count), where the
    max ignores bin 0 (air dominates CT scans)
  * gradient overlay alpha per bin: log10(|gradient|) / log10(gradient max)
Bin 0 is skipped exactly like the reference's loops starting at i=1.
"""

from __future__ import annotations

import numpy as np


def histogram_view_data(
    histogram: np.ndarray,
    gradient: np.ndarray,
    gradient_max: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (bar_heights, gradient_alpha), both float32 in [0, 1]."""
    hist = np.asarray(histogram, np.float64)
    grad = np.asarray(gradient, np.float64)
    n = len(hist)
    bars = np.zeros(n, np.float32)
    alpha = np.zeros(n, np.float32)
    if n <= 1:
        return bars, alpha

    max_count = hist[1:].max(initial=0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        log_max = np.log10(max_count) if max_count > 0 else 1.0
        b = np.log10(hist[1:]) / (log_max if log_max != 0 else 1.0)
        bars[1:] = np.where(np.isfinite(b), np.clip(b, 0.0, 1.0), 0.0)

        glog_max = np.log10(gradient_max) if gradient_max > 0 else 1.0
        a = np.log10(np.abs(grad[1:])) / (glog_max if glog_max != 0 else 1.0)
        alpha[1:] = np.where(np.isfinite(a), np.clip(a, 0.0, 1.0), 0.0)
    return bars, alpha
