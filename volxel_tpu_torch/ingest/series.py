"""DICOM series folding: many slices -> one dense volume + statistics.

Parity with read_dicoms_internal (dicom_preprocessor/src/lib.rs:142-191)
and the dense-grid semantics (dicom.rs): files are stacked in the order
given, the histogram has 2^bits_stored bins accumulated across files,
densities normalize as raw / max_sample, minorant/majorant is (0, 1), and
the index->local transform is scale(pixel_spacing_x, pixel_spacing_y,
slice_thickness). The histogram gradient is the 3-tap-smoothed first
difference with abs-min/max (dicom.rs:39-66).

Everything here is vectorized numpy — the reference's per-pixel scan loop
(lib.rs:94-102) becomes np.bincount.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from volxel_tpu_torch.grid.brick import BrickGrid, construct_brick_grid
from volxel_tpu_torch.ingest.dicom import DicomError, DicomFile, parse_dicom
from volxel_tpu_torch.utils.mathutil import scale_matrix
from volxel_tpu_torch.utils.profiling import span


@dataclass
class DicomSeries:
    """Fold result (reference DicomDataInternal, lib.rs:25-31)."""

    data: np.ndarray  # (Z, Y, X) uint16
    histogram: np.ndarray  # (2^bits_stored,) uint32
    min: int
    max: int
    transform: np.ndarray  # (4, 4) float32

    @property
    def index_extent(self) -> tuple[int, int, int]:
        z, y, x = self.data.shape
        return (x, y, z)

    def normalized(self) -> np.ndarray:
        """Density lookup semantics: raw / max (dicom.rs:7-17)."""
        denom = float(self.max) if self.max > 0 else 1.0
        return self.data.astype(np.float32) / np.float32(denom)

    def histogram_gradient(self) -> tuple[np.ndarray, int, int]:
        """Smoothed histogram first-difference (dicom.rs:39-66).

        Returns (smoothed gradient int32, abs-min, abs-max). Min/max are
        computed on the *unsmoothed* gradient, matching the reference.
        """
        h = self.histogram.astype(np.int64)
        grad = np.empty_like(h)
        grad[0] = h[0]  # first step diffs against last=0
        grad[1:] = h[1:] - h[:-1]
        abs_grad = np.abs(grad)
        gradmin = int(abs_grad.min()) if len(grad) else 0
        gradmax = int(abs_grad.max()) if len(grad) else 0
        smoothed = grad.copy()
        if len(grad) > 2:
            # Rust integer division truncates toward zero
            s = grad[:-2] + grad[1:-1] + grad[2:]
            smoothed[1:-1] = np.sign(s) * (np.abs(s) // 3)
        return smoothed.astype(np.int32), gradmin, gradmax


def _scan(px: np.ndarray, bins: int) -> tuple[np.ndarray, int, int]:
    """One-pass histogram + min/max (native C++ when available)."""
    from volxel_tpu_torch.native.loader import native_available, scan_u16

    if native_available():
        hist, lo, hi = scan_u16(px, bins)
        return hist, lo, hi
    counts = np.bincount(px.ravel(), minlength=bins).astype(np.uint32)
    return counts, int(px.min()), int(px.max())


def _fold_slices(files: list[DicomFile]) -> DicomSeries:
    slices: list[np.ndarray] = []
    histogram: np.ndarray | None = None
    vmin, vmax = np.iinfo(np.uint16).max, 0
    transform = np.eye(4, dtype=np.float32)

    for f in files:
        if f.is_dicomdir:
            # DICOMDIR records are logged and skipped by the reference
            # (lib.rs:49-72); they carry no pixel data
            continue
        px = f.pixel_array()  # (frames, rows, cols)
        bins = 1 << f.bits_stored
        counts, slice_min, slice_max = _scan(px, bins)
        if histogram is None:
            histogram = np.zeros(bins, np.uint32)
        if len(counts) > len(histogram):
            histogram = np.pad(histogram, (0, len(counts) - len(histogram)))
        histogram[: len(counts)] += counts
        vmin = min(vmin, slice_min)
        vmax = max(vmax, slice_max)
        sx, sy = f.pixel_spacing()
        transform = scale_matrix((sx, sy, f.slice_thickness()))
        slices.append(px)

    if not slices:
        raise DicomError("No dicom data collected")
    data = np.concatenate(slices, axis=0)
    return DicomSeries(
        data=data,
        histogram=histogram if histogram is not None else np.zeros(0, np.uint32),
        min=vmin,
        max=vmax,
        transform=transform,
    )


def _as_bytes(source) -> bytes:
    if isinstance(source, (bytes, bytearray, memoryview)):
        return bytes(source)
    return Path(source).read_bytes()


def read_dicom_series(sources: list) -> DicomSeries:
    """Parse and fold DICOM files (paths or byte strings), in given order."""
    files = [parse_dicom(_as_bytes(s)) for s in sources]
    return _fold_slices(files)


def series_to_grid(series: DicomSeries) -> BrickGrid:
    """DicomSeries -> BrickGrid (reference read_dicoms_to_grid, lib.rs:193-202)."""
    with span("vx::ingest.grid"):
        grad, gmin, gmax = series.histogram_gradient()
        return construct_brick_grid(
            series.normalized(),
            transform=series.transform,
            min_maj=(0.0, 1.0),
            histogram=series.histogram,
            histogram_gradient=grad,
            histogram_gradient_range=(gmin, gmax),
        )


def read_dicoms_to_grid(sources: list) -> BrickGrid:
    return series_to_grid(read_dicom_series(sources))
