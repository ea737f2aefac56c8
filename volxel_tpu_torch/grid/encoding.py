"""Pure brick-grid encodings — vectorized over numpy arrays.

Wire-format parity with the reference acceleration structure
(dicom_preprocessor/src/brick.rs:19-52):

* range:  (min, max) as two IEEE float16 packed into one uint32,
          min in the high 16 bits, max in the low 16 bits.
* ptr:    brick pointer as three 10-bit fields in one uint32
          (x lowest, then y, then z).
* voxel:  density normalized to the brick-local decoded range, one uint8.

These are trivially invertible and property-tested for round-trips.
The compute path does NOT use the packed forms (it keeps min/max and
ptr coordinates as separate planar arrays — better for TPU vector loads);
the packed forms exist for export/interop parity and testing.
"""

from __future__ import annotations

import numpy as np

BRICK_SIZE = 8
BITS_PER_AXIS = 10
MAX_BRICKS = 1 << BITS_PER_AXIS
VOXELS_PER_BRICK = BRICK_SIZE**3
NUM_MIPMAPS = 3


def f16_round(x: np.ndarray) -> np.ndarray:
    """Round float32 values through IEEE float16 precision (and back)."""
    return np.asarray(x, dtype=np.float32).astype(np.float16).astype(np.float32)


def encode_range(lo, hi) -> np.ndarray:
    """Pack (min, max) float pairs into uint32: f16(min) << 16 | f16(max)."""
    lo16 = np.asarray(lo, dtype=np.float32).astype(np.float16).view(np.uint16)
    hi16 = np.asarray(hi, dtype=np.float32).astype(np.float16).view(np.uint16)
    return (lo16.astype(np.uint32) << 16) | hi16.astype(np.uint32)


def decode_range(packed) -> tuple[np.ndarray, np.ndarray]:
    """Unpack uint32 range words into (min, max) float32 arrays."""
    packed = np.asarray(packed, dtype=np.uint32)
    lo = (packed >> 16).astype(np.uint16).view(np.float16).astype(np.float32)
    hi = (packed & 0xFFFF).astype(np.uint16).view(np.float16).astype(np.float32)
    return lo, hi


def encode_ptr(xyz: np.ndarray) -> np.ndarray:
    """Pack (..., 3) brick pointers into uint32 with 10 bits per axis."""
    xyz = np.asarray(xyz)
    if np.any(xyz >= MAX_BRICKS) or np.any(xyz < 0):
        raise ValueError("brick pointer exceeds 10-bit axis range")
    x = xyz[..., 0].astype(np.uint32)
    y = xyz[..., 1].astype(np.uint32)
    z = xyz[..., 2].astype(np.uint32)
    return x | (y << BITS_PER_AXIS) | (z << (2 * BITS_PER_AXIS))


def decode_ptr(packed) -> np.ndarray:
    """Unpack uint32 pointers to (..., 3) int32 brick coordinates."""
    packed = np.asarray(packed, dtype=np.uint32)
    mask = np.uint32(MAX_BRICKS - 1)
    x = packed & mask
    y = (packed >> BITS_PER_AXIS) & mask
    z = (packed >> (2 * BITS_PER_AXIS)) & mask
    return np.stack([x, y, z], axis=-1).astype(np.int32)


def encode_voxel(value, lo, hi) -> np.ndarray:
    """Normalize density to the brick range and quantize to uint8.

    Degenerate ranges (hi == lo) encode to 0 — those bricks are constant
    and never looked up through the atlas anyway.
    """
    value = np.asarray(value, dtype=np.float32)
    lo = np.asarray(lo, dtype=np.float32)
    hi = np.asarray(hi, dtype=np.float32)
    width = hi - lo
    safe = np.where(width > 0, width, 1.0)
    normalized = np.clip((value - lo) / safe, 0.0, 1.0)
    normalized = np.where(width > 0, normalized, 0.0)
    # floor(x + 0.5) in float32 == the reference's f32::round (half away
    # from zero) for non-negative x; np.round would be banker's rounding
    # and disagrees with the C++ builder on exact .5 boundaries
    return np.floor(np.float32(255.0) * normalized + np.float32(0.5)).astype(
        np.uint8
    )


def decode_voxel(data, lo, hi) -> np.ndarray:
    """Dequantize uint8 voxels back to float32 densities."""
    data = np.asarray(data, dtype=np.float32)
    lo = np.asarray(lo, dtype=np.float32)
    hi = np.asarray(hi, dtype=np.float32)
    return lo + data * np.float32(1.0 / 255.0) * (hi - lo)
