"""Brick-grid acceleration structure, constructed with vectorized numpy.

Functional parity with the reference builder (dicom_preprocessor/src/
brick.rs:76-205) but a completely different construction strategy: instead
of a serialized triple loop per brick, the dilated min/max is a separable
sliding-window reduction, atlas slots are bump-allocated with a cumulative
sum, and the atlas scatter is a single masked reshape/assignment. On a
512^3 volume this builds in well under a second vs "in excess of 2 minutes"
for the reference WASM pipeline (reference README.md:12).

Semantics preserved:
  * brick size 8, pointers 10 bits/axis, 3 range mip levels (brick.rs:9-13)
  * per-brick min/max over the dilated window [-2, 10)^3 with out-of-range
    lookups reading 0.0 (brick.rs:99-112; dicom.rs:7-17)
  * constant bricks (min == max before f16 rounding) store only a range and
    skip the atlas (brick.rs:114-120)
  * voxels quantized against the *decoded* (f16-rounded) range (brick.rs:137-145)
  * atlas pruned to ceil(counter / (bx*by)) brick layers (brick.rs:151)
  * 2^3-pooled range mipmaps re-rounded through f16 per level (brick.rs:154-190)

Layout: all 3D arrays are (Z, Y, X) so the C-order flat index equals the
reference Buf3D z-major index (buf3d.rs:26-28).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from volxel_tpu_torch.grid.encoding import (
    BRICK_SIZE,
    MAX_BRICKS,
    NUM_MIPMAPS,
    VOXELS_PER_BRICK,
    decode_range,
    decode_voxel,
    encode_ptr,
    encode_range,
    encode_voxel,
)
from volxel_tpu_torch.utils.mathutil import div_round_up


@dataclass
class BrickGrid:
    """Host-side brick grid. Device mirrors are built by the renderer."""

    brick_count: tuple[int, int, int]  # (bx, by, bz)
    brick_counter: int
    # (bz, by, bx) float32, already rounded through f16
    range_lo: np.ndarray
    range_hi: np.ndarray
    # (bz, by, bx, 3) int32 pointer coordinates (x, y, z); zeros where constant
    indirection: np.ndarray
    # (az, ay, ax) uint8
    atlas: np.ndarray
    # NUM_MIPMAPS levels of (lo, hi) pairs, each (bz>>l+1, by>>l+1, bx>>l+1)
    range_mips: list[tuple[np.ndarray, np.ndarray]]
    min_maj: tuple[float, float]
    transform: np.ndarray  # (4, 4) float32, index -> local space
    histogram: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))
    histogram_gradient: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    histogram_gradient_range: tuple[int, int] = (0, 0)

    # -- derived metadata (parity with brick.rs:207-269) ---------------------

    @property
    def index_extent(self) -> tuple[int, int, int]:
        bx, by, bz = self.brick_count
        return (bx * BRICK_SIZE, by * BRICK_SIZE, bz * BRICK_SIZE)

    @property
    def num_voxels(self) -> int:
        return self.brick_counter * VOXELS_PER_BRICK

    @property
    def size_bytes(self) -> int:
        bx, by, bz = self.brick_count
        dense = bx * by * bz
        mips = sum(lo.size * 4 for lo, _ in self.range_mips)
        return dense * 4 + dense * 4 + self.brick_counter * VOXELS_PER_BRICK + mips

    # -- reference-format exports (wire parity, used by tests) ---------------

    def packed_range(self) -> np.ndarray:
        return encode_range(self.range_lo, self.range_hi)

    def packed_indirection(self) -> np.ndarray:
        return encode_ptr(self.indirection)

    def packed_mip(self, level: int) -> np.ndarray:
        lo, hi = self.range_mips[level]
        return encode_range(lo, hi)

    # -- scalar decoded lookup (reference impl of brick.rs:208-233; testing) --

    def lookup(self, ipos) -> float:
        x, y, z = (int(v) for v in ipos)
        bx, by, bz = x >> 3, y >> 3, z >> 3
        lo = float(self.range_lo[bz, by, bx])
        hi = float(self.range_hi[bz, by, bx])
        ptr = self.indirection[bz, by, bx]
        ax = (int(ptr[0]) << 3) + (x & 7)
        ay = (int(ptr[1]) << 3) + (y & 7)
        az = (int(ptr[2]) << 3) + (z & 7)
        raw = self.atlas[az, ay, ax]
        return float(decode_voxel(raw, lo, hi))


def _pool_minmax_1d(lo: np.ndarray, hi: np.ndarray, axis: int, window: int, stride: int):
    """Separable sliding min/max along one axis."""
    lo_v = np.lib.stride_tricks.sliding_window_view(lo, window, axis=axis)
    hi_v = np.lib.stride_tricks.sliding_window_view(hi, window, axis=axis)
    index = [slice(None)] * lo_v.ndim
    index[axis] = slice(0, None, stride)
    lo_v = lo_v[tuple(index)]
    hi_v = hi_v[tuple(index)]
    return lo_v.min(axis=-1), hi_v.max(axis=-1)


def _dilated_brick_minmax(padded: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-brick min/max over the dilated [-2, BRICK+2) window.

    `padded` must already be zero-padded by 2 voxels on every side
    (out-of-extent lookups read 0.0 in the reference, dicom.rs:8-10).
    """
    window = BRICK_SIZE + 4
    lo, hi = padded, padded
    for axis in (0, 1, 2):
        lo, hi = _pool_minmax_1d(lo, hi, axis, window, BRICK_SIZE)
    return lo, hi


def _pool2_minmax(lo: np.ndarray, hi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """2x2x2 min/max pooling for range mip levels."""
    z, y, x = lo.shape
    lo = lo.reshape(z // 2, 2, y // 2, 2, x // 2, 2)
    hi = hi.reshape(z // 2, 2, y // 2, 2, x // 2, 2)
    return lo.min(axis=(1, 3, 5)), hi.max(axis=(1, 3, 5))


def construct_brick_grid(
    data: np.ndarray,
    transform: np.ndarray | None = None,
    min_maj: tuple[float, float] = (0.0, 1.0),
    histogram: np.ndarray | None = None,
    histogram_gradient: np.ndarray | None = None,
    histogram_gradient_range: tuple[int, int] = (0, 0),
    use_native: bool | None = None,
) -> BrickGrid:
    """Build a BrickGrid from a dense (Z, Y, X) float32 density volume.

    Vectorized equivalent of BrickGrid::construct (brick.rs:76-205).
    use_native: True forces the multithreaded C++ builder, False the numpy
    path, None (default) picks native when available.
    """
    data = np.ascontiguousarray(data, dtype=np.float32)
    ez, ey, ex = data.shape

    # brick counts rounded up to a multiple of 2^NUM_MIPMAPS (brick.rs:77)
    align = 1 << NUM_MIPMAPS
    bx = div_round_up(div_round_up(ex, BRICK_SIZE), align) * align
    by = div_round_up(div_round_up(ey, BRICK_SIZE), align) * align
    bz = div_round_up(div_round_up(ez, BRICK_SIZE), align) * align
    if bx >= MAX_BRICKS or by >= MAX_BRICKS or bz >= MAX_BRICKS:
        raise ValueError("Exceeded max brick count")

    if use_native is not False:
        from volxel_tpu_torch.native.loader import native_available

        if native_available():
            return _construct_native(
                data,
                (bx, by, bz),
                transform,
                min_maj,
                histogram,
                histogram_gradient,
                histogram_gradient_range,
            )
        if use_native:
            raise RuntimeError("native brick builder unavailable")

    # dense volume padded to the full brick extent; OOB reads are 0.0
    full = np.zeros((bz * BRICK_SIZE, by * BRICK_SIZE, bx * BRICK_SIZE), np.float32)
    full[:ez, :ey, :ex] = data

    # dilated per-brick min/max (2-voxel halo of zeros on each side)
    padded = np.pad(full, 2, mode="constant", constant_values=0.0)
    raw_lo, raw_hi = _dilated_brick_minmax(padded)  # (bz, by, bx)

    # constant-brick elision decided on the *unrounded* min/max (brick.rs:119)
    occupied = raw_lo != raw_hi

    # stored ranges round-trip through f16 (encode_range/decode_range)
    range_lo, range_hi = decode_range(encode_range(raw_lo, raw_hi))

    # bump-allocate atlas slots in z-major brick scan order (brick.rs:131-134)
    flat_mask = occupied.ravel()  # C order over (bz, by, bx) == z-major
    slots = np.cumsum(flat_mask) - 1
    counter = int(flat_mask.sum())

    ptr_x = (slots % bx).astype(np.int32)
    ptr_y = ((slots // bx) % by).astype(np.int32)
    ptr_z = (slots // (bx * by)).astype(np.int32)
    indirection = np.zeros((bz * by * bx, 3), np.int32)
    indirection[flat_mask] = np.stack(
        [ptr_x[flat_mask], ptr_y[flat_mask], ptr_z[flat_mask]], axis=-1
    )
    indirection = indirection.reshape(bz, by, bx, 3)

    # encode all voxels against the decoded ranges, then scatter occupied
    # bricks into the atlas in slot order
    bricks = (
        full.reshape(bz, BRICK_SIZE, by, BRICK_SIZE, bx, BRICK_SIZE)
        .transpose(0, 2, 4, 1, 3, 5)
        .reshape(bz * by * bx, BRICK_SIZE, BRICK_SIZE, BRICK_SIZE)
    )
    encoded = encode_voxel(
        bricks[flat_mask],
        range_lo.reshape(-1, 1, 1, 1)[flat_mask],
        range_hi.reshape(-1, 1, 1, 1)[flat_mask],
    )

    # atlas pruned to the used brick layers (brick.rs:151)
    az_bricks = div_round_up(counter, bx * by) if counter else 0
    atlas_bricks = np.zeros(
        (az_bricks * by * bx, BRICK_SIZE, BRICK_SIZE, BRICK_SIZE), np.uint8
    )
    atlas_bricks[:counter] = encoded
    atlas = (
        atlas_bricks.reshape(az_bricks, by, bx, BRICK_SIZE, BRICK_SIZE, BRICK_SIZE)
        .transpose(0, 3, 1, 4, 2, 5)
        .reshape(az_bricks * BRICK_SIZE, by * BRICK_SIZE, bx * BRICK_SIZE)
    )

    return _assemble(
        (bx, by, bz),
        counter,
        range_lo,
        range_hi,
        indirection,
        atlas,
        transform,
        min_maj,
        histogram,
        histogram_gradient,
        histogram_gradient_range,
    )


def _construct_native(
    data,
    brick_count,
    transform,
    min_maj,
    histogram,
    histogram_gradient,
    histogram_gradient_range,
) -> BrickGrid:
    """Multithreaded C++ construction path (volxel_native.cpp)."""
    from volxel_tpu_torch.native.loader import brick_construct

    bx, by, bz = brick_count
    range_lo, range_hi, indirection, _occ, atlas, counter = brick_construct(
        data, bx, by, bz
    )
    return _assemble(
        brick_count,
        counter,
        range_lo,
        range_hi,
        indirection,
        atlas,
        transform,
        min_maj,
        histogram,
        histogram_gradient,
        histogram_gradient_range,
    )


def _assemble(
    brick_count,
    counter,
    range_lo,
    range_hi,
    indirection,
    atlas,
    transform,
    min_maj,
    histogram,
    histogram_gradient,
    histogram_gradient_range,
) -> BrickGrid:
    """Shared tail: range mip pyramid (2^3 pooling, f16-rerounded per
    level, brick.rs:154-190) + metadata."""
    bx, by, bz = brick_count
    mips: list[tuple[np.ndarray, np.ndarray]] = []
    src_lo, src_hi = range_lo, range_hi
    for _ in range(NUM_MIPMAPS):
        mlo, mhi = _pool2_minmax(src_lo, src_hi)
        mlo, mhi = decode_range(encode_range(mlo, mhi))
        mips.append((mlo, mhi))
        src_lo, src_hi = mlo, mhi

    if transform is None:
        transform = np.eye(4, dtype=np.float32)
    if histogram is None:
        histogram = np.zeros(0, np.uint32)
    if histogram_gradient is None:
        histogram_gradient = np.zeros(0, np.int32)

    return BrickGrid(
        brick_count=(bx, by, bz),
        brick_counter=counter,
        range_lo=range_lo,
        range_hi=range_hi,
        indirection=indirection,
        atlas=atlas,
        range_mips=mips,
        min_maj=min_maj,
        transform=np.asarray(transform, dtype=np.float32),
        histogram=np.asarray(histogram, dtype=np.uint32),
        histogram_gradient=np.asarray(histogram_gradient, dtype=np.int32),
        histogram_gradient_range=histogram_gradient_range,
    )
