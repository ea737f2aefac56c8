"""Build + load the native ingest library (ctypes, no pybind11 in env).

The port's counterpart of volxel_tpu/native/loader.py, with the same entry
points and the same numpy fallback: callers check native_available() and
take the numpy paths where no g++ is found. The library is built from this
package's own copies of volxel_native.cpp and volxel_ppmd.cpp (byte-equal
to the JAX package's) into `volxel_tpu_torch/build/`, under a name keyed by
a hash of the two sources, the flags and the host's CPU model: `-march=native`
ties a library to the CPU that built it, and an edited source gets a new
name. The build writes a temporary file in that directory and renames it
into place, so processes that build at once (parallel test workers) each
finish with a whole library and never load a half-written one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "volxel_native.cpp"
_SRC_PPMD = Path(__file__).parent / "volxel_ppmd.cpp"
BUILD = Path(__file__).resolve().parent.parent / "build"
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_load_error: str | None = None


def _cpu_model() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_cpu_model().encode())
    for src in (_SRC, _SRC_PPMD):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libvolxel_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.stem + "-", suffix=".so.tmp", dir=BUILD)
    os.close(fd)
    try:
        cmd = ["g++", *FLAGS, str(_SRC), str(_SRC_PPMD), "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_native():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        lib.volxel_scan_u16.argtypes = [
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_uint16),
        ]
        lib.volxel_brick_ranges.restype = ctypes.c_int64
        lib.volxel_brick_ranges.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            *([ctypes.c_int64] * 6),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.volxel_jpeg_lossless_chunk.restype = ctypes.c_int64
        lib.volxel_jpeg_lossless_chunk.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int32),
            *([ctypes.c_int64] * 4),
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.volxel_huf_decode.restype = ctypes.c_int64
        lib.volxel_huf_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int64,
        ]
        lib.volxel_huf_uncompress.restype = ctypes.c_int64
        lib.volxel_huf_uncompress.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int64,
        ]
        for fn_name in ("volxel_ppmd_decompress", "volxel_ppmd_decompress_to_marker"):
            fn = getattr(lib, fn_name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64,
            ]
        lib.volxel_fill_atlas.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            *([ctypes.c_int64] * 6),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
        ]
        _lib = lib
    except Exception as e:  # build toolchain or load failure
        _load_error = str(e)
        _lib = None
    return _lib


def native_available() -> bool:
    return get_native() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def scan_u16(data: np.ndarray, bins: int) -> tuple[np.ndarray, int, int]:
    """Native histogram + min/max over a uint16 array."""
    lib = get_native()
    data = np.ascontiguousarray(data, dtype=np.uint16).ravel()
    hist = np.zeros(bins, np.uint32)
    lo = ctypes.c_uint16()
    hi = ctypes.c_uint16()
    lib.volxel_scan_u16(
        _ptr(data, ctypes.c_uint16),
        data.size,
        _ptr(hist, ctypes.c_uint32),
        bins,
        ctypes.byref(lo),
        ctypes.byref(hi),
    )
    return hist, int(lo.value), int(hi.value)


def jpeg_lossless_chunk(
    data: bytes,
    lut: np.ndarray,
    out: np.ndarray,
    w: int,
    start_idx: int,
    n_samples: int,
    predictor: int,
    default_pred: int,
) -> int:
    """Native JPEG-lossless scan decode of one restart interval.

    `out` is the full (h*w,) int32 image buffer, filled in place starting
    at start_idx. Returns samples decoded (or -1 on an invalid code).
    """
    lib = get_native()
    padded = np.frombuffer(data + b"\x00" * 8, np.uint8)
    h = out.size // w
    return lib.volxel_jpeg_lossless_chunk(
        _ptr(padded, ctypes.c_uint8),
        len(data),
        _ptr(lut, ctypes.c_uint32),
        _ptr(out, ctypes.c_int32),
        w,
        h,
        start_idx,
        n_samples,
        predictor,
        default_pred,
    )


def huf_uncompress(data: bytes, n_out: int) -> tuple[int, np.ndarray]:
    """Native ImfHuf decode (full: table + canonical codes + symbol loop,
    see piz.py:huf_uncompress for the format).

    Returns (status, out): status is symbols decoded, or -1 truncated /
    -2 invalid code / -3 bad RLE run / -4 corrupt header or table.
    """
    lib = get_native()
    padded = np.frombuffer(data + b"\x00" * 16, np.uint8)
    out = np.empty(n_out, np.uint16)
    status = lib.volxel_huf_uncompress(
        _ptr(padded, ctypes.c_uint8),
        len(data),
        _ptr(out, ctypes.c_uint16),
        n_out,
    )
    return int(status), out


def brick_construct(data: np.ndarray, bx: int, by: int, bz: int):
    """Native brick construction from a dense (ez, ey, ex) float32 volume.

    Returns (range_lo, range_hi, indirection, occupied, atlas, counter)
    with the same layout/semantics as grid.brick.construct_brick_grid.
    """
    lib = get_native()
    data = np.ascontiguousarray(data, dtype=np.float32)
    ez, ey, ex = data.shape
    nb = bx * by * bz
    range_lo = np.empty(nb, np.float32)
    range_hi = np.empty(nb, np.float32)
    indirection = np.empty(nb * 3, np.int32)
    occupied = np.empty(nb, np.uint8)
    counter = lib.volxel_brick_ranges(
        _ptr(data, ctypes.c_float),
        ex,
        ey,
        ez,
        bx,
        by,
        bz,
        _ptr(range_lo, ctypes.c_float),
        _ptr(range_hi, ctypes.c_float),
        _ptr(indirection, ctypes.c_int32),
        _ptr(occupied, ctypes.c_uint8),
    )
    az_bricks = -(-counter // (bx * by)) if counter else 0
    az = az_bricks * 8
    atlas = np.zeros((az, by * 8, bx * 8), np.uint8)
    if counter:
        lib.volxel_fill_atlas(
            _ptr(data, ctypes.c_float),
            ex,
            ey,
            ez,
            bx,
            by,
            bz,
            _ptr(range_lo, ctypes.c_float),
            _ptr(range_hi, ctypes.c_float),
            _ptr(indirection, ctypes.c_int32),
            _ptr(occupied, ctypes.c_uint8),
            _ptr(atlas, ctypes.c_uint8),
            az,
        )
    return (
        range_lo.reshape(bz, by, bx),
        range_hi.reshape(bz, by, bx),
        indirection.reshape(bz, by, bx, 3),
        occupied.reshape(bz, by, bx).astype(bool),
        atlas,
        int(counter),
    )


def ppmd_decompress(
    data: bytes,
    order: int,
    mem_mb: int,
    restore_method: int = 0,
    size: int | None = None,
) -> tuple[int, bytes]:
    """Native PPMd var.I decode. Returns (status, payload): status >= 0 is
    bytes decoded; negative mirrors volxel_ppmd.cpp's error codes."""
    lib = get_native()
    src = np.frombuffer(bytes(data), np.uint8)
    if size is not None:
        out = np.empty(max(size, 1), np.uint8)
        rc = lib.volxel_ppmd_decompress(
            _ptr(src, ctypes.c_uint8), src.size, order, mem_mb,
            restore_method, _ptr(out, ctypes.c_uint8), size,
        )
    else:
        cap = max(len(data) * 64, 1 << 20)
        while True:
            out = np.empty(cap, np.uint8)
            rc = lib.volxel_ppmd_decompress_to_marker(
                _ptr(src, ctypes.c_uint8), src.size, order, mem_mb,
                restore_method, _ptr(out, ctypes.c_uint8), cap,
            )
            if rc != -3:
                break
            cap *= 4  # marker not reached: grow and retry
    if rc < 0:
        return int(rc), b""
    return int(rc), out[:rc].tobytes()
