"""DICOM RLE Lossless codec (transfer syntax 1.2.840.10008.1.2.5).

PS3.5 Annex G: a 64-byte header (number of segments + up to 15 segment
offsets, little-endian u32) followed by PackBits-compressed byte segments.
A 16-bit single-sample image is split into its MSB plane (segment 0) and
LSB plane (segment 1). Decoder and encoder round-trip bit-exactly
(tests/test_ingest_compressed.py). Parity: the reference reaches RLE via
dicom-pixeldata's native feature (dicom_preprocessor/Cargo.toml:25).
"""

from __future__ import annotations

import struct

import numpy as np


class RleError(ValueError):
    pass


def _packbits_decode(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        header = data[i]
        i += 1
        if header < 128:
            count = header + 1
            out += data[i : i + count]
            i += count
        elif header > 128:
            count = 257 - header
            out += data[i : i + 1] * count
            i += 1
        # 128 is a no-op
    if len(out) < expected:
        raise RleError(f"truncated RLE segment: {len(out)}/{expected} bytes")
    return bytes(out[:expected])


def _packbits_encode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        # find run length at i
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out.append(257 - run)
            out.append(data[i])
            i += run
            continue
        # literal run until the next >=3 repeat (2-byte runs aren't worth
        # breaking a literal for) or 128 bytes
        j = i + 1
        while j < n and j - i < 128:
            if j + 2 < n and data[j] == data[j + 1] == data[j + 2]:
                break
            j += 1
        out.append(j - i - 1)
        out += data[i:j]
        i = j
    return bytes(out)


def decode_rle(data: bytes, rows: int, cols: int, bits_allocated: int) -> np.ndarray:
    """Decode one RLE frame to a (rows, cols) uint16 array."""
    if len(data) < 64:
        raise RleError("RLE frame shorter than its 64-byte header")
    n_seg = struct.unpack_from("<I", data, 0)[0]
    offsets = struct.unpack_from("<15I", data, 4)
    nbytes = bits_allocated // 8
    if n_seg != nbytes:
        raise RleError(
            f"expected {nbytes} RLE segments for {bits_allocated}-bit "
            f"single-sample data, got {n_seg}"
        )
    expected = rows * cols
    planes = []
    for s in range(n_seg):
        start = offsets[s]
        end = offsets[s + 1] if s + 1 < n_seg and offsets[s + 1] else len(data)
        planes.append(
            np.frombuffer(
                _packbits_decode(data[start:end], expected), np.uint8
            ).astype(np.uint16)
        )
    if nbytes == 1:
        return planes[0].reshape(rows, cols)
    # segment 0 = MSB plane, segment 1 = LSB plane (PS3.5 G.2)
    return ((planes[0] << 8) | planes[1]).reshape(rows, cols)


def encode_rle(img: np.ndarray) -> bytes:
    """Encode a 2D uint8/uint16 image as one DICOM RLE frame."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        segments = [_packbits_encode(img.tobytes())]
    elif img.dtype == np.uint16:
        segments = [
            _packbits_encode((img >> 8).astype(np.uint8).tobytes()),
            _packbits_encode((img & 0xFF).astype(np.uint8).tobytes()),
        ]
    else:
        raise RleError(f"unsupported dtype {img.dtype}")
    # pad segments to even length (PS3.5 G.3.1)
    segments = [s + b"\x00" if len(s) % 2 else s for s in segments]
    offsets = [0] * 15
    pos = 64
    for i, seg in enumerate(segments):
        offsets[i] = pos
        pos += len(seg)
    header = struct.pack("<I15I", len(segments), *offsets)
    return header + b"".join(segments)
