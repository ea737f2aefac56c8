"""8-bit RGB PNG files with the standard library alone (zlib and struct).

The JAX package writes its PNGs with PIL (`api/server.py`, `__main__.py`);
the port writes them here so that it needs no imaging library. The file is
one IHDR, one IDAT and an IEND chunk: 8 bits a channel, colour type 2
(RGB), no interlace, every row under filter 0, deflated at zlib level 6.
Any PNG decoder reads back the array's exact bytes. `decode_png` reads
such files back (filter 0 only), for checks on machines without an
imaging library.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COMPRESS_LEVEL = 6  # PIL's default


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(rgb: np.ndarray) -> bytes:
    """The PNG file of an (height, width, 3) uint8 array, row 0 at the top."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected an (height, width, 3) uint8 array, got {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    if h == 0 or w == 0:
        raise ValueError("a PNG needs at least one pixel")
    rows = np.empty((h, 1 + 3 * w), np.uint8)
    rows[:, 0] = 0  # filter type 0 (None) on every row
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), _COMPRESS_LEVEL))
            + _chunk(b"IEND", b""))


def write_png(path, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def decode_png(data: bytes) -> np.ndarray:
    """(height, width, 3) uint8 pixels of an 8-bit RGB, non-interlaced PNG
    whose rows all use filter 0, as encode_png writes; raises on any other."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"bad CRC in chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if (depth, colour, interlace) != (8, 2, 0):
        raise ValueError(f"only 8-bit RGB without interlace is read (depth {depth}, colour {colour})")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("only filter 0 is read")
    return rows[:, 1:].reshape(h, w, 3).copy()
