"""Minimal OpenEXR decoder in numpy (no OpenEXR bindings in this env).

Covers the common EXR variants an environment-map workflow meets (the
reference delegates this to the Rust `image` crate, hdr.rs:23-36):
single-part SCANLINE and TILED (one-level or mipmap level 0) images,
HALF/FLOAT/UINT channels, compression NONE, ZIPS (1 line/chunk), ZIP
(16 lines/chunk), PIZ (32 lines/chunk — the single most common wild HDRI
compression; codec in ingest/piz.py), PXR24 (zlib + 24-bit float
truncation; lossless for HALF channels), B44/B44A (4x4 half blocks;
layout established against canonical-encoder fixtures) and DWAA/DWAB
(lossy DCT; codec in ingest/dwa.py) — the full standard compression set.
External-implementation fixtures written by the canonical OpenEXR
library live in tests/fixtures/ (tests/test_exr_external.py).

Output: (height, width, 4) float32 RGBA, row 0 = image top (dataWindow
yMin), alpha 1 where absent — same contract as decode_hdr.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from volxel_tpu_torch.ingest.hdr import EnvDecodeError

MAGIC = 0x01312F76

_PIXEL_DTYPES = {1: np.dtype("<f2"), 2: np.dtype("<f4"), 0: np.dtype("<u4")}
_PIXEL_SIZES = {1: 2, 2: 4, 0: 4}


def _read_cstring(buf: memoryview, pos: int) -> tuple[str, int]:
    end = pos
    while buf[end] != 0:
        end += 1
        if end - pos > 255:
            raise EnvDecodeError("Unterminated string in EXR header")
    return bytes(buf[pos:end]).decode("ascii", "replace"), end + 1


def _parse_channels(data: bytes) -> list[tuple[str, int]]:
    channels = []
    buf = memoryview(data)
    pos = 0
    while buf[pos] != 0:
        name, pos = _read_cstring(buf, pos)
        ptype = struct.unpack_from("<i", buf, pos)[0]
        # pLinear u8 + 3 reserved + xSampling + ySampling
        x_samp, y_samp = struct.unpack_from("<ii", buf, pos + 8)
        pos += 16
        if x_samp != 1 or y_samp != 1:
            raise EnvDecodeError("Subsampled EXR channels are not supported")
        channels.append((name, ptype))
    return channels


def _unzip_block(data: bytes) -> bytes:
    """zlib inflate + EXR delta/interleave postprocess."""
    raw = np.frombuffer(zlib.decompress(data), np.uint8).astype(np.int64)
    if len(raw) == 0:
        return b""
    # delta decode: d[i] = d[i-1] + raw[i] - 128
    raw[1:] -= 128
    recon = np.cumsum(raw).astype(np.uint8)
    # de-interleave: first half -> even bytes, second half -> odd bytes
    half = (len(recon) + 1) // 2
    out = np.empty(len(recon), np.uint8)
    out[0::2] = recon[:half]
    out[1::2] = recon[half:]
    return out.tobytes()


def _unpxr24(payload: bytes, channels, width: int, rows: int) -> bytes:
    """PXR24 chunk decode (ImfPxr24Compressor semantics): zlib inflate,
    then per row x channel undo the previous-pixel differencing over
    byte-split planes. HALF channels round-trip losslessly; FLOATs were
    truncated to 24 bits by the WRITER (reassembled as bits << 8)."""
    raw = np.frombuffer(zlib.decompress(payload), np.uint8)
    out = bytearray()
    p = 0
    for _ in range(rows):
        for _, ptype in channels:
            if ptype == 1:  # HALF: 2 planes, 16-bit running sum
                if p + 2 * width > len(raw):
                    raise EnvDecodeError("PXR24 chunk truncated")
                b0 = raw[p : p + width].astype(np.uint32)
                b1 = raw[p + width : p + 2 * width].astype(np.uint32)
                p += 2 * width
                diff = (b0 << 8) | b1
                pix = np.cumsum(diff, dtype=np.uint64).astype(np.uint32) & 0xFFFF
                out += pix.astype("<u2").tobytes()
            elif ptype == 2:  # FLOAT: 3 planes, 24-bit running sum, bits<<8
                b0 = raw[p : p + width].astype(np.uint32)
                b1 = raw[p + width : p + 2 * width].astype(np.uint32)
                b2 = raw[p + 2 * width : p + 3 * width].astype(np.uint32)
                p += 3 * width
                diff = (b0 << 16) | (b1 << 8) | b2
                pix = np.cumsum(diff, dtype=np.uint64).astype(np.uint32) & 0xFFFFFF
                out += (pix << 8).astype("<u4").tobytes()
            else:  # UINT: 4 planes, 32-bit running sum
                b = [
                    raw[p + i * width : p + (i + 1) * width].astype(np.uint64)
                    for i in range(4)
                ]
                p += 4 * width
                diff = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
                pix = np.cumsum(diff, dtype=np.uint64).astype(np.uint32)
                out += pix.astype("<u4").tobytes()
    return bytes(out)


def _unb44(payload: bytes, channels, width: int, rows: int) -> bytes:
    """B44 / B44A chunk decode.

    Layout (established empirically against files written by the canonical
    OpenEXR 3.1 encoder — tests/test_exr_external.py): channel-major in
    header order; HALF channels as 4x4 blocks row-major, each either
    14 bytes or (B44A) 3 bytes [t_hi, t_lo, 0xfc] for a flat block.
    14-byte block: t00 = (b0<<8)|b1 is pixel (0,0) after the monotonic
    transform (inf/nan -> 0x8000, negative -> ~s, else s|0x8000);
    shift = b2 >> 2; fifteen 6-bit fields f1..f15 follow, each decoding to
    (f << shift) - (0x20 << shift); f1..f3 chain DOWN column 0 and f4+y /
    f8+y / f12+y chain ACROSS to columns 1..3 of row y. Non-HALF channels
    are stored verbatim.
    """
    mv = np.frombuffer(payload, np.uint8)
    nbx = -(-width // 4)
    nby = -(-rows // 4)
    p = 0
    planes: list[tuple[str, int, np.ndarray]] = []
    for name, ptype in channels:
        if ptype != 1:  # FLOAT/UINT stored verbatim
            nbytes = rows * width * _PIXEL_SIZES[ptype]
            planes.append((name, ptype, mv[p : p + nbytes]))
            p += nbytes
            continue
        # pass 1: scan block offsets (3- vs 14-byte, sequential sizes)
        offs14, offs3, order = [], [], []
        for _ in range(nby * nbx):
            if p + 3 > len(mv):
                raise EnvDecodeError("B44 chunk truncated")
            if mv[p + 2] == 0xFC:
                order.append((True, len(offs3)))
                offs3.append(p)
                p += 3
            else:
                order.append((False, len(offs14)))
                offs14.append(p)
                p += 14
        # pass 2: vectorized unpack
        out_blocks = np.empty((nby * nbx, 4, 4), np.uint16)
        if offs3:
            b = mv[np.asarray(offs3)[:, None] + np.arange(2)].astype(np.uint16)
            t = (b[:, 0] << 8) | b[:, 1]
            flat = np.broadcast_to(t[:, None, None], (len(offs3), 4, 4))
        if offs14:
            b = mv[np.asarray(offs14)[:, None] + np.arange(14)].astype(
                np.uint32
            )
            t = np.empty((len(offs14), 16), np.uint32)
            t[:, 0] = (b[:, 0] << 8) | b[:, 1]
            shift = b[:, 2] >> 2
            bias = np.uint32(0x20) << shift
            f = np.empty((len(offs14), 15), np.uint32)
            f[:, 0] = ((b[:, 2] << 4) | (b[:, 3] >> 4)) & 0x3F
            f[:, 1] = ((b[:, 3] << 2) | (b[:, 4] >> 6)) & 0x3F
            f[:, 2] = b[:, 4] & 0x3F
            for col in range(3):
                base = 3 + col * 4
                i0 = 5 + col * 3
                f[:, base + 0] = b[:, i0] >> 2
                f[:, base + 1] = ((b[:, i0] << 4) | (b[:, i0 + 1] >> 4)) & 0x3F
                f[:, base + 2] = ((b[:, i0 + 1] << 2) | (b[:, i0 + 2] >> 6)) & 0x3F
                f[:, base + 3] = b[:, i0 + 2] & 0x3F
            d = (f << shift[:, None]) - bias[:, None]
            # column 0 chains down; columns 1..3 chain across per row
            for y in (1, 2, 3):
                t[:, y * 4] = t[:, (y - 1) * 4] + d[:, y - 1]
            for x in (1, 2, 3):
                for y in range(4):
                    t[:, y * 4 + x] = t[:, y * 4 + x - 1] + d[:, 4 * x + y - 1]
            packed = (t & 0xFFFF).astype(np.uint16).reshape(-1, 4, 4)
        for bi, (is_flat, k) in enumerate(order):
            out_blocks[bi] = flat[k] if is_flat else packed[k]
        # monotonic transform inverse
        tt = out_blocks
        s = np.where(tt & 0x8000, tt & 0x7FFF, ~tt & 0xFFFF).astype(np.uint16)
        # blocks -> (padded rows, padded cols) plane -> clip
        plane = (
            s.reshape(nby, nbx, 4, 4)
            .transpose(0, 2, 1, 3)
            .reshape(nby * 4, nbx * 4)[:rows, :width]
        )
        planes.append((name, ptype, plane.astype("<u2").view(np.uint8)))
    # interleave into the chunk layout scatter() expects: per row, channels
    # in header order
    out = bytearray()
    for r in range(rows):
        for name, ptype, data in planes:
            nbytes = width * _PIXEL_SIZES[ptype]
            out += bytes(
                data.reshape(rows, nbytes)[r]
                if ptype == 1
                else data[r * nbytes : (r + 1) * nbytes]
            )
    return bytes(out)


def _make_decomp(compression: int, channels):
    """-> (lines_per_chunk, decomp(payload, expected, width, rows))."""
    if compression == 0:
        return 1, lambda b, expected, width, rows: b
    if compression == 2:  # ZIPS
        return 1, lambda b, expected, width, rows: _maybe_unzip(b, expected)
    if compression == 3:  # ZIP
        return 16, lambda b, expected, width, rows: _maybe_unzip(b, expected)
    if compression == 4:  # PIZ
        from volxel_tpu_torch.ingest.piz import PizError, piz_uncompress

        piz_channels = [
            (_PIXEL_SIZES[pt] // 2, _PIXEL_SIZES[pt]) for _, pt in channels
        ]

        def _unpiz(b, expected, width, rows):
            if len(b) == expected:
                return b  # writer stored raw when compression didn't help
            try:
                return piz_uncompress(b, piz_channels, width, rows)
            except PizError as e:
                raise EnvDecodeError(f"PIZ decode failed: {e}") from e

        return 32, _unpiz
    if compression == 5:  # PXR24

        def _pxr(b, expected, width, rows):
            if len(b) == expected:
                return b
            return _unpxr24(b, channels, width, rows)

        return 16, _pxr
    if compression in (6, 7):  # B44 / B44A

        def _b44(b, expected, width, rows):
            if len(b) == expected:
                return b
            return _unb44(b, channels, width, rows)

        return 32, _b44
    if compression in (8, 9):  # DWAA / DWAB
        from volxel_tpu_torch.ingest.dwa import DwaError, dwa_uncompress

        def _dwa(b, expected, width, rows):
            if len(b) == expected:
                return b
            try:
                return dwa_uncompress(b, channels, width, rows)
            except DwaError as e:
                raise EnvDecodeError(f"DWA decode failed: {e}") from e

        return 32 if compression == 8 else 256, _dwa
    raise EnvDecodeError(
        f"EXR compression {compression} not supported "
        "(NONE/ZIPS/ZIP/PIZ/PXR24/B44/B44A/DWAA/DWAB only)"
    )


def decode_exr(data: bytes) -> np.ndarray:
    buf = memoryview(data)
    if len(data) < 8 or struct.unpack_from("<I", buf, 0)[0] != MAGIC:
        raise EnvDecodeError("Not an OpenEXR stream")
    version, flags = buf[4], buf[5]
    if version != 2:
        raise EnvDecodeError(f"Unsupported EXR version {version}")
    tiled = bool(flags & 0x02)
    if flags & 0x10 or flags & 0x08:
        raise EnvDecodeError("Multi-part/deep EXR is not supported")

    pos = 8
    channels = None
    data_window = None
    compression = None
    tile_desc = None
    while True:
        if buf[pos] == 0:
            pos += 1
            break
        name, pos = _read_cstring(buf, pos)
        _type, pos = _read_cstring(buf, pos)
        size = struct.unpack_from("<i", buf, pos)[0]
        pos += 4
        value = bytes(buf[pos : pos + size])
        pos += size
        if name == "channels":
            channels = _parse_channels(value)
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", value)
        elif name == "compression":
            compression = value[0]
        elif name == "tiles":
            tx, ty, mode = struct.unpack("<IIB", value)
            tile_desc = (tx, ty, mode & 0xF, mode >> 4)

    if channels is None or data_window is None or compression is None:
        raise EnvDecodeError("EXR header missing required attributes")
    x_min, y_min, x_max, y_max = data_window
    width = x_max - x_min + 1
    height = y_max - y_min + 1

    lines_per_chunk, decomp = _make_decomp(compression, channels)

    ch_sizes = {name: _PIXEL_SIZES[pt] for name, pt in channels}
    row_bytes_per_px = sum(ch_sizes[n] for n, _ in channels)
    planes = {
        name: np.zeros((height, width), np.float32)
        for name, _ in channels
        if name in ("R", "G", "B", "A", "Y")
    }

    def scatter(payload: bytes, x0: int, y0: int, w: int, rows: int) -> None:
        p = 0
        for r in range(rows):
            row = y0 + r
            for name, ptype in channels:  # header (alphabetical) order
                nbytes = w * ch_sizes[name]
                if name in planes:
                    vals = np.frombuffer(
                        payload, _PIXEL_DTYPES[ptype], count=w, offset=p
                    )
                    planes[name][row, x0 : x0 + w] = vals.astype(np.float32)
                p += nbytes

    if tiled:
        if tile_desc is None:
            raise EnvDecodeError("Tiled EXR missing the tiles attribute")
        tw, th, mode, _rounding = tile_desc
        if mode == 2:
            raise EnvDecodeError("Ripmap EXR is not supported")
        # ONE_LEVEL, or level (0,0) of a MIPMAP file — its tiles come
        # first in the offset table either way
        nx = -(-width // tw)
        ny = -(-height // th)
        offsets = struct.unpack_from(f"<{nx * ny}q", buf, pos)
        for off in offsets:
            dx, dy, lx, ly, chunk_size = struct.unpack_from("<5i", buf, off)
            if lx != 0 or ly != 0:
                continue
            payload = bytes(buf[off + 20 : off + 20 + chunk_size])
            w = min(tw, width - dx * tw)
            rows = min(th, height - dy * th)
            expected = rows * row_bytes_per_px * w
            payload = decomp(payload, expected, w, rows)
            if len(payload) != expected:
                raise EnvDecodeError("EXR tile size mismatch")
            scatter(payload, dx * tw, dy * th, w, rows)
    else:
        n_chunks = -(-height // lines_per_chunk)
        offsets = struct.unpack_from(f"<{n_chunks}q", buf, pos)
        for off in offsets:
            y, chunk_size = struct.unpack_from("<ii", buf, off)
            payload = bytes(buf[off + 8 : off + 8 + chunk_size])
            rows = min(lines_per_chunk, y_max - y + 1)
            expected = rows * row_bytes_per_px * width
            payload = decomp(payload, expected, width, rows)
            if len(payload) != expected:
                raise EnvDecodeError("EXR chunk size mismatch")
            scatter(payload, 0, y - y_min, width, rows)

    out = np.zeros((height, width, 4), np.float32)
    if "Y" in planes and "R" not in planes:
        out[..., 0] = out[..., 1] = out[..., 2] = planes["Y"]
    else:
        for i, name in enumerate(("R", "G", "B")):
            if name in planes:
                out[..., i] = planes[name]
    out[..., 3] = planes["A"] if "A" in planes else 1.0
    return out


def _maybe_unzip(payload: bytes, expected: int) -> bytes:
    # the writer stores raw data when compression doesn't help
    if len(payload) == expected:
        return payload
    return _unzip_block(payload)


def encode_exr_piz(image: np.ndarray, half: bool = True) -> bytes:
    """Write a PIZ-compressed scanline EXR (HALF or FLOAT RGB), shaped like
    a typical polyhaven HDRI export (extra string/chromaticities attrs,
    B/G/R channel order, 32-line chunks). Fixture/test writer."""
    from volxel_tpu_torch.ingest.piz import piz_compress

    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    ptype = 1 if half else 2
    nbytes = 2 if half else 4

    def attr(name: bytes, typ: bytes, value: bytes) -> bytes:
        return name + b"\x00" + typ + b"\x00" + struct.pack("<i", len(value)) + value

    names = [b"B", b"G", b"R"]
    chan = b""
    for n in names:
        chan += n + b"\x00" + struct.pack("<iBBBBii", ptype, 0, 0, 0, 0, 1, 1)
    chan += b"\x00"

    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = b""
    header += attr(b"channels", b"chlist", chan)
    header += attr(
        b"chromaticities",
        b"chromaticities",
        struct.pack("<8f", 0.64, 0.33, 0.3, 0.6, 0.15, 0.06, 0.3127, 0.329),
    )
    header += attr(b"comments", b"string", b"synthetic polyhaven-style fixture")
    header += attr(b"compression", b"compression", b"\x04")  # PIZ
    header += attr(b"dataWindow", b"box2i", box)
    header += attr(b"displayWindow", b"box2i", box)
    header += attr(b"lineOrder", b"lineOrder", b"\x00")
    header += attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += attr(b"screenWindowCenter", b"v2f", struct.pack("<2f", 0, 0))
    header += attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"

    head = struct.pack("<IBBBB", MAGIC, 2, 0, 0, 0) + header
    dt = "<f2" if half else "<f4"
    idx = {b"R": 0, b"G": 1, b"B": 2}
    piz_channels = [(nbytes // 2, nbytes)] * len(names)

    n_chunks = -(-h // 32)
    chunks = []
    for c in range(n_chunks):
        y0 = c * 32
        rows = min(32, h - y0)
        raw = b"".join(
            np.ascontiguousarray(img[y0 + r, :, idx[n]]).astype(dt).tobytes()
            for r in range(rows)
            for n in names
        )
        payload = piz_compress(raw, piz_channels, w, rows)
        if len(payload) >= len(raw):
            payload = raw  # store raw when compression doesn't help
        chunks.append(struct.pack("<ii", y0, len(payload)) + payload)

    table_pos = len(head)
    pos = table_pos + 8 * n_chunks
    offsets = []
    for chunk in chunks:
        offsets.append(pos)
        pos += len(chunk)
    return head + struct.pack(f"<{n_chunks}q", *offsets) + b"".join(chunks)


def encode_exr_uncompressed(image: np.ndarray) -> bytes:
    """Write a minimal uncompressed FLOAT RGB(A) EXR (fixtures/tests)."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    has_a = img.shape[2] >= 4

    def attr(name: bytes, typ: bytes, value: bytes) -> bytes:
        return name + b"\x00" + typ + b"\x00" + struct.pack("<i", len(value)) + value

    names = [b"A", b"B", b"G", b"R"] if has_a else [b"B", b"G", b"R"]
    chan = b""
    for n in names:
        chan += n + b"\x00" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)
    chan += b"\x00"

    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = b""
    header += attr(b"channels", b"chlist", chan)
    header += attr(b"compression", b"compression", b"\x00")
    header += attr(b"dataWindow", b"box2i", box)
    header += attr(b"displayWindow", b"box2i", box)
    header += attr(b"lineOrder", b"lineOrder", b"\x00")
    header += attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += attr(b"screenWindowCenter", b"v2f", struct.pack("<2f", 0, 0))
    header += attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"

    head = struct.pack("<IBBBB", MAGIC, 2, 0, 0, 0) + header
    line_bytes = len(names) * w * 4
    table_pos = len(head)
    data_start = table_pos + 8 * h

    chunks = []
    offsets = []
    pos = data_start
    idx = {b"R": 0, b"G": 1, b"B": 2, b"A": 3}
    for y in range(h):
        payload = b"".join(
            np.ascontiguousarray(img[y, :, idx[n]], np.float32).tobytes()
            for n in names
        )
        chunk = struct.pack("<ii", y, line_bytes) + payload
        offsets.append(pos)
        chunks.append(chunk)
        pos += len(chunk)

    return head + struct.pack(f"<{h}q", *offsets) + b"".join(chunks)
