"""Self-contained JPEG decoder for DICOM encapsulated pixel data.

Covers the compressed transfer syntaxes the reference accepts through
dicom-pixeldata's "jpeg" feature (dicom_preprocessor/Cargo.toml:25):

  * SOF3  — JPEG Lossless (process 14), incl. selection value 1: the
            dominant CT archive encoding (DICOM 1.2.840.10008.1.2.4.57/.70)
  * SOF0  — JPEG Baseline 8-bit DCT (1.2.840.10008.1.2.4.50)
  * SOF1  — JPEG Extended sequential 12-bit DCT (1.2.840.10008.1.2.4.51)

Single-component (grayscale) images only — the ingest pipeline enforces
1 sample/pixel anyway (lib.rs:77-84). Pure Python/numpy: the Huffman
entropy decode is a table-driven Python loop (a 64K lookup keyed on a
16-bit peek), the IDCT is a vectorized numpy einsum over all blocks.
A minimal SV1 lossless *encoder* lives here too, used to build test
fixtures that round-trip bit-exactly.
"""

from __future__ import annotations

import struct

import numpy as np


class JpegError(ValueError):
    pass


# -- markers -------------------------------------------------------------------

SOI = 0xD8
EOI = 0xD9
SOS = 0xDA
DQT = 0xDB
DHT = 0xC4
DRI = 0xDD
SOF0 = 0xC0
SOF1 = 0xC1
SOF2 = 0xC2
SOF3 = 0xC3
RST0 = 0xD0

ZIGZAG = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    ],
    dtype=np.int32,
)

# IDCT basis: T[u, x] = C(u)/2 * cos((2x+1) u pi / 16)
_IDCT_T = np.zeros((8, 8), np.float64)
for _u in range(8):
    _c = (1.0 / np.sqrt(2.0)) if _u == 0 else 1.0
    for _x in range(8):
        _IDCT_T[_u, _x] = 0.5 * _c * np.cos((2 * _x + 1) * _u * np.pi / 16.0)


class _HuffTable:
    """Canonical Huffman decode table with a 16-bit peek LUT."""

    def __init__(self, counts: list[int], symbols: bytes):
        self.lut = np.zeros(1 << 16, np.uint32)  # (length << 16) | symbol
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                sym = symbols[k]
                k += 1
                lo = code << (16 - length)
                hi = lo + (1 << (16 - length))
                self.lut[lo:hi] = (length << 16) | sym
                code += 1
            code <<= 1

    def decode(self, peek16: int) -> tuple[int, int]:
        """(symbol, code length) for a 16-bit lookahead."""
        v = int(self.lut[peek16])
        length = v >> 16
        if length == 0:
            raise JpegError("invalid Huffman code")
        return v & 0xFFFF, length


class _BitReader:
    """MSB-first bit reader over an unstuffed entropy-coded segment."""

    def __init__(self, data: bytes):
        # pad so 16-bit peeks never run off the end
        self.data = data + b"\x00\x00\x00"
        self.bitpos = 0

    def peek16(self) -> int:
        byte = self.bitpos >> 3
        sh = self.bitpos & 7
        w = int.from_bytes(self.data[byte : byte + 3], "big")
        return (w >> (8 - sh)) & 0xFFFF

    def skip(self, n: int):
        self.bitpos += n

    def receive(self, n: int) -> int:
        if n == 0:
            return 0
        byte = self.bitpos >> 3
        sh = self.bitpos & 7
        w = int.from_bytes(self.data[byte : byte + 4], "big")
        self.bitpos += n
        return (w >> (32 - sh - n)) & ((1 << n) - 1)

    def align(self):
        self.bitpos = (self.bitpos + 7) & ~7


def _extend(value: int, s: int) -> int:
    """T.81 F.2.2.1 sign extension of an s-bit magnitude."""
    if s == 0:
        return 0
    if value < (1 << (s - 1)):
        return value - (1 << s) + 1
    return value


def _unstuff(data: bytes, start: int) -> tuple[list[bytes], int]:
    """Split the entropy-coded segment into per-restart-interval chunks with
    0xFF00 stuffing removed. Returns (chunks, offset of the end marker)."""
    chunks = []
    out = bytearray()
    i = start
    n = len(data)
    while i < n:
        b = data[i]
        if b != 0xFF:
            out.append(b)
            i += 1
            continue
        nxt = data[i + 1] if i + 1 < n else 0xD9
        if nxt == 0x00:
            out.append(0xFF)
            i += 2
        elif RST0 <= nxt <= RST0 + 7:
            chunks.append(bytes(out))
            out = bytearray()
            i += 2
        else:
            break
    chunks.append(bytes(out))
    return chunks, i


class _Frame:
    precision: int
    height: int
    width: int
    lossless: bool


def _parse_segments(data: bytes):
    """Walk marker segments up to (and including) the first SOS."""
    if data[:2] != bytes((0xFF, SOI)):
        raise JpegError("not a JPEG stream (missing SOI)")
    pos = 2
    qt: dict[int, np.ndarray] = {}
    huff: dict[tuple[int, int], _HuffTable] = {}
    frame = None
    restart_interval = 0
    scan = None
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise JpegError(f"expected marker at {pos}")
        marker = data[pos + 1]
        if marker == EOI:
            break
        seglen = struct.unpack_from(">H", data, pos + 2)[0]
        body = data[pos + 4 : pos + 2 + seglen]
        pos += 2 + seglen
        if marker == DQT:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                i += 1
                if pq:
                    table = np.frombuffer(body[i : i + 128], ">u2").astype(np.int32)
                    i += 128
                else:
                    table = np.frombuffer(body[i : i + 64], np.uint8).astype(np.int32)
                    i += 64
                qt[tq] = table
        elif marker == DHT:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1 : i + 17])
                nsym = sum(counts)
                symbols = bytes(body[i + 17 : i + 17 + nsym])
                huff[(tc, th)] = _HuffTable(counts, symbols)
                i += 17 + nsym
        elif marker in (SOF0, SOF1, SOF3):
            frame = _Frame()
            frame.lossless = marker == SOF3
            frame.precision = body[0]
            frame.height, frame.width = struct.unpack_from(">HH", body, 1)
            nf = body[5]
            if nf != 1:
                raise JpegError(
                    f"only single-component (grayscale) JPEG is supported, got {nf}"
                )
            h, v = body[7] >> 4, body[7] & 15
            if (h, v) != (1, 1):
                raise JpegError("subsampled JPEG not supported")
            frame.qtable = body[8]
        elif marker == SOF2:
            raise JpegError("progressive JPEG is not supported")
        elif marker == DRI:
            restart_interval = struct.unpack_from(">H", body, 0)[0]
        elif marker == SOS:
            ns = body[0]
            if ns != 1:
                raise JpegError("multi-component scan not supported")
            td, ta = body[2] >> 4, body[2] & 15
            ss, _se, ahal = body[3], body[4], body[5]
            scan = dict(td=td, ta=ta, ss=ss, al=ahal & 15)
            return frame, qt, huff, restart_interval, scan, pos
        # other markers (APPn, COM) are skipped
    raise JpegError("no SOS marker found")


def decode(data: bytes) -> np.ndarray:
    """Decode a grayscale JPEG (SOF0/SOF1/SOF3) to a 2D uint16 array."""
    frame, qt, huff, ri, scan, pos = _parse_segments(data)
    if frame is None:
        raise JpegError("missing SOF before SOS")
    chunks, _end = _unstuff(data, pos)
    if frame.lossless:
        return _decode_lossless(frame, huff[(0, scan["td"])], chunks, ri, scan)
    return _decode_dct(frame, qt, huff, chunks, ri, scan)


def _decode_lossless(frame, table, chunks, ri, scan) -> np.ndarray:
    w, h, p = frame.width, frame.height, frame.precision
    pt = scan["al"]
    predictor = scan["ss"]
    if not 1 <= predictor <= 7:
        raise JpegError(f"invalid lossless predictor {predictor}")
    out = np.zeros((h, w), np.int32)
    default = 1 << (p - pt - 1)
    mask = 0xFFFF

    lut = table.lut
    total = 0  # samples decoded so far
    idx = 0

    # native fast path (bit-exact counterpart; ~40x the Python loop)
    from volxel_tpu_torch.native.loader import jpeg_lossless_chunk, native_available

    if native_available():
        flat = out.reshape(-1)
        for chunk in chunks:
            n_samples = min(ri if ri else h * w - total, h * w - total)
            got = jpeg_lossless_chunk(
                chunk, lut, flat, w, idx, n_samples, predictor, default
            )
            if got < 0:
                raise JpegError("invalid Huffman code in lossless scan")
            idx += n_samples
            total += n_samples
            if total >= h * w:
                break
        if total < h * w:
            raise JpegError(f"truncated lossless scan: {total}/{h * w} samples")
        return (out << pt).astype(np.uint16)

    for chunk in chunks:
        reader = _BitReader(chunk)
        n_samples = ri if ri else h * w - total
        n_samples = min(n_samples, h * w - total)
        # decode diffs for this restart interval
        diffs = np.empty(n_samples, np.int32)
        data_local = reader.data
        bitpos = 0
        for i in range(n_samples):
            byte = bitpos >> 3
            sh = bitpos & 7
            peek = (
                int.from_bytes(data_local[byte : byte + 3], "big") >> (8 - sh)
            ) & 0xFFFF
            v = int(lut[peek])
            length = v >> 16
            if length == 0:
                raise JpegError("invalid Huffman code in lossless scan")
            s = v & 0xFFFF
            bitpos += length
            if s == 16:
                diffs[i] = 32768
            elif s == 0:
                diffs[i] = 0
            else:
                byte = bitpos >> 3
                sh = bitpos & 7
                bits = (
                    int.from_bytes(data_local[byte : byte + 4], "big")
                    >> (32 - sh - s)
                ) & ((1 << s) - 1)
                bitpos += s
                diffs[i] = _extend(bits, s)
        # reconstruct this interval (row-major flat order)
        flat = out.reshape(-1)
        start_new_interval = True
        for i in range(n_samples):
            j = idx + i
            y, x = divmod(j, w)
            if start_new_interval or (y == 0 and x == 0):
                px = default
                start_new_interval = False
            elif y == 0:
                px = flat[j - 1]  # first line: predictor 1
            elif x == 0:
                px = flat[j - w]  # first column: predictor 2
            else:
                ra = int(flat[j - 1])
                rb = int(flat[j - w])
                rc = int(flat[j - w - 1])
                if predictor == 1:
                    px = ra
                elif predictor == 2:
                    px = rb
                elif predictor == 3:
                    px = rc
                elif predictor == 4:
                    px = ra + rb - rc
                elif predictor == 5:
                    px = ra + ((rb - rc) >> 1)
                elif predictor == 6:
                    px = rb + ((ra - rc) >> 1)
                else:
                    px = (ra + rb) >> 1
            flat[j] = (int(px) + int(diffs[i])) & mask
        idx += n_samples
        total += n_samples
        if total >= h * w:
            break
    if total < h * w:
        raise JpegError(f"truncated lossless scan: {total}/{h * w} samples")
    return (out << pt).astype(np.uint16)


def _decode_dct(frame, qt, huff, chunks, ri, scan) -> np.ndarray:
    w, h, p = frame.width, frame.height, frame.precision
    bw = (w + 7) // 8
    bh = (h + 7) // 8
    n_blocks = bw * bh
    dc_table = huff[(0, scan["td"])]
    ac_table = huff[(1, scan["ta"])]
    quant = qt[frame.qtable]

    coeffs = np.zeros((n_blocks, 64), np.int32)
    block = 0
    pred_dc = 0
    for chunk in chunks:
        reader = _BitReader(chunk)
        n = ri if ri else n_blocks - block
        n = min(n, n_blocks - block)
        pred_dc = 0  # DC prediction resets at restart intervals
        for _ in range(n):
            s, length = dc_table.decode(reader.peek16())
            reader.skip(length)
            diff = _extend(reader.receive(s), s)
            pred_dc += diff
            coeffs[block, 0] = pred_dc
            k = 1
            while k < 64:
                rs, length = ac_table.decode(reader.peek16())
                reader.skip(length)
                r, s = rs >> 4, rs & 15
                if s == 0:
                    if r == 15:
                        k += 16  # ZRL
                        continue
                    break  # EOB
                k += r
                if k > 63:
                    raise JpegError("AC run past end of block")
                coeffs[block, k] = _extend(reader.receive(s), s)
                k += 1
            block += 1
        if block >= n_blocks:
            break
    if block < n_blocks:
        raise JpegError(f"truncated DCT scan: {block}/{n_blocks} blocks")

    # dequantize + dezigzag + IDCT, vectorized over all blocks
    dq = coeffs * quant[None, :]
    fmat = np.zeros((n_blocks, 64), np.float64)
    fmat[:, ZIGZAG] = dq
    fmat = fmat.reshape(n_blocks, 8, 8)
    spatial = np.einsum("ux,nuv,vy->nxy", _IDCT_T, fmat, _IDCT_T)
    level = 1 << (p - 1)
    pixels = np.clip(np.round(spatial) + level, 0, (1 << p) - 1).astype(np.uint16)
    img = (
        pixels.reshape(bh, bw, 8, 8)
        .transpose(0, 2, 1, 3)
        .reshape(bh * 8, bw * 8)
    )
    return img[:h, :w]


# -- SV1 lossless encoder (test fixtures) ---------------------------------------


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int):
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            byte = (self.acc >> (self.nbits - 8)) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0x00)  # stuffing
            self.nbits -= 8
        self.acc &= (1 << self.nbits) - 1

    def flush(self):
        if self.nbits:
            self.write(0x7F, 8 - self.nbits)  # pad with 1s... (see below)


# category-code lengths for symbols 0..16 (valid canonical set, Kraft < 1)
_ENC_LENGTHS = [3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15]


def _build_enc_table():
    counts = [0] * 16
    for length in _ENC_LENGTHS:
        counts[length - 1] += 1
    # canonical assignment in symbol order grouped by length
    order = sorted(range(17), key=lambda s: (_ENC_LENGTHS[s], s))
    codes = {}
    code = 0
    prev_len = _ENC_LENGTHS[order[0]]
    for sym in order:
        length = _ENC_LENGTHS[sym]
        code <<= length - prev_len
        prev_len = length
        codes[sym] = (code, length)
        code += 1
    symbols = bytes(order)
    return counts, symbols, codes


def encode_lossless_sv1(img: np.ndarray, precision: int) -> bytes:
    """Encode a 2D uint16 image as JPEG lossless process 14, SV1 (the
    1.2.840.10008.1.2.4.70 payload). Round-trips bit-exactly via decode()."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("expected a 2D image")
    h, w = img.shape
    counts, symbols, codes = _build_enc_table()

    out = bytearray()
    out += bytes((0xFF, SOI))
    # SOF3
    sof = struct.pack(">BHHB", precision, h, w, 1) + bytes((1, 0x11, 0))
    out += bytes((0xFF, SOF3)) + struct.pack(">H", len(sof) + 2) + sof
    # DHT (class 0, id 0)
    dht = bytes((0x00,)) + bytes(counts) + symbols
    out += bytes((0xFF, DHT)) + struct.pack(">H", len(dht) + 2) + dht
    # SOS: predictor 1, point transform 0
    sos = bytes((1, 1, 0x00, 1, 0, 0))
    out += bytes((0xFF, SOS)) + struct.pack(">H", len(sos) + 2) + sos

    bw = _BitWriter()
    default = 1 << (precision - 1)
    prev_row = None
    for y in range(h):
        row = img[y].astype(np.int64)
        if y == 0:
            pred = np.empty(w, np.int64)
            pred[0] = default
            pred[1:] = row[:-1]
        else:
            pred = np.empty(w, np.int64)
            pred[0] = prev_row[0]
            pred[1:] = row[:-1]
        diffs = (row - pred) & 0xFFFF
        # interpret as signed 16-bit modulo difference
        sdiff = np.where(diffs >= 32768, diffs - 65536, diffs)
        for d in sdiff:
            d = int(d)
            if d == -32768:
                d = 32768  # category 16, no extra bits
            mag = abs(d)
            s = mag.bit_length()
            code, length = codes[s]
            bw.write(code, length)
            if s == 16:
                pass
            elif s:
                bits = d if d >= 0 else d + (1 << s) - 1
                bw.write(bits, s)
        prev_row = row
    bw.flush()
    out += bw.out
    out += bytes((0xFF, EOI))
    return bytes(out)
