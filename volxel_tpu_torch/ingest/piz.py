"""PIZ codec (OpenEXR's wavelet + Huffman compression) in numpy/Python.

PIZ is the most common compression of wild HDRI environment maps; the
reference reads it through the Rust `image`/`exr` crates
(dicom_preprocessor/src/hdr.rs:23-36, Cargo.toml:31). Implemented from the
OpenEXR format: per 32-scanline chunk —

  compress:   bitmap of occurring u16 values -> forward LUT -> 2D integer
              Haar-like wavelet per channel (mod-2^14 or mod-2^16
              arithmetic) -> canonical Huffman with an RLE pseudo-symbol
  uncompress: the exact inverses in reverse order

Both directions are implemented so tests can pin lossless round-trips of
HALF and FLOAT channel data; the wavelet transforms are vectorized numpy,
the Huffman entropy coder is a Python loop with a 16-bit peek LUT (the
same technique as ingest/jpeg.py).

Payload layout: u16 minNonZero, u16 maxNonZero, bitmap[min..max] bytes,
u32 huffman byte length, huffman data (20-byte header: im, iM,
tableLength, nBits, room; 6-bit-packed code lengths with zero-run codes;
MSB-first entropy bits).
"""

from __future__ import annotations

import heapq
import struct

import numpy as np

USHORT_RANGE = 1 << 16
BITMAP_SIZE = USHORT_RANGE >> 3  # 8192
HUF_ENCSIZE = USHORT_RANGE + 1  # one extra slot: the RLE pseudo-symbol
SHORT_ZEROCODE_RUN = 59
LONG_ZEROCODE_RUN = 63
SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN  # 6
MAX_CODE_LEN = 58

NBITS = 16
A_OFFSET = 1 << (NBITS - 1)
MOD_MASK = (1 << NBITS) - 1


class PizError(ValueError):
    pass


# -- bitmap / LUT ----------------------------------------------------------------


def bitmap_from_data(data: np.ndarray) -> np.ndarray:
    present = np.zeros(USHORT_RANGE, bool)
    present[data] = True
    present[0] = False  # zero is always implicitly present
    return np.packbits(present, bitorder="little")


def forward_lut(bitmap: np.ndarray) -> tuple[np.ndarray, int]:
    present = np.unpackbits(bitmap, bitorder="little").astype(bool)
    present[0] = True
    lut = np.zeros(USHORT_RANGE, np.uint16)
    idx = np.flatnonzero(present)
    lut[idx] = np.arange(len(idx), dtype=np.uint16)
    return lut, len(idx) - 1  # maxValue


def reverse_lut(bitmap: np.ndarray) -> tuple[np.ndarray, int]:
    present = np.unpackbits(bitmap, bitorder="little").astype(bool)
    present[0] = True
    idx = np.flatnonzero(present)
    lut = np.zeros(USHORT_RANGE, np.uint16)
    lut[: len(idx)] = idx.astype(np.uint16)
    return lut, len(idx) - 1


# -- 2D wavelet (ImfWav semantics) -----------------------------------------------


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai.astype(np.int16)
    b = (ai - hs).astype(np.int16)
    return a.astype(np.uint16), b.astype(np.uint16)


def _wenc14(a, b):
    as_ = a.astype(np.int16).astype(np.int32)
    bs = b.astype(np.int16).astype(np.int32)
    m = (as_ + bs) >> 1
    d = as_ - bs
    return m.astype(np.int16).astype(np.uint16), d.astype(np.int16).astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int64)
    d = h.astype(np.int64)
    bb = (m - (d >> 1)) & MOD_MASK
    aa = (d + bb - A_OFFSET) & MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wenc16(a, b):
    ao = (a.astype(np.int64) + A_OFFSET) & MOD_MASK
    bi = b.astype(np.int64)
    m = (ao + bi) >> 1
    d = ao - bi
    m = np.where(d < 0, (m + A_OFFSET) & MOD_MASK, m)
    d &= MOD_MASK
    return m.astype(np.uint16), d.astype(np.uint16)


def _wav2_level_indices(nx: int, ox: int, ny: int, oy: int, p: int, p2: int):
    """Index sets for one wavelet level, mirroring ImfWav's loop bounds:
    full 2x2 groups at multiples of p2 with y <= ny-p2 and x <= nx-p2; a
    trailing vertical-only column at the loop-exit x when (nx & p); a
    trailing horizontal-only row at the loop-exit y when (ny & p)."""
    ys = np.arange(0, max(ny - p2, -1) + 1, p2, dtype=np.int64)
    xs = np.arange(0, max(nx - p2, -1) + 1, p2, dtype=np.int64)
    base = ys[:, None] * oy + xs[None, :] * ox
    full = (
        base.ravel(),
        (base + ox * p).ravel(),
        (base + oy * p).ravel(),
        (base + oy * p + ox * p).ravel(),
    )
    col = (np.zeros(0, np.int64),) * 2
    if nx & p:
        x_t = len(xs) * p2
        c = ys * oy + x_t * ox
        col = (c, c + oy * p)
    row = (np.zeros(0, np.int64),) * 2
    if ny & p:
        y_t = len(ys) * p2
        r = y_t * oy + xs * ox
        row = (r, r + ox * p)
    return full, col, row


def wav2_decode(buf: np.ndarray, nx: int, ox: int, ny: int, oy: int, mx: int):
    """In-place inverse 2D wavelet on a strided (ny, nx) plane of `buf`."""
    dec = _wdec14 if mx < (1 << 14) else _wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        (f00, f01, f10, f11), (c0, c1), (r0, r1) = _wav2_level_indices(
            nx, ox, ny, oy, p, p2
        )
        if len(f00):
            t00, t10 = dec(buf[f00], buf[f10])
            t01, t11 = dec(buf[f01], buf[f11])
            a00, a01 = dec(t00, t01)
            a10, a11 = dec(t10, t11)
            buf[f00], buf[f01], buf[f10], buf[f11] = a00, a01, a10, a11
        if len(c0):
            a, b = dec(buf[c0], buf[c1])
            buf[c0], buf[c1] = a, b
        if len(r0):
            a, b = dec(buf[r0], buf[r1])
            buf[r0], buf[r1] = a, b
        p2 = p
        p >>= 1


def wav2_encode(buf: np.ndarray, nx: int, ox: int, ny: int, oy: int, mx: int):
    """In-place forward 2D wavelet (exact inverse of wav2_decode)."""
    enc = _wenc14 if mx < (1 << 14) else _wenc16
    n = min(nx, ny)
    p = 1
    while (p << 1) <= n:
        p2 = p << 1
        (f00, f01, f10, f11), (c0, c1), (r0, r1) = _wav2_level_indices(
            nx, ox, ny, oy, p, p2
        )
        if len(f00):
            t00, t01 = enc(buf[f00], buf[f01])
            t10, t11 = enc(buf[f10], buf[f11])
            a00, a10 = enc(t00, t10)
            a01, a11 = enc(t01, t11)
            buf[f00], buf[f01], buf[f10], buf[f11] = a00, a01, a10, a11
        if len(c0):
            a, b = enc(buf[c0], buf[c1])
            buf[c0], buf[c1] = a, b
        if len(r0):
            a, b = enc(buf[r0], buf[r1])
            buf[r0], buf[r1] = a, b
        p = p2


# -- Huffman coder (ImfHuf semantics) --------------------------------------------


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical codes per OpenEXR's hufCanonicalCodeTable: shortest
    lengths get the numerically largest prefixes; codes increase with
    symbol index inside a length class. Returns uint64 codes."""
    n = np.zeros(59, np.uint64)
    for l in lengths[lengths > 0]:
        n[l] += 1
    c = np.uint64(0)
    start = np.zeros(59, np.uint64)
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> np.uint64(1)
        start[i] = c
        c = nc
    codes = np.zeros(len(lengths), np.uint64)
    counters = start.copy()
    for sym in np.flatnonzero(lengths > 0):
        l = lengths[sym]
        codes[sym] = counters[l]
        counters[l] += np.uint64(1)
    return codes


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int):
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.out.append((self.acc >> (self.nbits - 8)) & 0xFF)
            self.nbits -= 8
        self.acc &= (1 << self.nbits) - 1

    def bit_length(self) -> int:
        return len(self.out) * 8 + self.nbits

    def flush(self) -> bytes:
        if self.nbits:
            self.out.append((self.acc << (8 - self.nbits)) & 0xFF)
            self.nbits = 0
        return bytes(self.out)


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data + b"\x00" * 8
        self.pos = 0

    def read(self, n: int) -> int:
        byte = self.pos >> 3
        sh = self.pos & 7
        w = int.from_bytes(self.data[byte : byte + 8], "big")
        self.pos += n
        return (w >> (64 - sh - n)) & ((1 << n) - 1)


def _pack_enc_table(lengths: np.ndarray, im: int, iM: int, bw: _BitWriter):
    i = im
    while i <= iM:
        l = int(lengths[i])
        if l == 0:
            zerun = 1
            while (
                i + zerun <= iM
                and zerun < 255 + SHORTEST_LONG_RUN
                and lengths[i + zerun] == 0
            ):
                zerun += 1
            if zerun >= 2:
                if zerun >= SHORTEST_LONG_RUN:
                    bw.write(LONG_ZEROCODE_RUN, 6)
                    bw.write(zerun - SHORTEST_LONG_RUN, 8)
                else:
                    bw.write(SHORT_ZEROCODE_RUN + zerun - 2, 6)
                i += zerun
                continue
        bw.write(l, 6)
        i += 1


def _unpack_enc_table(br: _BitReader, im: int, iM: int) -> np.ndarray:
    lengths = np.zeros(HUF_ENCSIZE, np.int32)
    i = im
    while i <= iM:
        l = br.read(6)
        if l == LONG_ZEROCODE_RUN:
            zerun = br.read(8) + SHORTEST_LONG_RUN
            i += zerun
        elif l >= SHORT_ZEROCODE_RUN:
            i += l - SHORT_ZEROCODE_RUN + 2
        else:
            lengths[i] = l
            i += 1
    if i > iM + 1:
        raise PizError("Huffman code-length table overrun")
    return lengths


def _build_decode_lut(lengths: np.ndarray, codes: np.ndarray):
    """16-bit peek LUT for codes with length <= 16 plus a dict for longer."""
    lut = np.zeros(1 << 16, np.uint64)  # (length << 32) | symbol
    long_codes: dict[tuple[int, int], int] = {}
    for sym in np.flatnonzero(lengths > 0):
        l = int(lengths[sym])
        code = int(codes[sym])
        if l <= 16:
            lo = code << (16 - l)
            hi = lo + (1 << (16 - l))
            lut[lo:hi] = (l << 32) | sym
        else:
            long_codes[(l, code)] = sym
    return lut, long_codes


def huf_compress(data: np.ndarray) -> bytes:
    """OpenEXR-format Huffman compression of u16 symbols with RLE."""
    data = np.asarray(data, np.uint32)
    if data.size == 0:
        return b""
    freq = np.bincount(data, minlength=HUF_ENCSIZE).astype(np.int64)
    iM = int(np.flatnonzero(freq)[-1]) + 1  # RLE pseudo-symbol slot
    freq[iM] = 1
    im = int(np.flatnonzero(freq)[0])

    # build code lengths (standard Huffman; OpenEXR's own heap construction
    # yields different-but-valid lengths — only the header matters)
    syms = np.flatnonzero(freq)
    heap = [(int(freq[s]), int(s), (int(s),)) for s in syms]
    heapq.heapify(heap)
    lengths = np.zeros(HUF_ENCSIZE, np.int32)
    if len(heap) == 1:
        lengths[heap[0][1]] = 1
    else:
        while len(heap) > 1:
            fa, _, members_a = heapq.heappop(heap)
            fb, tb, members_b = heapq.heappop(heap)
            for m in members_a + members_b:
                lengths[m] += 1
            heapq.heappush(heap, (fa + fb, tb, members_a + members_b))
    if lengths.max() > MAX_CODE_LEN:
        raise PizError("Huffman code longer than 58 bits (pathological input)")
    codes = _canonical_codes(lengths)

    table_bw = _BitWriter()
    _pack_enc_table(lengths, im, iM, table_bw)
    table_bytes = table_bw.flush()

    bw = _BitWriter()
    rlc_code, rlc_len = int(codes[iM]), int(lengths[iM])

    def send(sym: int, run: int):
        cl, cc = int(lengths[sym]), int(codes[sym])
        if cl + rlc_len + 8 < cl * run:
            bw.write(cc, cl)
            bw.write(rlc_code, rlc_len)
            bw.write(run, 8)
        else:
            for _ in range(run + 1):
                bw.write(cc, cl)

    s = int(data[0])
    cs = 0
    for v in data[1:]:
        v = int(v)
        if v == s and cs < 255:
            cs += 1
        else:
            send(s, cs)
            s = v
            cs = 0
    send(s, cs)
    n_bits = bw.bit_length()
    payload = bw.flush()

    header = struct.pack("<5I", im, iM, len(table_bytes), n_bits, 0)
    return header + table_bytes + payload


def huf_uncompress(data: bytes, n_out: int) -> np.ndarray:
    if n_out == 0:
        return np.zeros(0, np.uint16)
    if len(data) < 20:
        raise PizError("Huffman data shorter than its header")

    from volxel_tpu_torch.native.loader import native_available
    from volxel_tpu_torch.native.loader import huf_uncompress as native_huf

    if native_available():
        status, out = native_huf(data, n_out)
        if status == n_out:
            return out
        if status == -1:
            raise PizError(f"truncated Huffman data: .../{n_out} symbols")
        if status == -2:
            raise PizError("invalid Huffman code")
        if status == -3:
            raise PizError("invalid RLE run in Huffman data")
        raise PizError("corrupt Huffman header")

    im, iM, _table_len, n_bits, _room = struct.unpack_from("<5I", data, 0)
    if not (0 <= im < HUF_ENCSIZE and 0 <= iM < HUF_ENCSIZE):
        raise PizError("corrupt Huffman header")
    br = _BitReader(data[20:])
    lengths = _unpack_enc_table(br, im, iM)
    codes = _canonical_codes(lengths)
    lut, long_codes = _build_decode_lut(lengths, codes)

    # entropy data starts at the next byte boundary after the table
    br.pos = (br.pos + 7) & ~7
    base = br.pos
    raw = br.data
    bitpos = base
    end = base + n_bits
    # mirror of the native bound: n_bits is attacker-controlled and the
    # decode loop reads ~10 bytes at the current position; reject streams
    # whose claimed payload extends past the buffer (plus slack the Python
    # slices would silently zero-fill).
    if end > (len(data) - 20 + 7) * 8:
        raise PizError("corrupt Huffman header")
    rlc = iM
    out = np.empty(n_out, np.uint16)
    k = 0
    while k < n_out:
        if bitpos >= end:
            raise PizError(f"truncated Huffman data: {k}/{n_out} symbols")
        byte = bitpos >> 3
        sh = bitpos & 7
        peek = (
            int.from_bytes(raw[byte : byte + 3], "big") >> (8 - sh)
        ) & 0xFFFF
        v = int(lut[peek])
        l = v >> 32
        if l:
            sym = v & 0xFFFFFFFF
            bitpos += l
        else:
            # long code: extend bit by bit
            sym = None
            code = peek
            l = 16
            w = int.from_bytes(raw[byte : byte + 9], "big")
            total = 72 - sh
            while l < MAX_CODE_LEN and l < total:
                l += 1
                code = (w >> (total - l)) & ((1 << l) - 1)
                if (l, code) in long_codes:
                    sym = long_codes[(l, code)]
                    break
            if sym is None:
                raise PizError("invalid Huffman code")
            bitpos += l
        if sym == rlc:
            run = (
                int.from_bytes(raw[bitpos >> 3 : (bitpos >> 3) + 2], "big")
                >> (8 - (bitpos & 7))
            ) & 0xFF
            bitpos += 8
            if k == 0 or k + run > n_out:
                raise PizError("invalid RLE run in Huffman data")
            out[k : k + run] = out[k - 1]
            k += run
        else:
            out[k] = sym
            k += 1
    return out


# -- PIZ chunk codec -------------------------------------------------------------


def piz_uncompress(
    payload: bytes, channels: list[tuple[int, int]], width: int, rows: int
) -> bytes:
    """Decompress one PIZ chunk.

    channels: [(nx_u16_per_pixel a.k.a. size, bytes_per_sample)] in header
    order — size is 1 for HALF, 2 for FLOAT/UINT. Returns scanline-
    interleaved bytes (the layout exr.py's chunk loop consumes).
    """
    if len(payload) < 4:
        raise PizError("PIZ chunk too short")
    min_nz, max_nz = struct.unpack_from("<HH", payload, 0)
    pos = 4
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        count = max_nz - min_nz + 1
        bitmap[min_nz : max_nz + 1] = np.frombuffer(
            payload, np.uint8, count=count, offset=pos
        )
        pos += count
    (huf_len,) = struct.unpack_from("<I", payload, pos)
    pos += 4
    lut, max_value = reverse_lut(bitmap)

    sizes = [size for size, _ in channels]
    total = rows * width * sum(sizes)
    data = huf_uncompress(payload[pos : pos + huf_len], total)

    # wavelet-decode each channel sub-plane (for size=2 channels the two
    # u16 halves of each sample are independent planes at stride `size`)
    offset = 0
    for size in sizes:
        block = data[offset : offset + rows * width * size]
        for j in range(size):
            wav2_decode(block[j:], width, size, rows, width * size, max_value)
        offset += rows * width * size
    data = lut[data]

    # interleave back to scanline order
    blocks = []
    off2 = 0
    for size in sizes:
        blocks.append(
            data[off2 : off2 + rows * width * size].reshape(rows, width * size)
        )
        off2 += rows * width * size
    out = bytearray()
    for r in range(rows):
        for block in blocks:
            out += block[r].tobytes()
    return bytes(out)


def piz_compress(raw: bytes, channels: list[tuple[int, int]], width: int, rows: int) -> bytes:
    """Compress scanline-interleaved u16 data into one PIZ chunk."""
    sizes = [size for size, _ in channels]
    arr = np.frombuffer(raw, "<u2")
    total = rows * width * sum(sizes)
    if arr.size != total:
        raise PizError("PIZ compress: size mismatch")

    # deinterleave scanlines into channel-major layout
    data = np.empty(total, np.uint16)
    per_row = [width * s for s in sizes]
    row_stride = sum(per_row)
    offset = 0
    for ci, size in enumerate(sizes):
        pre = sum(per_row[:ci])
        block = (
            arr.reshape(rows, row_stride)[:, pre : pre + per_row[ci]]
            .copy()
            .reshape(-1)
        )
        data[offset : offset + rows * width * size] = block
        offset += rows * width * size

    bitmap = bitmap_from_data(data)
    lut, max_value = forward_lut(bitmap)
    data = lut[data]

    offset = 0
    for size in sizes:
        block = data[offset : offset + rows * width * size]
        for j in range(size):
            wav2_encode(block[j:], width, size, rows, width * size, max_value)
        offset += rows * width * size

    huf = huf_compress(data)
    nz = np.flatnonzero(bitmap)
    if len(nz):
        min_nz, max_nz = int(nz[0]), int(nz[-1])
        bitmap_slice = bitmap[min_nz : max_nz + 1].tobytes()
    else:
        min_nz, max_nz = BITMAP_SIZE - 1, 0
        bitmap_slice = b""
    return (
        struct.pack("<HH", min_nz, max_nz)
        + bitmap_slice
        + struct.pack("<I", len(huf))
        + huf
    )
