"""Deflate64 (ZIP method 9, "enhanced deflate") decoder.

RFC 1951 inflate with Deflate64's three extensions (PKWARE APPNOTE 5.2):
a 64 KiB back-reference window, length code 285 REDEFINED as base 3 with
16 extra bits (plain deflate: literal length 258 with none — so deflate
streams that use code 285 are NOT valid deflate64!), and distance codes
30/31 (bases 32769/49153, 14 extra bits). Validated against zlib-produced
streams that avoid code 285 (an external encoder for every other code
path) plus a hand-assembled stream exercising the redefined codes
(tests/test_ingest.py::test_deflate64_*).

Pure python, bit-serial — this is a compatibility fallback for exotic
archives (the reference's zip crate enables deflate64; Cargo.toml:30),
not a hot path.
"""

from __future__ import annotations


class Deflate64Error(ValueError):
    pass


class _Bits:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def bit(self) -> int:
        byte = self.pos >> 3
        if byte >= len(self.data):
            raise Deflate64Error("truncated deflate64 stream")
        b = (self.data[byte] >> (self.pos & 7)) & 1
        self.pos += 1
        return b

    def bits(self, n: int) -> int:
        v = 0
        for i in range(n):
            v |= self.bit() << i
        return v

    def align_byte(self) -> None:
        self.pos = (self.pos + 7) & ~7


class _Huffman:
    """Canonical Huffman decoder from code lengths (RFC 1951 §3.2.2)."""

    def __init__(self, lengths):
        self.table: dict[tuple[int, int], int] = {}
        max_len = max(lengths) if lengths else 0
        code = 0
        for bl in range(1, max_len + 1):
            for sym, sl in enumerate(lengths):
                if sl == bl:
                    self.table[(bl, code)] = sym
                    code += 1
            code <<= 1

    def decode(self, bits: _Bits) -> int:
        code = 0
        for length in range(1, 16):
            code = (code << 1) | bits.bit()
            sym = self.table.get((length, code))
            if sym is not None:
                return sym
        raise Deflate64Error("invalid Huffman code")


# length codes 257..285 (deflate64: 285 -> base 3, 16 extra bits)
_LEN_BASE = [
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
    35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 3,
]
_LEN_EXTRA = [
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
    3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 16,
]
# distance codes 0..31 (30/31 are deflate64-only)
_DIST_BASE = [
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
    257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145,
    8193, 12289, 16385, 24577, 32769, 49153,
]
_DIST_EXTRA = [
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
    7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14,
]

_CLC_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]


def _fixed_tables():
    lit_lengths = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
    dist_lengths = [5] * 32
    return _Huffman(lit_lengths), _Huffman(dist_lengths)


def inflate64(data: bytes, max_output: int | None = None) -> bytes:
    """Decompress a raw deflate64 stream (no zlib/gzip wrapper)."""
    bits = _Bits(data)
    out = bytearray()
    while True:
        bfinal = bits.bit()
        btype = bits.bits(2)
        if btype == 0:  # stored
            bits.align_byte()
            byte = bits.pos >> 3
            if byte + 4 > len(data):
                raise Deflate64Error("truncated stored block header")
            ln = data[byte] | (data[byte + 1] << 8)
            nlen = data[byte + 2] | (data[byte + 3] << 8)
            if ln != (~nlen & 0xFFFF):
                raise Deflate64Error("stored block LEN/NLEN mismatch")
            start = byte + 4
            out += data[start : start + ln]
            bits.pos = (start + ln) << 3
        elif btype in (1, 2):
            if btype == 1:
                lit, dist = _fixed_tables()
            else:  # dynamic
                hlit = bits.bits(5) + 257
                hdist = bits.bits(5) + 1
                hclen = bits.bits(4) + 4
                clc = [0] * 19
                for i in range(hclen):
                    clc[_CLC_ORDER[i]] = bits.bits(3)
                cl_tree = _Huffman(clc)
                lengths: list[int] = []
                while len(lengths) < hlit + hdist:
                    sym = cl_tree.decode(bits)
                    if sym < 16:
                        lengths.append(sym)
                    elif sym == 16:
                        if not lengths:
                            raise Deflate64Error("repeat with no prior length")
                        lengths += [lengths[-1]] * (3 + bits.bits(2))
                    elif sym == 17:
                        lengths += [0] * (3 + bits.bits(3))
                    else:
                        lengths += [0] * (11 + bits.bits(7))
                lit = _Huffman(lengths[:hlit])
                dist = _Huffman(lengths[hlit:])
            while True:
                sym = lit.decode(bits)
                if sym < 256:
                    out.append(sym)
                elif sym == 256:
                    break
                else:
                    if sym > 285:
                        raise Deflate64Error(f"invalid length code {sym}")
                    i = sym - 257
                    length = _LEN_BASE[i] + bits.bits(_LEN_EXTRA[i])
                    dsym = dist.decode(bits)
                    if dsym >= 32:
                        raise Deflate64Error(f"invalid distance code {dsym}")
                    distance = _DIST_BASE[dsym] + bits.bits(_DIST_EXTRA[dsym])
                    if distance > len(out):
                        raise Deflate64Error("distance beyond output start")
                    for _ in range(length):
                        out.append(out[-distance])
                if max_output is not None and len(out) > max_output:
                    raise Deflate64Error("output exceeds declared size")
        else:
            raise Deflate64Error("reserved block type 3")
        if bfinal:
            return bytes(out)
