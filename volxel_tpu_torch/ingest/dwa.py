"""DWA (DWAA/DWAB) OpenEXR decompression in numpy.

The reference decodes every standard EXR compression through the Rust
`image`/`exr` crates (dicom_preprocessor/src/hdr.rs:23-36,
Cargo.toml:31); DWAA/DWAB is the last one this repo needed. DWA is a
lossy DCT codec (Industrial Light & Magic): channels are classified by
suffix rules into LOSSY_DCT (8x8 DCT blocks, RGB triples color-space
converted), RLE, and UNKNOWN (zlib verbatim) streams.

Layout of one compressed chunk (established empirically against files
written by the canonical libOpenEXR 3.1 — tests/fixtures/openexr_dwa*.exr,
tests/test_exr_external.py):

  - 11 x uint64 LE header: version, unknownUncompressedSize,
    unknownCompressedSize, acCompressedSize, dcCompressedSize,
    rleCompressedSize, rleUncompressedSize, rleRawSize,
    totalAcUncompressedCount, totalDcUncompressedCount, acCompression
  - (version >= 2) uint16 ruleSize (incl. the 2 size bytes), then rules:
    NUL-terminated suffix + value byte [cscIdx+1:4 | scheme:2 | caseIns:1]
    + pixel-type byte
  - UNKNOWN block: zlib over planar channel data, header order
  - AC block: ImfHuf (acCompression 0, the PIZ Huffman — ingest/piz.py)
    or zlib (1) over uint16 tokens
  - DC block: EXR-ZIP (zlib + delta/deinterleave predictor) over uint16
    half bits, per-component contiguous within each decoder group
  - RLE block: zlib, then EXR RLE, then byte-planar per channel

AC token stream, per 8x8 block in (blocky, blockx, comp) order, zigzag
positions 1..63 (DC at 0 comes from the DC block): 0xff00 ends the block
(remaining coefficients zero), 0xff00|n (n>0) inserts n zeros, anything
else is a literal half. Decoded coefficients pass through the inverse
8x8 DCT (OpenEXR's even-odd float32 butterfly, replicated for rounding
parity), CSC-set triples through the Rec.709 inverse, and everything
through the toLinear half LUT: sign*|v|^2.2 for |v|<=1, continued
C1-smoothly as sign*exp(2.2*(|v|-1)) above 1.

Decoded output matches libOpenEXR bit-exactly for >99.9% of pixels; the
rest differ by a few half-ULPs where the compiled library's FMA
contraction rounds the butterfly differently (amplified through the
exponential toLinear branch; tests pin the bound).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


class DwaError(ValueError):
    """Malformed or unsupported DWA chunk."""


_PIXEL_SIZES = {0: 4, 1: 2, 2: 4}
_SCHEME_UNKNOWN, _SCHEME_DCT, _SCHEME_RLE = 0, 1, 2

# classification fallback for version<2 chunks (the canonical encoder's
# default suffix rules, restricted to what a v1 file can contain)
_DEFAULT_RULES = [
    ("r", 0, _SCHEME_DCT, 1, 1),
    ("g", 1, _SCHEME_DCT, 1, 1),
    ("b", 2, _SCHEME_DCT, 1, 1),
    ("y", -1, _SCHEME_DCT, 1, 1),
    ("by", -1, _SCHEME_DCT, 1, 1),
    ("ry", -1, _SCHEME_DCT, 1, 1),
    ("a", -1, _SCHEME_RLE, 1, 0),
    ("a", -1, _SCHEME_RLE, 1, 1),
    ("a", -1, _SCHEME_RLE, 1, 2),
]


def _make_to_linear() -> np.ndarray:
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    h = bits.view(np.float16).astype(np.float32)
    sign = np.where(h < 0, np.float32(-1.0), np.float32(1.0))
    a = np.abs(h)
    with np.errstate(all="ignore"):
        curve = np.where(a <= 1.0, a ** np.float32(2.2),
                         np.exp(np.float32(2.2) * (a - np.float32(1.0))))
        lin = np.where(np.isfinite(h), sign * curve, np.float32(0.0))
        out = lin.astype(np.float16).view(np.uint16).copy()
    out[0] = 0
    return out


_TO_LINEAR: np.ndarray | None = None

_ZIGZAG = np.array([
     0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63], np.int64)


def _idct8x8(x: np.ndarray) -> np.ndarray:
    """OpenEXR's dctInverse8x8 even-odd butterfly, float32 op-for-op
    (including the truncated 3.14159 pi), vectorized over leading dims;
    row pass then column pass, matching the library's rounding."""
    pi = np.float32(3.14159)
    ca = np.float32(0.5) * np.cos(pi / np.float32(4.0))
    cb = np.float32(0.5) * np.cos(pi / np.float32(16.0))
    cc = np.float32(0.5) * np.cos(pi / np.float32(8.0))
    cd = np.float32(0.5) * np.cos(np.float32(3.0) * pi / np.float32(16.0))
    ce = np.float32(0.5) * np.cos(np.float32(5.0) * pi / np.float32(16.0))
    cf = np.float32(0.5) * np.cos(np.float32(3.0) * pi / np.float32(8.0))
    cg = np.float32(0.5) * np.cos(np.float32(7.0) * pi / np.float32(16.0))
    for axis in (-1, -2):
        r = np.moveaxis(x, axis, -1)
        r0, r1, r2, r3, r4, r5, r6, r7 = (r[..., i] for i in range(8))
        a0, a1, a2, a3 = cc * r2, cf * r2, cc * r6, cf * r6
        b0 = cb * r1 + cd * r3 + ce * r5 + cg * r7
        b1 = cd * r1 - cg * r3 - cb * r5 - ce * r7
        b2 = ce * r1 - cb * r3 + cg * r5 + cd * r7
        b3 = cg * r1 - ce * r3 + cd * r5 - cb * r7
        t0, t3 = ca * (r0 + r4), ca * (r0 - r4)
        t1, t2 = a0 + a3, a1 - a2
        g0, g1, g2, g3 = t0 + t1, t3 + t2, t3 - t2, t0 - t1
        out = np.stack([g0 + b0, g1 + b1, g2 + b2, g3 + b3,
                        g3 - b3, g2 - b2, g1 - b1, g0 - b0], axis=-1)
        x = np.moveaxis(out, -1, axis)
    return x


def _unzip_predictor(data: bytes) -> bytes:
    """zlib + the EXR ZIP delta/deinterleave postprocess (DC stream)."""
    raw = np.frombuffer(zlib.decompress(data), np.uint8).astype(np.int64)
    if len(raw) == 0:
        return b""
    raw[1:] -= 128
    recon = np.cumsum(raw).astype(np.uint8)
    half = (len(recon) + 1) // 2
    out = np.empty(len(recon), np.uint8)
    out[0::2] = recon[:half]
    out[1::2] = recon[half:]
    return out.tobytes()


def _rle_uncompress(src: bytes, out_len: int) -> bytes:
    arr = np.frombuffer(src, np.int8)
    out = bytearray()
    i, n = 0, len(arr)
    while i < n and len(out) < out_len:
        c = int(arr[i])
        if c < 0:
            cnt = -c
            if i + 1 + cnt > n:
                raise DwaError("RLE literal run past end of stream")
            out += arr[i + 1:i + 1 + cnt].tobytes()
            i += 1 + cnt
        else:
            if i + 1 >= n:
                raise DwaError("RLE repeat run missing its byte")
            out += arr[i + 1:i + 2].tobytes() * (c + 1)
            i += 2
    if len(out) != out_len:
        raise DwaError("RLE stream decoded to the wrong size")
    return bytes(out)


def _unpack_ac(ac: np.ndarray, start: int, total: int) -> tuple[np.ndarray, int]:
    """Expand `total` blocks of AC tokens starting at ac[start].

    Returns (coefs (total, 64) uint16 with column 0 zero, next position).
    Vectorized: between end-of-block tokens the effective advance equals
    the nominal one (literal=1, zero-run=n), so spans between EOBs expand
    with one cumsum each and only the EOB jumps are handled serially.
    """
    need = total * 63
    sub = ac[start:]
    vals = sub.astype(np.uint32)
    is_eob = vals == 0xFF00
    is_run = ((vals & 0xFF00) == 0xFF00) & ~is_eob
    nominal = np.where(is_run, vals & 0xFF, np.where(is_eob, 0, 1)).astype(np.int64)
    eob_idx = np.flatnonzero(is_eob)

    flat = np.zeros(need, np.uint16)

    def fill_span(lo: int, hi: int, base: int, limit: int) -> int:
        """Scatter literals of tokens [lo,hi) starting at position base;
        returns tokens consumed (may stop early at `limit`)."""
        if lo >= hi:
            return 0
        adv = nominal[lo:hi]
        cum = np.cumsum(adv)
        pos = base + cum - adv  # position BEFORE each token
        take = int(np.searchsorted(pos + adv, limit, side="left")) + 1
        take = min(take, hi - lo)
        adv, cum, pos = adv[:take], cum[:take], pos[:take]
        if base + cum[-1] > limit:
            raise DwaError("AC stream overruns its block budget")
        # zero-runs must not cross a block boundary
        run = is_run[lo:lo + take]
        if np.any((pos[run] // 63) != ((pos[run] + adv[run] - 1) // 63)):
            raise DwaError("AC zero-run crosses a block boundary")
        lit = ~run & ~is_eob[lo:lo + take]
        flat[pos[lit]] = sub[lo:lo + take][lit]
        return take

    eff = 0  # effective coefficient position (63 per block)
    tok = 0  # tokens consumed
    for e in eob_idx:
        e = int(e)
        if tok > e:
            continue  # EOB already passed inside an earlier accounting
        taken = fill_span(tok, e, eff, need)
        span_adv = int(np.sum(nominal[tok:tok + taken]))
        eff += span_adv
        tok += taken
        if eff >= need:
            break
        if tok < e:
            # fill_span stopped early without reaching `need`: malformed
            raise DwaError("AC stream desynchronized before end-of-block")
        # the EOB token closes the currently-open block
        eff += 63 - (eff % 63) if eff % 63 else 63
        tok += 1
        if eff >= need:
            break
    else:
        # tail without a terminating EOB (last blocks complete naturally)
        taken = fill_span(tok, len(sub), eff, need)
        eff += int(np.sum(nominal[tok:tok + taken]))
        tok += taken
    if eff != need:
        raise DwaError("AC stream ended before all blocks were filled")
    coefs = np.zeros((total, 64), np.uint16)
    coefs[:, 1:] = flat.reshape(total, 63)
    return coefs, start + tok


def _classify(name: str, ptype: int, rules) -> tuple[int, int]:
    base = name.rsplit(".", 1)[-1]
    for suffix, csc, scheme, case_ins, rtype in rules:
        cand = base.lower() if case_ins else base
        suf = suffix.lower() if case_ins else suffix
        if cand == suf and rtype == ptype:
            return scheme, csc
    return _SCHEME_UNKNOWN, -1


def dwa_uncompress(
    payload: bytes, channels: list[tuple[str, int]], width: int, rows: int
) -> bytes:
    """Decode one DWA chunk -> interleaved scanlines (per row, channels
    in header order), the layout EXR chunk consumers expect."""
    global _TO_LINEAR
    if _TO_LINEAR is None:
        _TO_LINEAR = _make_to_linear()
    if len(payload) < 88:
        raise DwaError("DWA chunk shorter than its header")
    (version, unk_unc, unk_comp, ac_comp, dc_comp, rle_comp, _rle_unc,
     rle_raw, ac_cnt, dc_cnt, ac_scheme) = struct.unpack_from("<11Q", payload, 0)
    pos = 88
    if version >= 2:
        if pos + 2 > len(payload):
            raise DwaError("DWA rules truncated")
        rule_size = struct.unpack_from("<H", payload, pos)[0]
        if rule_size < 2 or pos + rule_size > len(payload):
            raise DwaError("DWA rule block size out of range")
        rules = []
        rp, rend = pos + 2, pos + rule_size
        while rp < rend:
            e = payload.find(b"\x00", rp, rend)
            if e < 0 or e + 3 > rend:
                raise DwaError("DWA rule entry truncated")
            suffix = payload[rp:e].decode("ascii", "replace")
            v, t = payload[e + 1], payload[e + 2]
            scheme = (v >> 2) & 3
            if scheme not in (_SCHEME_UNKNOWN, _SCHEME_DCT, _SCHEME_RLE):
                raise DwaError(f"DWA rule has unknown scheme {scheme}")
            rules.append((suffix, (v >> 4) - 1, scheme, v & 1, t))
            rp = e + 3
        pos = rend
    else:
        rules = _DEFAULT_RULES

    if pos + unk_comp + ac_comp + dc_comp + rle_comp > len(payload):
        raise DwaError("DWA block sizes exceed the chunk")
    try:
        unknown = zlib.decompress(payload[pos:pos + unk_comp]) if unk_comp else b""
    except zlib.error as exc:
        raise DwaError(f"DWA unknown-channel inflate failed: {exc}") from exc
    if len(unknown) != unk_unc:
        raise DwaError("DWA unknown-channel data has the wrong size")
    pos += unk_comp
    if ac_comp:
        if ac_cnt > (rows + 7) * (width + 7) * len(channels):
            raise DwaError("DWA AC count implausibly large")
        if ac_scheme == 0:  # STATIC_HUFFMAN (the PIZ ImfHuf codec)
            from volxel_tpu_torch.ingest.piz import PizError, huf_uncompress

            try:
                ac = huf_uncompress(payload[pos:pos + ac_comp], int(ac_cnt))
            except PizError as exc:
                raise DwaError(f"DWA AC Huffman decode failed: {exc}") from exc
        elif ac_scheme == 1:  # DEFLATE
            try:
                raw = zlib.decompress(payload[pos:pos + ac_comp])
            except zlib.error as exc:
                raise DwaError(f"DWA AC inflate failed: {exc}") from exc
            if len(raw) != 2 * ac_cnt:
                raise DwaError("DWA AC data has the wrong size")
            ac = np.frombuffer(raw, "<u2")
        else:
            raise DwaError(f"DWA AC compression {ac_scheme} unknown")
    else:
        ac = np.zeros(0, np.uint16)
    pos += ac_comp
    if dc_comp:
        try:
            dc = np.frombuffer(_unzip_predictor(payload[pos:pos + dc_comp]), "<u2")
        except zlib.error as exc:
            raise DwaError(f"DWA DC inflate failed: {exc}") from exc
        if len(dc) != dc_cnt:
            raise DwaError("DWA DC data has the wrong size")
    else:
        dc = np.zeros(0, np.uint16)
    pos += dc_comp
    rle = b""
    if rle_comp:
        try:
            rle_packed = zlib.decompress(payload[pos:pos + rle_comp])
        except zlib.error as exc:
            raise DwaError(f"DWA RLE inflate failed: {exc}") from exc
        rle = _rle_uncompress(rle_packed, int(rle_raw))

    cls = [_classify(n, pt, rules) for n, pt in channels]
    nbx, nby = -(-width // 8), -(-rows // 8)
    nblocks = nbx * nby

    # CSC sets: complete R/G/B (cscIdx 0/1/2) triples sharing a prefix
    csc_sets: dict[str, list[int | None]] = {}
    for i, ((name, _pt), (scheme, csc)) in enumerate(zip(channels, cls)):
        if scheme == _SCHEME_DCT and 0 <= csc < 3:
            prefix = name.rsplit(".", 1)[0] if "." in name else ""
            csc_sets.setdefault(prefix, [None, None, None])[csc] = i
    complete = {
        p: idxs for p, idxs in csc_sets.items() if all(i is not None for i in idxs)
    }
    in_set = {i for idxs in complete.values() for i in idxs}

    planes: dict[int, np.ndarray] = {}  # channel index -> (rows, width) f32-as-bytes
    ac_pos = dc_pos = 0

    def decode_dct_group(idxs: list[int]) -> None:
        nonlocal ac_pos, dc_pos
        ncomp = len(idxs)
        total = nblocks * ncomp
        coefs, ac_pos = _unpack_ac(ac, ac_pos, total)
        if dc_pos + total > len(dc):
            raise DwaError("DWA DC stream exhausted")
        dcs = dc[dc_pos:dc_pos + total].reshape(ncomp, nblocks)
        dc_pos += total
        comp_i = np.arange(total) % ncomp
        block_i = np.arange(total) // ncomp
        coefs[:, 0] = dcs[comp_i, block_i]
        blk = np.zeros((total, 64), np.float32)
        blk[:, _ZIGZAG] = coefs.view("<u2").view(np.float16).astype(np.float32)
        blk = blk.reshape(total, 8, 8)
        comps = [_idct8x8(blk[c::ncomp]) for c in range(ncomp)]
        if ncomp == 3:  # Rec.709 inverse, the library's op order
            yy, cb, cr = comps
            comps = [
                yy + np.float32(1.5747) * cr,
                yy - np.float32(0.1873) * cb - np.float32(0.4682) * cr,
                yy + np.float32(1.8556) * cb,
            ]
        for ci, i in enumerate(idxs):
            sp = comps[ci].reshape(nby, nbx, 8, 8)
            plane = sp.transpose(0, 2, 1, 3).reshape(nby * 8, nbx * 8)
            hb = plane[:rows, :width].astype(np.float16).view(np.uint16)
            planes[i] = _TO_LINEAR[hb]

    # header order; an R/G/B member pulls in its whole set at first touch
    for i, ((name, ptype), (scheme, _csc)) in enumerate(zip(channels, cls)):
        if scheme != _SCHEME_DCT or i in planes:
            continue
        if ptype not in (1, 2):
            raise DwaError("DWA lossy-DCT UINT channels are not decodable")
        if i in in_set:
            for prefix, idxs in complete.items():
                if i in idxs:
                    decode_dct_group(list(idxs))
                    break
        else:
            decode_dct_group([i])

    # assemble interleaved rows
    rle_pos = unk_pos = 0
    npx = rows * width
    out_planes: list[np.ndarray] = []
    for i, ((name, ptype), (scheme, _csc)) in enumerate(zip(channels, cls)):
        psize = _PIXEL_SIZES[ptype]
        if scheme == _SCHEME_DCT and i in planes:
            hb = np.ascontiguousarray(planes[i])
            if ptype == 1:
                data = hb.astype("<u2").view(np.uint8).reshape(rows, width * 2)
            else:  # FLOAT channel: widen the decoded half
                f = hb.view(np.float16).astype("<f4")
                data = f.view(np.uint8).reshape(rows, width * 4)
        elif scheme == _SCHEME_RLE:
            nbytes = npx * psize
            if rle_pos + nbytes > len(rle):
                raise DwaError("DWA RLE stream exhausted")
            arr = np.frombuffer(rle, np.uint8, count=nbytes, offset=rle_pos)
            rle_pos += nbytes
            px = np.empty((npx, psize), np.uint8)
            for b in range(psize):  # byte-planar per channel
                px[:, b] = arr[b * npx:(b + 1) * npx]
            data = px.reshape(rows, width * psize)
        else:  # UNKNOWN: verbatim planar
            nbytes = npx * psize
            if unk_pos + nbytes > len(unknown):
                raise DwaError("DWA unknown-channel stream exhausted")
            data = np.frombuffer(
                unknown, np.uint8, count=nbytes, offset=unk_pos
            ).reshape(rows, width * psize)
            unk_pos += nbytes
        out_planes.append(data)

    out = bytearray()
    for r in range(rows):
        for data in out_planes:
            out += data[r].tobytes()
    return bytes(out)
