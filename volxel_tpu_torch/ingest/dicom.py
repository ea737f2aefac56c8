"""Minimal self-contained DICOM parser (no pydicom in this environment).

Covers what the reference ingest consumes (dicom_preprocessor/src/lib.rs:47-140):
pixel data (16-bit unsigned, 1 sample/pixel), the geometry tags
PixelSpacing (0028,0030) and SliceThickness (0018,0050), and DICOMDIR
detection via the directory record sequence (0004,1220).

Transfer syntaxes: Explicit/Implicit VR Little Endian, Explicit VR Big
Endian, and — matching the reference's dicom-pixeldata features
["image","jpeg","native"] (dicom_preprocessor/Cargo.toml:25) — the
encapsulated syntaxes JPEG Lossless (.57/.70, incl. SV1, bit-exact), JPEG
Baseline/Extended (.50/.51), RLE Lossless (1.2.840.10008.1.2.5) — decoded
by the in-repo ingest.jpeg / ingest.rle codecs — plus JPEG 2000 (.90/.91,
via cv2/OpenJPEG) and JPEG XL (via the system libjxl, ingest/jxl.py).
Unsupported encapsulated syntaxes (JPEG-LS) raise cleanly by name.

Files with or without the 128-byte preamble parse; nested sequences are
skipped (except for DICOMDIR detection).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# transfer syntaxes
IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
EXPLICIT_VR_BE = "1.2.840.10008.1.2.2"
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"
JPEG_LOSSLESS = "1.2.840.10008.1.2.4.57"
JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"
JPEG_LS_LOSSLESS = "1.2.840.10008.1.2.4.80"
JPEG_LS_NEAR = "1.2.840.10008.1.2.4.81"
JPEG_2000_LOSSLESS = "1.2.840.10008.1.2.4.90"
JPEG_2000 = "1.2.840.10008.1.2.4.91"
RLE_LOSSLESS = "1.2.840.10008.1.2.5"
JPEG_XL_LOSSLESS = "1.2.840.10008.1.2.4.110"
JPEG_XL_RECOMPRESSION = "1.2.840.10008.1.2.4.111"
JPEG_XL = "1.2.840.10008.1.2.4.112"

_JPEG_SYNTAXES = (JPEG_BASELINE, JPEG_EXTENDED, JPEG_LOSSLESS, JPEG_LOSSLESS_SV1)
_J2K_SYNTAXES = (JPEG_2000_LOSSLESS, JPEG_2000)
_JXL_SYNTAXES = (JPEG_XL_LOSSLESS, JPEG_XL_RECOMPRESSION, JPEG_XL)
_ENCAPSULATED_SYNTAXES = (
    _JPEG_SYNTAXES + _J2K_SYNTAXES + _JXL_SYNTAXES + (RLE_LOSSLESS,)
)
_NAMED_UNSUPPORTED = {
    JPEG_LS_LOSSLESS: "JPEG-LS Lossless",
    JPEG_LS_NEAR: "JPEG-LS Near-Lossless",
}

# tags (group, element) — reference lib.rs:36-45
TAG_PIXEL_SPACING = (0x0028, 0x0030)
TAG_SLICE_THICKNESS = (0x0018, 0x0050)
TAG_PIXEL_DATA = (0x7FE0, 0x0010)
TAG_ROWS = (0x0028, 0x0010)
TAG_COLUMNS = (0x0028, 0x0011)
TAG_BITS_ALLOCATED = (0x0028, 0x0100)
TAG_BITS_STORED = (0x0028, 0x0101)
TAG_PIXEL_REPRESENTATION = (0x0028, 0x0103)
TAG_SAMPLES_PER_PIXEL = (0x0028, 0x0002)
TAG_NUMBER_OF_FRAMES = (0x0028, 0x0008)
TAG_DICOMDIR_RECORD_SEQUENCE = (0x0004, 0x1220)
TAG_TRANSFER_SYNTAX = (0x0002, 0x0010)

# VRs with a 2-byte reserved field and 4-byte length in explicit VR
_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UC", b"UR", b"UT", b"UN"}

_ITEM = (0xFFFE, 0xE000)
_ITEM_DELIM = (0xFFFE, 0xE00D)
_SEQ_DELIM = (0xFFFE, 0xE0DD)

UNDEFINED_LENGTH = 0xFFFFFFFF


class DicomError(ValueError):
    pass


@dataclass
class DicomFile:
    elements: dict[tuple[int, int], bytes]
    vrs: dict[tuple[int, int], str] = field(default_factory=dict)
    is_dicomdir: bool = False
    transfer_syntax: str = EXPLICIT_VR_LE
    fragments: list[bytes] = field(default_factory=list)
    offset_table: list[int] = field(default_factory=list)
    fragment_offsets: list[int] = field(default_factory=list)
    big_endian: bool = False

    # -- typed accessors ------------------------------------------------------

    def raw(self, tag, default=None):
        return self.elements.get(tag, default)

    def string(self, tag, default=None) -> str | None:
        raw = self.elements.get(tag)
        if raw is None:
            return default
        return raw.decode("ascii", errors="replace").strip("\x00 ")

    def strings(self, tag) -> list[str]:
        s = self.string(tag)
        return [] if s is None else [p.strip() for p in s.split("\\")]

    @property
    def _e(self) -> str:
        return ">" if self.big_endian else "<"

    def uint16(self, tag, default=None) -> int | None:
        raw = self.elements.get(tag)
        if raw is None or len(raw) < 2:
            return default
        return struct.unpack(self._e + "H", raw[:2])[0]

    def int_value(self, tag, default=None) -> int | None:
        """Integer from US/UL binary or IS string representation."""
        raw = self.elements.get(tag)
        if raw is None:
            return default
        vr = self.vrs.get(tag, "")
        if vr in ("US",) or (not vr and len(raw) == 2):
            return struct.unpack(self._e + "H", raw[:2])[0]
        if vr in ("UL",) or (not vr and len(raw) == 4):
            return struct.unpack(self._e + "I", raw[:4])[0]
        try:
            return int(raw.decode("ascii").strip("\x00 "))
        except ValueError as e:
            raise DicomError(f"cannot parse integer tag {tag}") from e

    def floats(self, tag) -> list[float]:
        return [float(s) for s in self.strings(tag) if s]

    # -- pixel payload (lib.rs:75-103 constraints) ----------------------------

    def pixel_array(self) -> np.ndarray:
        """Decode pixel data as (frames, rows, cols) uint16.

        Enforces the same constraints as the reference (lib.rs:77-84):
        1 sample/pixel, unsigned representation. Deviation: 8-bit samples
        (JPEG Baseline archives) are accepted and widened to uint16 — the
        reference panics on them, which is a limitation, not behavior worth
        preserving.
        """
        if self.int_value(TAG_SAMPLES_PER_PIXEL, 1) != 1:
            raise DicomError("More than one sample per pixel not currently supported")
        bits_allocated = self.int_value(TAG_BITS_ALLOCATED, 16)
        if bits_allocated not in (8, 16):
            raise DicomError("Currently only 8/16bit samples are supported")
        if self.int_value(TAG_PIXEL_REPRESENTATION, 0) != 0:
            raise DicomError("Currently only unsigned samples are supported")
        rows = self.int_value(TAG_ROWS)
        cols = self.int_value(TAG_COLUMNS)
        if rows is None or cols is None:
            raise DicomError("Missing Rows/Columns")
        frames = self.int_value(TAG_NUMBER_OF_FRAMES, 1) or 1

        if self.fragments:
            return self._decode_encapsulated(rows, cols, frames, bits_allocated)

        raw = self.elements.get(TAG_PIXEL_DATA)
        if raw is None:
            raise DicomError("Missing PixelData")
        nbytes = bits_allocated // 8
        expected = rows * cols * frames * nbytes
        if len(raw) < expected:
            raise DicomError(
                f"PixelData too short: {len(raw)} < {expected}"
            )
        dt = (self._e + "u2") if nbytes == 2 else "u1"
        return (
            np.frombuffer(raw[:expected], dtype=dt)
            .reshape(frames, rows, cols)
            .astype(np.uint16)
        )

    def _frame_fragments(self, frames: int) -> list[bytes]:
        """Group encapsulated fragments into per-frame byte streams (PS3.5 A.4)."""
        frags = self.fragments
        if frames == 1:
            return [b"".join(frags)]
        if len(frags) == frames:
            return list(frags)
        if self.offset_table and len(self.offset_table) == frames:
            groups = []
            starts = list(self.offset_table)
            for i, start in enumerate(starts):
                end = starts[i + 1] if i + 1 < frames else None
                parts = [
                    f
                    for f, off in zip(frags, self.fragment_offsets)
                    if off >= start and (end is None or off < end)
                ]
                groups.append(b"".join(parts))
            return groups
        raise DicomError(
            f"cannot map {len(frags)} pixel-data fragments onto {frames} "
            "frames (missing/odd Basic Offset Table)"
        )

    def _decode_encapsulated(self, rows, cols, frames, bits_allocated) -> np.ndarray:
        syntax = self.transfer_syntax
        streams = self._frame_fragments(frames)
        out = np.empty((frames, rows, cols), np.uint16)
        if syntax in _JPEG_SYNTAXES:
            from volxel_tpu_torch.ingest import jpeg

            for i, stream in enumerate(streams):
                try:
                    img = jpeg.decode(stream)
                except jpeg.JpegError as e:
                    raise DicomError(f"JPEG decode failed: {e}") from e
                if img.shape != (rows, cols):
                    raise DicomError(
                        f"JPEG frame shape {img.shape} != ({rows}, {cols})"
                    )
                out[i] = img
        elif syntax in _J2K_SYNTAXES:
            try:
                import cv2
            except ImportError as e:
                raise DicomError(
                    "JPEG 2000 pixel data needs OpenCV (cv2 with OpenJPEG); "
                    "not available in this environment"
                ) from e
            for i, stream in enumerate(streams):
                img = cv2.imdecode(
                    np.frombuffer(stream, np.uint8), cv2.IMREAD_UNCHANGED
                )
                if img is None:
                    raise DicomError("JPEG 2000 decode failed (OpenJPEG)")
                if img.ndim != 2:
                    raise DicomError(
                        "More than one sample per pixel not currently supported"
                    )
                if img.shape != (rows, cols):
                    raise DicomError(
                        f"JPEG 2000 frame shape {img.shape} != ({rows}, {cols})"
                    )
                out[i] = img.astype(np.uint16)
        elif syntax in _JXL_SYNTAXES:
            # reference parity: dicom_preprocessor's `jpegxl` feature
            # (Cargo.toml:25); decoded via the system libjxl (ingest/jxl.py)
            from volxel_tpu_torch.ingest import jxl

            if not jxl.jxl_available():
                raise DicomError(
                    "JPEG XL pixel data needs libjxl, which is not "
                    "available in this environment"
                )
            for i, stream in enumerate(streams):
                try:
                    img = jxl.decode_jxl(stream)
                except (ValueError, RuntimeError) as e:
                    raise DicomError(f"JPEG XL decode failed: {e}") from e
                if img.ndim != 2:
                    raise DicomError(
                        "More than one sample per pixel not currently supported"
                    )
                if img.shape != (rows, cols):
                    raise DicomError(
                        f"JPEG XL frame shape {img.shape} != ({rows}, {cols})"
                    )
                out[i] = img.astype(np.uint16)
        elif syntax == RLE_LOSSLESS:
            from volxel_tpu_torch.ingest import rle

            for i, stream in enumerate(streams):
                try:
                    out[i] = rle.decode_rle(stream, rows, cols, bits_allocated)
                except rle.RleError as e:
                    raise DicomError(f"RLE decode failed: {e}") from e
        else:
            raise DicomError(f"Unsupported encapsulated transfer syntax: {syntax}")
        return out

    @property
    def bits_stored(self) -> int:
        return self.int_value(TAG_BITS_STORED, 16) or 16

    def pixel_spacing(self) -> tuple[float, float]:
        """lib.rs:105-122 — required, two decimal strings."""
        vals = self.floats(TAG_PIXEL_SPACING)
        if len(vals) != 2:
            raise DicomError("Image did not contain pixel spacing information")
        return vals[0], vals[1]

    def slice_thickness(self) -> float:
        """lib.rs:124-133 — optional, defaults to min(pixel spacing)."""
        vals = self.floats(TAG_SLICE_THICKNESS)
        if vals:
            return vals[0]
        sx, sy = self.pixel_spacing()
        return min(sx, sy)


def _skip_sequence_undefined(
    buf: memoryview, pos: int, explicit: bool, e: str = "<"
) -> int:
    """Skip an undefined-length SQ body, returning the offset past its delimiter."""
    depth = 1
    n = len(buf)
    while pos + 8 <= n and depth > 0:
        group, elem = struct.unpack_from(e + "HH", buf, pos)
        length = struct.unpack_from(e + "I", buf, pos + 4)[0]
        pos += 8
        tag = (group, elem)
        if tag == _SEQ_DELIM:
            depth -= 1
        elif tag == _ITEM:
            if length != UNDEFINED_LENGTH:
                pos += length
            # undefined-length items: keep scanning; nested delimiters handled below
        elif tag == _ITEM_DELIM:
            pass
        else:
            # element inside an undefined-length item
            pos -= 8
            pos = _skip_element(buf, pos, explicit, e)
    return pos


def _skip_element(buf: memoryview, pos: int, explicit: bool, e: str = "<") -> int:
    """Advance past one data element (used only inside skipped sequences)."""
    group, elem = struct.unpack_from(e + "HH", buf, pos)
    pos += 4
    if explicit and (group, elem) not in (_ITEM, _ITEM_DELIM, _SEQ_DELIM):
        vr = bytes(buf[pos : pos + 2])
        if vr in _LONG_VRS:
            length = struct.unpack_from(e + "I", buf, pos + 4)[0]
            pos += 8
        else:
            length = struct.unpack_from(e + "H", buf, pos + 2)[0]
            pos += 4
    else:
        length = struct.unpack_from(e + "I", buf, pos)[0]
        pos += 4
    if length == UNDEFINED_LENGTH:
        return _skip_sequence_undefined(buf, pos, explicit, e)
    return pos + length


def _parse_encapsulated(buf: memoryview, pos: int, e: str = "<"):
    """Parse encapsulated PixelData items (PS3.5 A.4): the Basic Offset
    Table item, then one item per fragment, then a sequence delimiter.
    Returns (offset_table, fragments, fragment_offsets, pos_after)."""
    offset_table: list[int] = []
    fragments: list[bytes] = []
    fragment_offsets: list[int] = []
    first = True
    first_frag_pos = None
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from(e + "HH", buf, pos)
        length = struct.unpack_from(e + "I", buf, pos + 4)[0]
        tag = (group, elem)
        pos += 8
        if tag == _SEQ_DELIM:
            break
        if tag != _ITEM:
            raise DicomError(f"unexpected tag {tag} inside encapsulated pixel data")
        if length == UNDEFINED_LENGTH:
            raise DicomError("encapsulated pixel-data item with undefined length")
        if first:
            # Basic Offset Table (may be empty)
            count = length // 4
            offset_table = list(
                struct.unpack_from(e + f"{count}I", buf, pos) if count else ()
            )
            first = False
        else:
            if first_frag_pos is None:
                first_frag_pos = pos - 8
            fragment_offsets.append(pos - 8 - first_frag_pos)
            fragments.append(bytes(buf[pos : pos + length]))
        pos += length
    return offset_table, fragments, fragment_offsets, pos


def _parse_dataset(
    buf: memoryview,
    pos: int,
    explicit: bool,
    stop_group: int | None = None,
    end: int | None = None,
    e: str = "<",
    encapsulated: dict | None = None,
) -> tuple[dict, dict, int]:
    elements: dict[tuple[int, int], bytes] = {}
    vrs: dict[tuple[int, int], str] = {}
    n = len(buf) if end is None else end
    while pos + 8 <= n:
        group, elem = struct.unpack_from(e + "HH", buf, pos)
        if stop_group is not None and group != stop_group:
            break
        tag = (group, elem)
        pos += 4
        vr = b""
        if explicit and tag not in (_ITEM, _ITEM_DELIM, _SEQ_DELIM):
            vr = bytes(buf[pos : pos + 2])
            if vr in _LONG_VRS:
                length = struct.unpack_from(e + "I", buf, pos + 4)[0]
                pos += 8
            else:
                length = struct.unpack_from(e + "H", buf, pos + 2)[0]
                pos += 4
        else:
            length = struct.unpack_from(e + "I", buf, pos)[0]
            pos += 4

        if (
            tag == TAG_PIXEL_DATA
            and length == UNDEFINED_LENGTH
            and encapsulated is not None
        ):
            ot, frags, frag_offs, pos = _parse_encapsulated(buf, pos, e)
            encapsulated["offset_table"] = ot
            encapsulated["fragments"] = frags
            encapsulated["fragment_offsets"] = frag_offs
            elements[tag] = b""
            if vr:
                vrs[tag] = vr.decode("ascii", errors="replace")
            continue

        is_sq = vr == b"SQ" or (
            not explicit and length == UNDEFINED_LENGTH and tag != TAG_PIXEL_DATA
        )
        if is_sq or (vr == b"" and not explicit and _looks_like_sq(buf, pos, length)):
            # record presence (for DICOMDIR detection) but skip the body
            elements[tag] = b""
            vrs[tag] = "SQ"
            if length == UNDEFINED_LENGTH:
                pos = _skip_sequence_undefined(buf, pos, explicit, e)
            else:
                pos += length
            continue

        if length == UNDEFINED_LENGTH:
            raise DicomError(
                "Undefined-length element outside a sequence "
                "(encapsulated pixel data in an uncompressed transfer syntax?)"
            )
        elements[tag] = bytes(buf[pos : pos + length])
        if vr:
            vrs[tag] = vr.decode("ascii", errors="replace")
        pos += length
    return elements, vrs, pos


def _looks_like_sq(buf: memoryview, pos: int, length: int, e: str = "<") -> bool:
    """Implicit-VR defined-length SQ detection: body starts with an Item tag."""
    if length < 8 or pos + 8 > len(buf):
        return False
    group, elem = struct.unpack_from(e + "HH", buf, pos)
    return (group, elem) == _ITEM


def parse_dicom(data: bytes) -> DicomFile:
    """Parse a DICOM byte stream (preamble optional)."""
    buf = memoryview(data)
    pos = 0
    syntax = EXPLICIT_VR_LE
    if len(data) >= 132 and data[128:132] == b"DICM":
        pos = 132
        # file meta group (0002) is always explicit VR LE
        meta, _, pos = _parse_dataset(buf, pos, explicit=True, stop_group=0x0002)
        ts = meta.get(TAG_TRANSFER_SYNTAX)
        if ts is not None:
            syntax = ts.decode("ascii").strip("\x00 ")
    elif len(data) >= 8:
        # no preamble: sniff explicit VR by checking for a plausible VR code
        vr = data[4:6]
        explicit = vr.isalpha() and vr.isupper()
        syntax = EXPLICIT_VR_LE if explicit else IMPLICIT_VR_LE
    else:
        raise DicomError("Not a DICOM stream (too short)")

    big_endian = False
    if syntax in (EXPLICIT_VR_LE,) + _ENCAPSULATED_SYNTAXES:
        explicit = True
    elif syntax == IMPLICIT_VR_LE:
        explicit = False
    elif syntax == EXPLICIT_VR_BE:
        explicit = True
        big_endian = True
    elif syntax in _NAMED_UNSUPPORTED:
        raise DicomError(
            f"Unsupported transfer syntax: {_NAMED_UNSUPPORTED[syntax]} ({syntax})"
        )
    else:
        raise DicomError(f"Unsupported transfer syntax: {syntax}")

    e = ">" if big_endian else "<"
    encapsulated: dict = {}
    elements, vrs, _ = _parse_dataset(
        buf, pos, explicit=explicit, e=e, encapsulated=encapsulated
    )
    if not any(group >= 0x0004 for group, _ in elements):
        raise DicomError("Not a DICOM stream (no dataset elements found)")
    is_dicomdir = TAG_DICOMDIR_RECORD_SEQUENCE in elements
    return DicomFile(
        elements=elements,
        vrs=vrs,
        is_dicomdir=is_dicomdir,
        transfer_syntax=syntax,
        fragments=encapsulated.get("fragments", []),
        offset_table=encapsulated.get("offset_table", []),
        fragment_offsets=encapsulated.get("fragment_offsets", []),
        big_endian=big_endian,
    )
