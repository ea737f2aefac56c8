"""Synthetic test fixtures (copy of volxel_tpu.utils.fixtures).

The environment ships no DICOM sample data, so tests and benchmarks build
their own: a minimal Explicit-VR-Little-Endian writer producing files that
both this package's parser and any conformant reader accept, a procedural
CT-like density volume with nested shells, and a sky-like HDR environment.
The functions are copies of the JAX package's, with its imports pointed at
this package's ingest layer, so the same seed gives the same bytes in both
packages.
"""

from __future__ import annotations

import io
import struct
import zipfile

import numpy as np

from volxel_tpu_torch.ingest.hdr import encode_hdr


def _element(group: int, elem: int, vr: bytes, value: bytes, e: str = "<") -> bytes:
    if len(value) % 2:
        value += b"\x00" if vr != b"UI" else b"\x00"
    head = struct.pack(e + "HH", group, elem)
    if vr in (b"OB", b"OW", b"SQ", b"UN", b"UT"):
        return head + vr + b"\x00\x00" + struct.pack(e + "I", len(value)) + value
    return head + vr + struct.pack(e + "H", len(value)) + value


def _encapsulate(fragments: list[bytes]) -> bytes:
    """PixelData (7FE0,0010) OB undefined length: empty Basic Offset Table
    item, one item per fragment (even-padded), sequence delimiter."""
    out = struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00" + struct.pack("<I", 0xFFFFFFFF)
    out += struct.pack("<HHI", 0xFFFE, 0xE000, 0)  # empty BOT
    for frag in fragments:
        if len(frag) % 2:
            frag += b"\x00"
        out += struct.pack("<HHI", 0xFFFE, 0xE000, len(frag)) + frag
    out += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
    return out


def write_dicom_slice(
    pixels: np.ndarray,
    pixel_spacing: tuple[float, float] = (1.0, 1.0),
    slice_thickness: float | None = 1.0,
    bits_stored: int = 16,
    instance_number: int = 1,
    transfer_syntax: str = "1.2.840.10008.1.2.1",
    encoded_frames: list[bytes] | None = None,
    bits_allocated: int = 16,
) -> bytes:
    """Serialize one (rows, cols) slice, preamble included.

    transfer_syntax selects the encoding: Explicit VR LE (default),
    Explicit VR BE (1.2.840.10008.1.2.2), JPEG Lossless SV1
    (1.2.840.10008.1.2.4.70, encoded in-repo), RLE Lossless
    (1.2.840.10008.1.2.5, encoded in-repo). For other encapsulated
    syntaxes pass pre-encoded frame bytes via encoded_frames.
    """
    big_endian = transfer_syntax == "1.2.840.10008.1.2.2"
    e = ">" if big_endian else "<"
    pixels = np.ascontiguousarray(pixels, dtype=(e + "u2") if bits_allocated == 16 else "u1")
    rows, cols = pixels.shape

    meta_body = _element(0x0002, 0x0010, b"UI", transfer_syntax.encode())
    meta = (
        _element(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_body))) + meta_body
    )

    ds = b""
    ds += _element(0x0018, 0x0050, b"DS", str(slice_thickness).encode(), e) if slice_thickness is not None else b""
    ds += _element(0x0020, 0x0013, b"IS", str(instance_number).encode(), e)
    ds += _element(0x0028, 0x0002, b"US", struct.pack(e + "H", 1), e)
    ds += _element(0x0028, 0x0010, b"US", struct.pack(e + "H", rows), e)
    ds += _element(0x0028, 0x0011, b"US", struct.pack(e + "H", cols), e)
    ds += _element(
        0x0028, 0x0030, b"DS", f"{pixel_spacing[0]}\\{pixel_spacing[1]}".encode(), e
    )
    ds += _element(0x0028, 0x0100, b"US", struct.pack(e + "H", bits_allocated), e)
    ds += _element(0x0028, 0x0101, b"US", struct.pack(e + "H", bits_stored), e)
    ds += _element(0x0028, 0x0102, b"US", struct.pack(e + "H", bits_stored - 1), e)
    ds += _element(0x0028, 0x0103, b"US", struct.pack(e + "H", 0), e)

    if encoded_frames is not None:
        ds += _encapsulate(encoded_frames)
    elif transfer_syntax == "1.2.840.10008.1.2.4.70":
        from volxel_tpu_torch.ingest.jpeg import encode_lossless_sv1

        ds += _encapsulate([encode_lossless_sv1(pixels, bits_stored)])
    elif transfer_syntax == "1.2.840.10008.1.2.5":
        from volxel_tpu_torch.ingest.rle import encode_rle

        ds += _encapsulate([encode_rle(pixels)])
    elif transfer_syntax in ("1.2.840.10008.1.2.1", "1.2.840.10008.1.2.2"):
        ds += _element(0x7FE0, 0x0010, b"OW", pixels.tobytes(), e)
    else:
        raise ValueError(
            f"no in-repo encoder for {transfer_syntax}; pass encoded_frames"
        )

    return b"\x00" * 128 + b"DICM" + meta + ds


def write_dicom_series(
    volume: np.ndarray,
    pixel_spacing: tuple[float, float] = (1.0, 1.0),
    slice_thickness: float = 1.0,
    bits_stored: int = 16,
    **kwargs,
) -> list[bytes]:
    """(Z, Y, X) uint16 volume -> one DICOM byte blob per slice."""
    return [
        write_dicom_slice(
            volume[z],
            pixel_spacing=pixel_spacing,
            slice_thickness=slice_thickness,
            bits_stored=bits_stored,
            instance_number=z + 1,
            **kwargs,
        )
        for z in range(volume.shape[0])
    ]


def write_dicom_zip(
    volume: np.ndarray,
    folder: str = "series",
    **kwargs,
) -> bytes:
    """(Z, Y, X) uint16 volume -> single-folder ZIP of DICOM slices."""
    blobs = write_dicom_series(volume, **kwargs)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for i, blob in enumerate(blobs):
            zf.writestr(f"{folder}/slice_{i:04d}.dcm", blob)
    return buf.getvalue()


def synthetic_ct_volume(
    size: tuple[int, int, int] = (64, 64, 64),
    bits_stored: int = 12,
    seed: int = 0,
) -> np.ndarray:
    """Procedural CT-like uint16 volume: nested density shells + noise.

    Shaped like a body-donor scan: an outer soft-tissue ellipsoid, a
    medium-density shell, and a dense core, with mild noise so bricks are
    non-constant where occupied.
    """
    z, y, x = size
    cz, cy, cx = (z - 1) / 2, (y - 1) / 2, (x - 1) / 2
    max_val = (1 << bits_stored) - 1
    rng = np.random.default_rng(seed)
    out = np.empty((z, y, x), np.uint16)
    # slab-wise with squared radii: the broadcast-whole-volume form
    # materialized five 512 MB f32 temporaries (sqrt + three compares) at
    # 512^3; this form stays cache-resident per slab and skips the
    # sqrt entirely. Values are identical: r < t  <=>  r^2 < t^2.
    yy2 = (
        ((np.arange(y, dtype=np.float32) - np.float32(cy)) / np.float32(y * 0.45))
        ** 2
    )[:, None]
    xx2 = (
        (np.arange(x, dtype=np.float32) - np.float32(cx)) / np.float32(x * 0.45)
    ) ** 2
    yx2 = yy2 + xx2  # (y, x)
    # Perf shape for this environment (measured, BENCH r4 setup
    # attribution): (a) float64 numpy ops run ~400x slower than float32
    # on this host, and Python-float constants silently promote — keep
    # every constant np.float32; (b) the Firecracker VM makes first-touch
    # page faults expensive, so fresh temporaries per slab cost tens of
    # seconds at 512^3 — preallocate every buffer once and compute with
    # out= ufuncs. Together: 85 s -> ~2 s.
    f = np.float32
    slab = min(32, z)
    shape = (slab, y, x)
    r2 = np.empty(shape, np.float32)
    density = np.empty(shape, np.float32)
    tmp = np.empty(shape, np.float32)
    mask = np.empty(shape, np.bool_)
    quant = np.empty(shape, np.uint16)
    for z0 in range(0, z, slab):
        z1 = min(z0 + slab, z)
        k = z1 - z0
        zz2 = (
            ((np.arange(z0, z1, dtype=np.float32) - f(cz)) / f(z * 0.45)) ** 2
        )[:, None, None]
        np.add(zz2, yx2[None, :, :], out=r2[:k])
        np.less(r2[:k], f(1.0), out=mask[:k])  # inside the outer shell
        np.multiply(mask[:k], f(0.25), out=density[:k], dtype=np.float32)
        np.less(r2[:k], f(0.49), out=mask[:k])
        np.multiply(mask[:k], f(0.25), out=tmp[:k], dtype=np.float32)
        density[:k] += tmp[:k]
        np.less(r2[:k], f(0.1225), out=mask[:k])
        np.multiply(mask[:k], f(0.4), out=tmp[:k], dtype=np.float32)
        density[:k] += tmp[:k]
        rng.random((k, y, x), dtype=np.float32, out=tmp[:k])
        tmp[:k] *= f(0.05)
        np.less(r2[:k], f(1.0), out=mask[:k])
        tmp[:k] *= mask[:k]
        density[:k] += tmp[:k]
        np.clip(density[:k], f(0.0), f(1.0), out=density[:k])
        density[:k] *= f(max_val)
        np.copyto(quant[:k], density[:k], casting="unsafe")
        out[z0:z1] = quant[:k]
    return out


def synthetic_env_hdr(width: int = 64, height: int = 32) -> bytes:
    """A small sky-like HDR environment: bright sun patch + gradient."""
    v = np.linspace(0, 1, height, dtype=np.float32)[:, None]
    u = np.linspace(0, 1, width, dtype=np.float32)[None, :]
    sky = np.stack(
        [
            0.3 + 0.2 * (1 - v) * np.ones_like(u),
            0.4 + 0.3 * (1 - v) * np.ones_like(u),
            0.7 + 0.3 * (1 - v) * np.ones_like(u),
        ],
        axis=-1,
    )
    sun = np.exp(-(((u - 0.25) * 18) ** 2 + ((v - 0.25) * 12) ** 2))
    img = sky + sun[..., None] * np.array([40.0, 35.0, 25.0], np.float32)
    return encode_hdr(img.astype(np.float32))
