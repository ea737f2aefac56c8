"""Environment-map decoding to RGBA float32 (reference hdr.rs:23-36).

The reference delegates to the Rust `image` crate for .hdr/.exr. Here the
Radiance RGBE (.hdr) decoder is implemented directly in numpy (both flat
and adaptive-RLE scanline formats). EXR is attempted through imageio if the
environment provides a plugin; otherwise a clear error is raised.

Output layout matches the reference worker contract
(common.ts RETURN_ENV): (height, width, 4) float32, row 0 = image top.
"""

from __future__ import annotations

import numpy as np


class EnvDecodeError(ValueError):
    pass


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 4) float32 RGBA."""
    rgbe = rgbe.astype(np.float32)
    exp = rgbe[..., 3]
    scale = np.where(exp > 0, np.ldexp(1.0, (exp - 136.0).astype(np.int32)), 0.0)
    out = np.empty(rgbe.shape[:-1] + (4,), np.float32)
    out[..., :3] = (rgbe[..., :3] + 0.5) * scale[..., None]
    out[..., 3] = 1.0
    return out


def _decode_rle_scanline(data: bytes, pos: int, width: int) -> tuple[np.ndarray, int]:
    """Adaptive RLE: 4 separately-encoded channel planes."""
    out = np.empty((4, width), np.uint8)
    for ch in range(4):
        x = 0
        while x < width:
            if pos >= len(data):
                raise EnvDecodeError("Truncated HDR RLE scanline")
            count = data[pos]
            pos += 1
            if count > 128:  # run
                run = count - 128
                out[ch, x : x + run] = data[pos]
                pos += 1
                x += run
            else:  # dump
                out[ch, x : x + count] = np.frombuffer(
                    data, np.uint8, count=count, offset=pos
                )
                pos += count
                x += count
        if x != width:
            raise EnvDecodeError("HDR RLE scanline overrun")
    return out.T, pos  # (width, 4)


def decode_hdr(data: bytes) -> np.ndarray:
    """Decode a Radiance .hdr byte stream to (H, W, 4) float32 RGBA."""
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise EnvDecodeError("Not a Radiance HDR stream")
    # header: lines until blank, then resolution line
    pos = 0
    fmt_ok = False
    while True:
        end = data.find(b"\n", pos)
        if end < 0:
            raise EnvDecodeError("Truncated HDR header")
        line = data[pos:end]
        pos = end + 1
        if line.startswith(b"FORMAT="):
            fmt_ok = b"32-bit_rle_rgbe" in line
        if line == b"":
            break
    if not fmt_ok:
        raise EnvDecodeError("HDR stream is not 32-bit_rle_rgbe format")
    end = data.find(b"\n", pos)
    res = data[pos:end].split()
    pos = end + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise EnvDecodeError(f"Unsupported HDR resolution spec: {res}")
    height, width = int(res[1]), int(res[3])

    rows = []
    for _ in range(height):
        if pos + 4 > len(data):
            raise EnvDecodeError("Truncated HDR pixel data")
        head = data[pos : pos + 4]
        if head[0] == 2 and head[1] == 2 and ((head[2] << 8) | head[3]) == width:
            pos += 4
            row, pos = _decode_rle_scanline(data, pos, width)
        else:
            row = np.frombuffer(data, np.uint8, count=width * 4, offset=pos).reshape(
                width, 4
            )
            pos += width * 4
        rows.append(row)
    rgbe = np.stack(rows, axis=0)  # (H, W, 4)
    return _rgbe_to_float(rgbe)


def decode_exr(data: bytes) -> np.ndarray:
    """Decode EXR: the in-repo numpy decoder first (NONE/ZIPS/ZIP scanline
    files), then imageio if a plugin happens to be available."""
    from volxel_tpu_torch.ingest.exr import decode_exr as decode_exr_native

    try:
        return decode_exr_native(data)
    except EnvDecodeError as native_error:
        try:
            import imageio.v3 as iio

            img = iio.imread(data, extension=".exr")
        except Exception:  # pragma: no cover - plugin availability varies
            raise native_error from None
        img = np.asarray(img, dtype=np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
        return img


def decode_env_bytes(data: bytes) -> np.ndarray:
    """Dispatch on magic bytes: Radiance HDR or OpenEXR."""
    if data[:4] == b"\x76\x2f\x31\x01":
        return decode_exr(data)
    return decode_hdr(data)


def encode_hdr(image: np.ndarray) -> bytes:
    """Encode (H, W, 3|4) float32 to a flat (non-RLE) Radiance .hdr stream.

    Used by fixtures and tests; valid input for decode_hdr and any other
    Radiance reader.
    """
    img = np.asarray(image, dtype=np.float32)[..., :3]
    h, w, _ = img.shape
    maxc = img.max(axis=-1)
    with np.errstate(divide="ignore"):
        exp = np.where(maxc > 1e-32, np.ceil(np.log2(np.maximum(maxc, 1e-32))) + 1, 0)
    scale = np.where(maxc > 1e-32, np.ldexp(1.0, (-exp).astype(np.int32)) * 256.0, 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    mant = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., :3] = mant
    rgbe[..., 3] = np.where(maxc > 1e-32, exp + 128, 0).astype(np.uint8)
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    return header + rgbe.tobytes()
