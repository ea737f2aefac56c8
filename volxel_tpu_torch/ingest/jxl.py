"""JPEG XL decode/encode via the system libjxl (ctypes, no pip deps).

Closes the last compressed-DICOM gap vs the reference, which decodes the
JPEG XL transfer syntaxes through its `jpegxl` feature
(dicom_preprocessor/Cargo.toml:25; DICOM UIDs 1.2.840.10008.1.2.4.110-112).
This binding drives libjxl's streaming decoder directly; the encoder half
exists so tests can produce externally-coded fixtures (the encoder is
upstream libjxl, not this repo's code — a true cross-implementation check
for the decode path).

Pixel model for DICOM: one grayscale channel, 8 or 16 bits. RGB decode is
supported for completeness (EXR/HDR-adjacent uses).
"""

from __future__ import annotations

import ctypes
from ctypes import (
    POINTER,
    Structure,
    byref,
    c_float,
    c_int,
    c_size_t,
    c_uint8,
    c_uint32,
    c_void_p,
)

import numpy as np

# -- enums (libjxl 0.7 public headers) ----------------------------------------

JXL_DEC_SUCCESS = 0
JXL_DEC_ERROR = 1
JXL_DEC_NEED_MORE_INPUT = 2
JXL_DEC_NEED_IMAGE_OUT_BUFFER = 5
JXL_DEC_BASIC_INFO = 0x40
JXL_DEC_FULL_IMAGE = 0x1000

JXL_ENC_SUCCESS = 0
JXL_ENC_ERROR = 1
JXL_ENC_NEED_MORE_OUTPUT = 2

JXL_TYPE_FLOAT = 0
JXL_TYPE_UINT8 = 2
JXL_TYPE_UINT16 = 3

JXL_NATIVE_ENDIAN = 0

JXL_TRUE, JXL_FALSE = 1, 0


class JxlPixelFormat(Structure):
    _fields_ = [
        ("num_channels", c_uint32),
        ("data_type", c_int),
        ("endianness", c_int),
        ("align", c_size_t),
    ]


class _Preview(Structure):
    _fields_ = [("xsize", c_uint32), ("ysize", c_uint32)]


class _Animation(Structure):
    _fields_ = [
        ("tps_numerator", c_uint32),
        ("tps_denominator", c_uint32),
        ("num_loops", c_uint32),
        ("have_timecodes", c_int),
    ]


class JxlBasicInfo(Structure):
    _fields_ = [
        ("have_container", c_int),
        ("xsize", c_uint32),
        ("ysize", c_uint32),
        ("bits_per_sample", c_uint32),
        ("exponent_bits_per_sample", c_uint32),
        ("intensity_target", c_float),
        ("min_nits", c_float),
        ("relative_to_max_display", c_int),
        ("linear_below", c_float),
        ("uses_original_profile", c_int),
        ("have_preview", c_int),
        ("have_animation", c_int),
        ("orientation", c_int),
        ("num_color_channels", c_uint32),
        ("num_extra_channels", c_uint32),
        ("alpha_bits", c_uint32),
        ("alpha_exponent_bits", c_uint32),
        ("alpha_premultiplied", c_int),
        ("preview", _Preview),
        ("animation", _Animation),
        ("intrinsic_xsize", c_uint32),
        ("intrinsic_ysize", c_uint32),
        ("padding", c_uint8 * 100),
    ]


_lib = None
_load_error: str | None = None


def _jxl():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL("libjxl.so.0.7")
    except OSError:
        try:
            lib = ctypes.CDLL("libjxl.so")
        except OSError as e:  # pragma: no cover - environment-dependent
            _load_error = str(e)
            return None
    lib.JxlDecoderCreate.restype = c_void_p
    lib.JxlDecoderCreate.argtypes = [c_void_p]
    lib.JxlDecoderDestroy.argtypes = [c_void_p]
    lib.JxlDecoderSubscribeEvents.argtypes = [c_void_p, c_int]
    lib.JxlDecoderSetInput.argtypes = [c_void_p, POINTER(c_uint8), c_size_t]
    lib.JxlDecoderCloseInput.argtypes = [c_void_p]
    lib.JxlDecoderProcessInput.argtypes = [c_void_p]
    lib.JxlDecoderGetBasicInfo.argtypes = [c_void_p, POINTER(JxlBasicInfo)]
    lib.JxlDecoderImageOutBufferSize.argtypes = [
        c_void_p, POINTER(JxlPixelFormat), POINTER(c_size_t),
    ]
    lib.JxlDecoderSetImageOutBuffer.argtypes = [
        c_void_p, POINTER(JxlPixelFormat), c_void_p, c_size_t,
    ]
    lib.JxlEncoderCreate.restype = c_void_p
    lib.JxlEncoderCreate.argtypes = [c_void_p]
    lib.JxlEncoderDestroy.argtypes = [c_void_p]
    lib.JxlEncoderSetBasicInfo.argtypes = [c_void_p, POINTER(JxlBasicInfo)]
    lib.JxlEncoderSetColorEncoding.argtypes = [c_void_p, c_void_p]
    lib.JxlColorEncodingSetToSRGB.argtypes = [c_void_p, c_int]
    lib.JxlEncoderFrameSettingsCreate.restype = c_void_p
    lib.JxlEncoderFrameSettingsCreate.argtypes = [c_void_p, c_void_p]
    lib.JxlEncoderSetFrameLossless.argtypes = [c_void_p, c_int]
    lib.JxlEncoderSetFrameDistance.argtypes = [c_void_p, c_float]
    lib.JxlEncoderAddImageFrame.argtypes = [
        c_void_p, POINTER(JxlPixelFormat), c_void_p, c_size_t,
    ]
    lib.JxlEncoderCloseInput.argtypes = [c_void_p]
    lib.JxlEncoderProcessOutput.argtypes = [
        c_void_p, POINTER(POINTER(c_uint8)), POINTER(c_size_t),
    ]
    _lib = lib
    return _lib


def jxl_available() -> bool:
    return _jxl() is not None


def decode_jxl(data: bytes) -> np.ndarray:
    """Decode a JPEG XL codestream/container -> (H, W) u8/u16 grayscale or
    (H, W, C) for color images."""
    lib = _jxl()
    if lib is None:
        raise RuntimeError(f"libjxl unavailable: {_load_error}")
    dec = lib.JxlDecoderCreate(None)
    if not dec:
        raise RuntimeError("JxlDecoderCreate failed")
    try:
        if lib.JxlDecoderSubscribeEvents(
            dec, JXL_DEC_BASIC_INFO | JXL_DEC_FULL_IMAGE
        ) != JXL_DEC_SUCCESS:
            raise RuntimeError("JxlDecoderSubscribeEvents failed")
        buf = (c_uint8 * len(data)).from_buffer_copy(data)
        if lib.JxlDecoderSetInput(dec, buf, len(data)) != JXL_DEC_SUCCESS:
            raise RuntimeError("JxlDecoderSetInput failed")
        lib.JxlDecoderCloseInput(dec)

        info = JxlBasicInfo()
        out = None
        fmt = None
        while True:
            status = lib.JxlDecoderProcessInput(dec)
            if status == JXL_DEC_ERROR:
                raise ValueError("libjxl: invalid JPEG XL stream")
            if status == JXL_DEC_NEED_MORE_INPUT:
                raise ValueError("libjxl: truncated JPEG XL stream")
            if status == JXL_DEC_BASIC_INFO:
                if lib.JxlDecoderGetBasicInfo(dec, byref(info)) != JXL_DEC_SUCCESS:
                    raise RuntimeError("JxlDecoderGetBasicInfo failed")
                channels = info.num_color_channels + (1 if info.alpha_bits else 0)
                use16 = info.bits_per_sample > 8
                fmt = JxlPixelFormat(
                    num_channels=channels,
                    data_type=JXL_TYPE_UINT16 if use16 else JXL_TYPE_UINT8,
                    endianness=JXL_NATIVE_ENDIAN,
                    align=0,
                )
            elif status == JXL_DEC_NEED_IMAGE_OUT_BUFFER:
                size = c_size_t()
                if lib.JxlDecoderImageOutBufferSize(
                    dec, byref(fmt), byref(size)
                ) != JXL_DEC_SUCCESS:
                    raise RuntimeError("JxlDecoderImageOutBufferSize failed")
                dtype = np.uint16 if fmt.data_type == JXL_TYPE_UINT16 else np.uint8
                out = np.empty(size.value // np.dtype(dtype).itemsize, dtype)
                if lib.JxlDecoderSetImageOutBuffer(
                    dec,
                    byref(fmt),
                    out.ctypes.data_as(c_void_p),
                    size.value,
                ) != JXL_DEC_SUCCESS:
                    raise RuntimeError("JxlDecoderSetImageOutBuffer failed")
            elif status == JXL_DEC_FULL_IMAGE:
                pass  # keep processing until SUCCESS for trailing boxes
            elif status == JXL_DEC_SUCCESS:
                break
            else:  # pragma: no cover - preview/DC events not subscribed
                raise RuntimeError(f"libjxl: unexpected decoder status {status}")
        if out is None:
            raise ValueError("libjxl: no image decoded")
        h, w, c = info.ysize, info.xsize, fmt.num_channels
        img = out.reshape(h, w, c) if c > 1 else out.reshape(h, w)
        return img
    finally:
        lib.JxlDecoderDestroy(dec)


def encode_jxl(
    image: np.ndarray, lossless: bool = True, distance: float = 1.0
) -> bytes:
    """Encode (H, W) u8/u16 grayscale or (H, W, 3) u8 via libjxl (tests/
    fixtures only — production only decodes)."""
    lib = _jxl()
    if lib is None:
        raise RuntimeError(f"libjxl unavailable: {_load_error}")
    image = np.ascontiguousarray(image)
    gray = image.ndim == 2
    channels = 1 if gray else image.shape[2]
    use16 = image.dtype == np.uint16
    if image.dtype not in (np.uint8, np.uint16):
        raise ValueError("encode_jxl expects uint8/uint16")

    enc = lib.JxlEncoderCreate(None)
    if not enc:
        raise RuntimeError("JxlEncoderCreate failed")
    try:
        info = JxlBasicInfo()
        # JxlEncoderInitBasicInfo equivalent (explicit defaults)
        info.xsize, info.ysize = image.shape[1], image.shape[0]
        info.bits_per_sample = 16 if use16 else 8
        info.exponent_bits_per_sample = 0
        info.intensity_target = 255.0
        info.num_color_channels = channels if channels != 4 else 3
        info.alpha_bits = 0
        info.orientation = 1
        info.uses_original_profile = JXL_TRUE if lossless else JXL_FALSE
        if lib.JxlEncoderSetBasicInfo(enc, byref(info)) != JXL_ENC_SUCCESS:
            raise RuntimeError("JxlEncoderSetBasicInfo failed")
        color = (c_uint8 * 1024)()  # JxlColorEncoding is well under 1 KiB
        lib.JxlColorEncodingSetToSRGB(color, JXL_TRUE if gray or channels == 1 else JXL_FALSE)
        if lib.JxlEncoderSetColorEncoding(enc, color) != JXL_ENC_SUCCESS:
            raise RuntimeError("JxlEncoderSetColorEncoding failed")

        fs = lib.JxlEncoderFrameSettingsCreate(enc, None)
        if lossless:
            lib.JxlEncoderSetFrameDistance(fs, 0.0)
            lib.JxlEncoderSetFrameLossless(fs, JXL_TRUE)
        else:
            lib.JxlEncoderSetFrameDistance(fs, c_float(distance))
        fmt = JxlPixelFormat(
            num_channels=channels,
            data_type=JXL_TYPE_UINT16 if use16 else JXL_TYPE_UINT8,
            endianness=JXL_NATIVE_ENDIAN,
            align=0,
        )
        # note: AddImageFrame takes the FRAME SETTINGS handle (encode.h:699)
        if lib.JxlEncoderAddImageFrame(
            fs, byref(fmt), image.ctypes.data_as(c_void_p), image.nbytes
        ) != JXL_ENC_SUCCESS:
            raise RuntimeError("JxlEncoderAddImageFrame failed")
        lib.JxlEncoderCloseInput(enc)

        chunks = []
        chunk = (c_uint8 * 65536)()
        while True:
            next_out = ctypes.cast(chunk, POINTER(c_uint8))
            avail = c_size_t(len(chunk))
            status = lib.JxlEncoderProcessOutput(enc, byref(next_out), byref(avail))
            produced = len(chunk) - avail.value
            chunks.append(bytes(bytearray(chunk)[:produced]))
            if status == JXL_ENC_SUCCESS:
                break
            if status != JXL_ENC_NEED_MORE_OUTPUT:
                raise RuntimeError("JxlEncoderProcessOutput failed")
        return b"".join(chunks)
    finally:
        lib.JxlEncoderDestroy(enc)
