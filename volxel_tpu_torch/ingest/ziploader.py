"""ZIP series ingest (reference dicom_preprocessor/src/zip.rs:36-125).

Reads every file entry of a ZIP archive as a DICOM slice, enforcing the
reference's single-folder constraint (zip.rs:57-70), and folds them into a
series / brick grid.
"""

from __future__ import annotations

import io
import zipfile
from pathlib import Path

import numpy as np  # noqa: F401  (re-exported convenience)

from volxel_tpu_torch.grid.brick import BrickGrid
from volxel_tpu_torch.ingest.dicom import DicomError, parse_dicom
from volxel_tpu_torch.ingest.series import DicomSeries, _fold_slices, series_to_grid
from volxel_tpu_torch.utils.profiling import span


class ZipIngestError(DicomError):
    pass


ZIP_METHOD_DEFLATE64 = 9
ZIP_METHOD_ZSTD = 93  # APPNOTE 6.3.8; the reference's zip crate enables zstd
ZIP_METHOD_PPMD = 98  # PPMd var.I; reference Cargo.toml:30 feature "ppmd"


def _raw_entry_bytes(zf: zipfile.ZipFile, info: zipfile.ZipInfo) -> bytes:
    import struct

    fp = zf.fp
    fp.seek(info.header_offset)
    header = fp.read(30)
    if header[:4] != b"PK\x03\x04":
        raise ZipIngestError("corrupt local file header")
    name_len, extra_len = struct.unpack("<HH", header[26:30])
    fp.seek(info.header_offset + 30 + name_len + extra_len)
    return fp.read(info.compress_size)


def _read_entry(zf: zipfile.ZipFile, info: zipfile.ZipInfo) -> bytes:
    """zf.read with zstd (93), deflate64 (9) and PPMd (98) fallbacks —
    the methods the reference's zip crate enables (Cargo.toml:30).
    Python's zipfile knows stored/deflate/bzip2/lzma only; the raw stream
    is read from the local header and decoded in-repo
    (ingest/deflate64.py, ingest/ppmd.py) or via the zstandard module.
    """
    if info.compress_type == ZIP_METHOD_PPMD:
        from volxel_tpu_torch.ingest.ppmd import PpmdError, zip_decompress

        try:
            out = zip_decompress(
                _raw_entry_bytes(zf, info), size=info.file_size
            )
        except PpmdError as e:
            raise ZipIngestError(
                f"PPMd entry {info.filename!r}: {e}"
            ) from e
    elif info.compress_type == ZIP_METHOD_ZSTD:
        import zstandard

        out = zstandard.ZstdDecompressor().decompress(
            _raw_entry_bytes(zf, info), max_output_size=info.file_size
        )
    elif info.compress_type == ZIP_METHOD_DEFLATE64:
        from volxel_tpu_torch.ingest.deflate64 import Deflate64Error, inflate64

        try:
            out = inflate64(_raw_entry_bytes(zf, info), info.file_size)
        except Deflate64Error as e:
            raise ZipIngestError(
                f"deflate64 entry {info.filename!r}: {e}"
            ) from e
    else:
        try:
            return zf.read(info)
        except NotImplementedError as e:
            raise ZipIngestError(
                f"ZIP entry {info.filename!r} uses method "
                f"{info.compress_type}, which has no decoder in this "
                "environment (supported: stored, deflate, bzip2, lzma, "
                "zstd, deflate64, ppmd)"
            ) from e
    if len(out) != info.file_size:
        raise ZipIngestError(
            f"entry {info.filename}: size mismatch "
            f"({len(out)} != {info.file_size})"
        )
    return out


def _open_zip(source) -> zipfile.ZipFile:
    if isinstance(source, (bytes, bytearray, memoryview)):
        return zipfile.ZipFile(io.BytesIO(bytes(source)))
    return zipfile.ZipFile(Path(source))


def read_zip_series(source) -> DicomSeries:
    try:
        zf = _open_zip(source)
    except zipfile.BadZipFile as e:
        raise ZipIngestError(f"Not a valid ZIP archive: {e}") from e
    with zf:
        entries = [i for i in zf.infolist() if not i.is_dir()]
        if not entries:
            raise ZipIngestError("ZIP archive contains no files")
        # single-folder constraint (zip.rs:57-70)
        folders = {str(Path(i.filename).parent) for i in entries}
        if len(folders) > 1:
            raise ZipIngestError(
                f"ZIP must contain a single folder of DICOM files, found: {sorted(folders)}"
            )
        with span("vx::ingest.parse"):
            files = [parse_dicom(_read_entry(zf, i)) for i in entries]
    with span("vx::ingest.scan"):
        return _fold_slices(files)


def read_zip_to_grid(source) -> BrickGrid:
    """ZIP bytes/path -> BrickGrid (zip.rs:117-125)."""
    return series_to_grid(read_zip_series(source))
