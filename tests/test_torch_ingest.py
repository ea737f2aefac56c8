"""The port's ingest layer and native library against the JAX package's.

volxel_tpu_torch carries copies of volxel_tpu/ingest/, of the two C++
sources of volxel_tpu/native/ and of the grid builder, with the imports
pointed at the port (the card's machine has no JAX, and importing any
volxel_tpu module imports it). The copies are checked as text, and the same
inputs, made from a seed, go through both packages. Tolerance: none — the
copies must give exactly the same arrays, bytes and values, on the native
paths and on the numpy ones.
"""

from __future__ import annotations

import inspect
import re
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

import tests.torch_threads  # noqa: F401  (caps torch's threads)
import volxel_tpu.native.loader as j_loader
import volxel_tpu_torch.native.loader as t_loader
from volxel_tpu.grid import brick as j_brick
from volxel_tpu.ingest import deflate64 as j_deflate64
from volxel_tpu.ingest import dicom as j_dicom
from volxel_tpu.ingest import exr as j_exr
from volxel_tpu.ingest import hdr as j_hdr
from volxel_tpu.ingest import jpeg as j_jpeg
from volxel_tpu.ingest import jxl as j_jxl
from volxel_tpu.ingest import piz as j_piz
from volxel_tpu.ingest import ppmd as j_ppmd
from volxel_tpu.ingest import rle as j_rle
from volxel_tpu.ingest import series as j_series
from volxel_tpu.ingest import worker as j_worker
from volxel_tpu.ingest import ziploader as j_zip
from volxel_tpu.utils import fixtures as j_fixtures
from volxel_tpu_torch.grid import brick as t_brick
from volxel_tpu_torch.grid import grid_differences
from volxel_tpu_torch.ingest import deflate64 as t_deflate64
from volxel_tpu_torch.ingest import dicom as t_dicom
from volxel_tpu_torch.ingest import exr as t_exr
from volxel_tpu_torch.ingest import hdr as t_hdr
from volxel_tpu_torch.ingest import jpeg as t_jpeg
from volxel_tpu_torch.ingest import jxl as t_jxl
from volxel_tpu_torch.ingest import piz as t_piz
from volxel_tpu_torch.ingest import ppmd as t_ppmd
from volxel_tpu_torch.ingest import rle as t_rle
from volxel_tpu_torch.ingest import series as t_series
from volxel_tpu_torch.ingest import worker as t_worker
from volxel_tpu_torch.ingest import ziploader as t_zip
from volxel_tpu_torch.utils import fixtures as t_fixtures

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).parent / "fixtures"
RLE = "1.2.840.10008.1.2.5"
JPEG_LOSSLESS = "1.2.840.10008.1.2.4.70"

# the copies' deliberate differences from the originals besides the
# imports: two docstrings cite the reference's sources by their path inside
# its repository, the worker's upload is the Renderer's, and the ZIP ingest's
# three stages are the port's spans (utils.profiling)
PORT_EDITS = {
    "ingest/dwa.py": [(r"\(/\S+?/dicom_preprocessor/", "(dicom_preprocessor/")],
    "ingest/ppmd.py": [(r"\(/\S+?/dicom_preprocessor/", "(dicom_preprocessor/")],
    "ingest/series.py": [
        (r"(from volxel_tpu_torch\.utils\.mathutil import scale_matrix\n)",
         r"\1from volxel_tpu_torch.utils.profiling import span\n"),
        (r"(lib\.rs:193-202\)\.\"\"\"\n)((?:    .*\n)+)",  # series_to_grid's body, under the span
         lambda m: m[1] + '    with span("vx::ingest.grid"):\n' + re.sub(r"(?m)^(?=.)", "    ", m[2])),
    ],
    "ingest/ziploader.py": [
        (r"(from volxel_tpu_torch\.ingest\.series import DicomSeries, _fold_slices, series_to_grid\n)",
         r"\1from volxel_tpu_torch.utils.profiling import span\n"),
        (r"        files = (.*)\n    return _fold_slices\(files\)\n",
         '        with span("vx::ingest.parse"):\n            files = \\1\n    with span("vx::ingest.scan"):\n'
         "        return _fold_slices(files)\n"),
    ],
    "ingest/worker.py": [(r'"transfer" is jax\.device_put of the\nfinished grid buffers\.',
                          '"transfer" is the Renderer\'s upload of\nthe finished grid buffers to its device.')],
}
COPIES = sorted(f"ingest/{p.name}" for p in (REPO / "volxel_tpu" / "ingest").glob("*.py")) + ["grid/brick.py"]


def _rewrite(text: str, edits=()) -> str:
    text = text.replace("volxel_tpu.", "volxel_tpu_torch.")
    for pattern, repl in edits:
        text, n = re.subn(pattern, repl, text)
        assert n == 1, pattern
    return text


@pytest.mark.parametrize("rel", COPIES)
def test_python_copy_equals_original(rel):
    original = (REPO / "volxel_tpu" / rel).read_text()
    port = (REPO / "volxel_tpu_torch" / rel).read_text()
    assert port == _rewrite(original, PORT_EDITS.get(rel, ()))


@pytest.mark.parametrize("name", ["volxel_native.cpp", "volxel_ppmd.cpp"])
def test_native_source_byte_equal(name):
    assert (REPO / "volxel_tpu_torch" / "native" / name).read_bytes() == (
        REPO / "volxel_tpu" / "native" / name
    ).read_bytes()


@pytest.mark.parametrize(
    "name", ["_element", "_encapsulate", "write_dicom_slice", "write_dicom_series", "write_dicom_zip",
             "synthetic_env_hdr"]
)
def test_fixture_writer_copied(name):
    port = inspect.getsource(getattr(t_fixtures, name))
    assert port == _rewrite(inspect.getsource(getattr(j_fixtures, name)))


# -- the native library --------------------------------------------------------


def test_native_library_is_the_ports_own():
    lib = t_loader.get_native()
    assert lib is not None, t_loader._load_error
    path = Path(lib._name).resolve()
    assert path.parent == (REPO / "volxel_tpu_torch" / "build").resolve()
    assert path == t_loader.library_path().resolve()
    assert path.name != "libvolxel_native.so"


def test_concurrent_builds_leave_one_whole_library(tmp_path):
    """Processes that build at once (parallel test workers) each load a
    whole library under the keyed name, and leave no temporary file."""
    script = (
        "import sys; from pathlib import Path; import volxel_tpu_torch.native.loader as L; "
        "L.BUILD = Path(sys.argv[1]); assert L.native_available(), L._load_error; "
        "assert L.scan_u16(L.np.arange(10, dtype=L.np.uint16), 16)[2] == 9; print(L.library_path().name)"
    )
    procs = [subprocess.Popen([sys.executable, "-c", script, str(tmp_path)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], [err for _, err in outs]
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(names)


def test_loader_scan_and_brick_construct_match():
    rng = np.random.default_rng(11)
    px = rng.integers(0, 4096, (3, 40, 36)).astype(np.uint16)
    for a, b in zip(t_loader.scan_u16(px, 4096), j_loader.scan_u16(px, 4096)):
        np.testing.assert_array_equal(a, b)
    data = rng.random((40, 24, 33), dtype=np.float32)
    data[data < 0.6] = 0.0
    for a, b in zip(t_loader.brick_construct(data, 8, 8, 8), j_loader.brick_construct(data, 8, 8, 8)):
        np.testing.assert_array_equal(a, b)


def test_loader_huf_and_ppmd_match():
    rng = np.random.default_rng(5)
    symbols = (rng.geometric(0.2, 3000) % 700).astype(np.uint16)
    blob = t_piz.huf_compress(symbols)
    assert blob == j_piz.huf_compress(symbols)
    got, want = t_loader.huf_uncompress(blob, symbols.size), j_loader.huf_uncompress(blob, symbols.size)
    assert got[0] == want[0] == symbols.size
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[1], symbols)
    data = b"the quick brown fox jumps over the lazy dog " * 20
    stream = t_ppmd.compress(data, order=6, mem_mb=8)
    assert stream == j_ppmd.compress(data, order=6, mem_mb=8)
    for size in (None, len(data)):
        assert t_loader.ppmd_decompress(stream, 6, 8, 0, size) == j_loader.ppmd_decompress(stream, 6, 8, 0, size) \
            == (len(data), data)


# -- environment decoders --------------------------------------------------------


@pytest.mark.parametrize("name", sorted(p.name for p in FIXTURES.glob("*.exr")))
def test_exr_fixture_decodes_equal(name):
    data = (FIXTURES / name).read_bytes()
    got, want = t_hdr.decode_env_bytes(data), j_hdr.decode_env_bytes(data)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_exr.decode_exr(data), want)


def test_synthetic_env_hdr_roundtrip_equal():
    blob = t_fixtures.synthetic_env_hdr(64, 32)
    assert blob == j_fixtures.synthetic_env_hdr(64, 32)
    img = t_hdr.decode_env_bytes(blob)
    assert img.shape[:2] == (32, 64)
    np.testing.assert_array_equal(img, j_hdr.decode_env_bytes(blob))
    again = t_hdr.encode_hdr(img)
    assert again == j_hdr.encode_hdr(img)
    np.testing.assert_array_equal(t_hdr.decode_hdr(again), j_hdr.decode_hdr(again))


def test_exr_encoders_equal():
    img = np.random.default_rng(2).random((12, 20, 4), dtype=np.float32) * 4
    for t_enc, j_enc in ((t_exr.encode_exr_piz, j_exr.encode_exr_piz),
                         (t_exr.encode_exr_uncompressed, j_exr.encode_exr_uncompressed)):
        blob = t_enc(img)
        assert blob == j_enc(img)
        np.testing.assert_array_equal(t_hdr.decode_env_bytes(blob), j_hdr.decode_env_bytes(blob))


# -- pixel codecs ----------------------------------------------------------------


@pytest.fixture(scope="module")
def ct_slice():
    vol = t_fixtures.synthetic_ct_volume((4, 48, 56), bits_stored=12)
    return vol[2].astype(np.uint16)


def _force_numpy(monkeypatch):
    monkeypatch.setattr(t_loader, "native_available", lambda: False)
    monkeypatch.setattr(j_loader, "native_available", lambda: False)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", ["gdcm_lossless_16bit.jpg", "gdcm_lossless_sv1.jpg"])
def test_jpeg_lossless_fixture_decodes_equal(name, native, monkeypatch):
    if not native:
        _force_numpy(monkeypatch)
    data = (FIXTURES / name).read_bytes()
    got, want = t_jpeg.decode(data), j_jpeg.decode(data)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("syntax", [JPEG_LOSSLESS, RLE, "1.2.840.10008.1.2.2"], ids=["jpeg", "rle", "big-endian"])
def test_encapsulated_dicom_slice_equal(ct_slice, syntax, native, monkeypatch):
    if not native:
        _force_numpy(monkeypatch)
    blob = t_fixtures.write_dicom_slice(ct_slice, bits_stored=12, transfer_syntax=syntax)
    assert blob == j_fixtures.write_dicom_slice(ct_slice, bits_stored=12, transfer_syntax=syntax)
    got, want = t_dicom.parse_dicom(blob).pixel_array(), j_dicom.parse_dicom(blob).pixel_array()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], ct_slice)


def test_raw_codecs_equal():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 65536, (33, 29)).astype(np.uint16)
    enc = t_jpeg.encode_lossless_sv1(img, precision=16)
    assert enc == j_jpeg.encode_lossless_sv1(img, precision=16)
    np.testing.assert_array_equal(t_jpeg.decode(enc), j_jpeg.decode(enc))
    small = rng.integers(0, 256, (9, 31)).astype(np.uint8)
    for arr in (img, small):
        enc = t_rle.encode_rle(arr)
        assert enc == j_rle.encode_rle(arr)
        bits = 8 * arr.itemsize
        np.testing.assert_array_equal(t_rle.decode_rle(enc, *arr.shape, bits), j_rle.decode_rle(enc, *arr.shape, bits))


def test_jxl_availability_and_decode_equal():
    assert t_jxl.jxl_available() == j_jxl.jxl_available()
    if not t_jxl.jxl_available():
        return  # no system libjxl: both report it unavailable
    img = t_fixtures.synthetic_ct_volume((2, 24, 20), bits_stored=12)[1]
    blob = j_jxl.encode_jxl(img)
    np.testing.assert_array_equal(t_jxl.decode_jxl(blob), j_jxl.decode_jxl(blob))


# -- ZIP methods -----------------------------------------------------------------


def test_deflate64_equal():
    rng = np.random.default_rng(3)
    base = np.tile(rng.integers(0, 90, 139, dtype=np.uint8), 100)
    noise = (rng.random(base.size) < 0.2) * rng.integers(1, 255, base.size, dtype=np.uint8)
    data = (base ^ noise).tobytes()  # matches stay short: no code 285
    for level in (0, 1, 9):
        comp = zlib.compressobj(level, zlib.DEFLATED, -15)
        blob = comp.compress(data) + comp.flush()
        assert t_deflate64.inflate64(blob, len(data)) == j_deflate64.inflate64(blob, len(data)) == data
    junk = rng.integers(0, 256, 200, dtype=np.uint8).tobytes()
    errors = []
    for mod in (t_deflate64, j_deflate64):
        try:
            errors.append(("ok", mod.inflate64(junk, max_output=1 << 16)))
        except mod.Deflate64Error as e:
            errors.append(("error", str(e)))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_ppmd_equal(native, monkeypatch):
    if not native:
        _force_numpy(monkeypatch)
    cases = [b"", b"abracadabra", b"the quick brown fox jumps over the lazy dog " * 20, bytes(range(256)) * 4]
    for data in cases:
        for order in (2, 6):
            stream = t_ppmd.compress(data, order=order, mem_mb=8)
            assert stream == j_ppmd.compress(data, order=order, mem_mb=8)
            assert t_ppmd.decompress(stream, order=order, mem_mb=8) == j_ppmd.decompress(
                stream, order=order, mem_mb=8) == data
        blob = t_ppmd.zip_compress(data)
        assert blob == j_ppmd.zip_compress(data)
        assert t_ppmd.zip_decompress(blob, size=len(data)) == j_ppmd.zip_decompress(blob, size=len(data)) == data


def _zip_with_method(blobs, method: int, compress) -> bytes:
    """A single-folder ZIP whose entries carry `method`, each payload
    `compress(blob)` (how tests/test_ingest.py relabels deflate streams)."""
    import struct

    out, central = bytearray(), bytearray()
    for i, blob in enumerate(blobs):
        name = f"series/slice_{i:04d}.dcm".encode()
        payload = compress(blob)
        crc = zlib.crc32(blob)
        offset = len(out)
        out += struct.pack("<IHHHHHIIIHH", 0x04034B50, 63, 0, method, 0, 0, crc, len(payload), len(blob),
                           len(name), 0) + name + payload
        central += struct.pack("<IHHHHHHIIIHHHHHII", 0x02014B50, 63, 63, 0, method, 0, 0, crc, len(payload),
                               len(blob), len(name), 0, 0, 0, 0, 0, offset) + name
    eocd = struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, len(blobs), len(blobs), len(central), len(out), 0)
    return bytes(out) + bytes(central) + eocd


def _deflate_stored(blob: bytes) -> bytes:
    comp = zlib.compressobj(0, zlib.DEFLATED, -15)  # stored blocks: no code 285
    return comp.compress(blob) + comp.flush()


@pytest.mark.parametrize("method", ["deflate64", "ppmd"])
def test_zip_methods_through_ingest_equal(method):
    vol = t_fixtures.synthetic_ct_volume((4, 16, 16), bits_stored=12)
    blobs = t_fixtures.write_dicom_series(vol, bits_stored=12)
    if method == "deflate64":
        archive = _zip_with_method(blobs, t_zip.ZIP_METHOD_DEFLATE64, _deflate_stored)
    else:
        archive = _zip_with_method(blobs, t_zip.ZIP_METHOD_PPMD, t_ppmd.zip_compress)
    got, want = t_zip.read_zip_series(archive), j_zip.read_zip_series(archive)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.data, vol)
    np.testing.assert_array_equal(got.histogram, want.histogram)


# -- the whole ingest ------------------------------------------------------------


def assert_grids_equal(tg, jg):
    """Every field of the two grids equal, the arrays bit for bit."""
    assert grid_differences(tg, jg) == []


def zip_entries(blob: bytes) -> list:
    """(name, compress type, contents) of each entry: two archives written
    at different times differ only in their entries' timestamps."""
    import io
    import zipfile

    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        return [(i.filename, i.compress_type, zf.read(i)) for i in zf.infolist()]


@pytest.fixture(scope="module")
def ct_zip():
    vol = t_fixtures.synthetic_ct_volume((24, 24, 24), bits_stored=12, seed=0)
    blob = t_fixtures.write_dicom_zip(vol, bits_stored=12)
    assert zip_entries(blob) == zip_entries(j_fixtures.write_dicom_zip(vol, bits_stored=12))
    return blob


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_read_zip_to_grid_equal(ct_zip, native, monkeypatch):
    if not native:
        _force_numpy(monkeypatch)
    else:
        assert t_loader.native_available() and j_loader.native_available()
    tg, jg = t_zip.read_zip_to_grid(ct_zip), j_zip.read_zip_to_grid(ct_zip)
    assert_grids_equal(tg, jg)


def test_native_and_numpy_grids_equal(ct_zip):
    series = t_zip.read_zip_series(ct_zip)
    grad, gmin, gmax = series.histogram_gradient()
    kwargs = dict(transform=series.transform, histogram=series.histogram, histogram_gradient=grad,
                  histogram_gradient_range=(gmin, gmax))
    native = t_brick.construct_brick_grid(series.normalized(), use_native=True, **kwargs)
    plain = t_brick.construct_brick_grid(series.normalized(), use_native=False, **kwargs)
    assert_grids_equal(native, plain)
    assert_grids_equal(t_series.series_to_grid(series), j_series.series_to_grid(j_zip.read_zip_series(ct_zip)))
    assert_grids_equal(native, j_brick.construct_brick_grid(series.normalized(), use_native=False, **kwargs))


def test_grid_differences_names_each_changed_field(ct_zip):
    import copy

    grid = t_zip.read_zip_to_grid(ct_zip)
    assert grid_differences(grid, copy.deepcopy(grid)) == []
    changed = copy.deepcopy(grid)
    changed.atlas.reshape(-1)[7] ^= 1
    changed.range_mips[1][0].reshape(-1)[0] = np.nextafter(changed.range_mips[1][0].reshape(-1)[0], np.float32(2))
    changed.transform = changed.transform.astype(np.float64)
    changed.min_maj = (changed.min_maj[0], changed.min_maj[1] + 1.0)
    assert grid_differences(grid, changed) == ["atlas", "range_mips[1][0]", "min_maj", "transform"]
    fewer = copy.deepcopy(grid)
    fewer.range_mips = fewer.range_mips[:-1]
    assert grid_differences(grid, fewer) == ["range_mips"]


def test_ingest_worker_futures_equal(ct_zip):
    env = t_fixtures.synthetic_env_hdr(64, 32)
    stages = []
    with t_worker.IngestWorker(progress_callback=stages.append) as tw, j_worker.IngestWorker() as jw:
        futures = [(tw.load_zip(ct_zip), jw.load_zip(ct_zip)), (tw.load_env(env), jw.load_env(env))]
        slices = t_fixtures.write_dicom_series(t_fixtures.synthetic_ct_volume((8, 16, 16), bits_stored=12))
        futures.append((tw.load_files(slices), jw.load_files(slices)))
        (tz, jz), (te, je), (tf, jf) = [(a.result(timeout=120), b.result(timeout=120)) for a, b in futures]
    assert_grids_equal(tz, jz)
    assert_grids_equal(tf, jf)
    np.testing.assert_array_equal(te, je)
    assert "Brick grid ready" in stages
