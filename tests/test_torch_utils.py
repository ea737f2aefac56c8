"""The port's host copies for the app layer, and its PNG writer.

volxel_tpu_torch carries copies of five numpy modules of the JAX package,
with the imports pointed at the port: scene/interaction.py,
utils/overlay.py, utils/lightcube.py, utils/histview.py and
transfer/ramp.py. Each is checked as text, and the same inputs, made from
a seed, go through both packages. Tolerance: none — the copies give
exactly the same values.

utils/png.py writes the server's and the CLI's PNGs without an imaging
library. Its files decode, with PIL, to the exact input pixels, which are
the pixels PIL itself writes for the same array.
"""

from __future__ import annotations

import io
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu.scene import interaction as j_interaction
from volxel_tpu.scene.camera import Camera as JCamera
from volxel_tpu.transfer import ramp as j_ramp
from volxel_tpu.utils import histview as j_histview
from volxel_tpu.utils import lightcube as j_lightcube
from volxel_tpu.utils import overlay as j_overlay
from volxel_tpu_torch.scene import interaction as t_interaction
from volxel_tpu_torch.scene.camera import Camera as TCamera
from volxel_tpu_torch.transfer import ramp as t_ramp
from volxel_tpu_torch.utils import histview as t_histview
from volxel_tpu_torch.utils import lightcube as t_lightcube
from volxel_tpu_torch.utils import overlay as t_overlay
from volxel_tpu_torch.utils.png import decode_png, encode_png, write_png

REPO = Path(__file__).resolve().parent.parent
COPIES = ["scene/interaction.py", "utils/overlay.py", "utils/lightcube.py", "utils/histview.py", "transfer/ramp.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_host_copy_equals_original(rel):
    original = (REPO / "volxel_tpu" / rel).read_text()
    port = (REPO / "volxel_tpu_torch" / rel).read_text()
    assert port == original.replace("volxel_tpu.", "volxel_tpu_torch.")


def _same(a, b):
    """Equal results: arrays bit for bit, tuples and lists element-wise."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, strict=True)
    else:
        assert a == b


def _rays(rng, n):
    for _ in range(n):
        origin = rng.uniform(-2.0, 2.0, 3)
        direction = rng.normal(size=3)
        yield origin, direction / np.linalg.norm(direction)


def test_interaction_same_on_same_inputs():
    rng = np.random.default_rng(21)
    lo, hi = np.array([-0.5, -0.4, -0.3]), np.array([0.5, 0.45, 0.3])
    for origin, direction in _rays(rng, 200):
        for fn in ("ray_box_intersection", "ray_box_positions"):
            _same(getattr(t_interaction, fn)(origin, direction, lo, hi),
                  getattr(j_interaction, fn)(origin, direction, lo, hi))
        positions = j_interaction.ray_box_positions(origin, direction, lo, hi)
        for pos in [*(positions or ()), None, rng.uniform(-0.6, 0.6, 3)]:
            _same(t_interaction.cube_face(lo, hi, pos), j_interaction.cube_face(lo, hi, pos))
        o2, d2 = next(_rays(rng, 1))
        _same(t_interaction.closest_points(origin, direction, o2, d2),
              j_interaction.closest_points(origin, direction, o2, d2))
    tcam, jcam = TCamera(1.0), JCamera(1.0)
    for cam in (tcam, jcam):
        cam.rotate_around_view(0.7, -0.3)
        cam.zoom(1.8)
    for _ in range(50):
        ndc = rng.uniform(-1.0, 1.0, 2)
        _same(t_interaction.world_ray(tcam, ndc, 1.6), j_interaction.world_ray(jcam, ndc, 1.6))


def test_overlay_same_on_same_inputs():
    rng = np.random.default_rng(22)
    image = rng.random((40, 56, 3), dtype=np.float32)
    tcam, jcam = TCamera(1.0), JCamera(1.0)
    for face in (None, 0, 1, 2, 3, 4, 5):
        for cam in (tcam, jcam):
            cam.rotate_around_view(0.4, 0.15)
        lo = rng.uniform(-0.5, -0.1, 3)
        hi = rng.uniform(0.1, 0.5, 3)
        args = (lo, hi, tcam.view_matrix(), tcam.proj_matrix(56 / 40), face, face == 3)
        _same(t_overlay.draw_clip_box(image, *args), j_overlay.draw_clip_box(image, *args))


def test_lightcube_same_on_same_inputs():
    rng = np.random.default_rng(23)
    cubes = t_lightcube.LightDirectionCube(), j_lightcube.LightDirectionCube()
    seen = ([], [])
    for cube, log in zip(cubes, seen):
        cube.on_change(log.append)
    for dx, dy in rng.uniform(-300.0, 300.0, (40, 2)):
        for cube in cubes:
            cube.drag(float(dx), float(dy))
        _same(cubes[0].direction, cubes[1].direction)
        _same((cubes[0].pitch, cubes[0].yaw), (cubes[1].pitch, cubes[1].yaw))
    vec = rng.normal(size=3)
    for cube in cubes:
        cube.direction = vec
    _same(cubes[0].direction, cubes[1].direction)
    _same(seen[0], seen[1])


def test_histview_same_on_same_inputs():
    rng = np.random.default_rng(24)
    for n in (5, 256, 4096):
        hist = rng.integers(0, 100000, n).astype(np.uint32)
        grad = rng.integers(-5000, 5000, n).astype(np.int64)
        gmax = int(np.abs(grad).max())
        _same(t_histview.histogram_view_data(hist, grad, gmax), j_histview.histogram_view_data(hist, grad, gmax))


def test_ramp_same_on_same_inputs():
    rng = np.random.default_rng(25)
    ramps = t_ramp.ColorRamp(), j_ramp.ColorRamp()
    seen = ([], [])
    for ramp, log in zip(ramps, seen):
        ramp.on_change(lambda stops, log=log: log.append([dict(s) for s in stops]))
    for step in range(30):
        op = step % 4
        pos = float(rng.uniform(-0.2, 1.2))
        color = [float(v) for v in rng.random(4)]
        idx = int(rng.integers(0, len(ramps[1].stops)))
        for ramp in ramps:
            if op == 0:
                ramp.add_stop(pos, color if step % 8 else None)
            elif op == 1:
                ramp.move_stop(idx, pos)
            elif op == 2:
                ramp.set_color(idx, color)
            elif len(ramp.stops) > 2:
                ramp.remove_stop(idx)
        _same(ramps[0].stops, ramps[1].stops)
        _same(ramps[0].sample(pos), ramps[1].sample(pos))
    _same(ramps[0].lut(), ramps[1].lut())
    _same(ramps[0].lut(64), ramps[1].lut(64))
    _same(seen[0], seen[1])


# -- utils/png.py ----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (16, 16), (3, 7), (54, 96)])
def test_png_decodes_to_the_input_pixels(shape):
    rng = np.random.default_rng(26)
    rgb = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    data = encode_png(rgb)
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == "RGB" and im.size == (shape[1], shape[0])
        ours = np.asarray(im)
    buf = io.BytesIO()
    Image.fromarray(rgb, "RGB").save(buf, "PNG")
    with Image.open(io.BytesIO(buf.getvalue())) as im:
        theirs = np.asarray(im)
    np.testing.assert_array_equal(ours, rgb)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(decode_png(data), rgb)


def test_png_of_a_rendered_image(tmp_path):
    """The server's and the CLI's conversion of a tonemapped float image,
    written to a file and read back with PIL."""
    img = np.random.default_rng(27).uniform(-0.1, 1.1, (24, 40, 3)).astype(np.float32)
    rgb = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    path = tmp_path / "frame.png"
    write_png(path, rgb)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), rgb)


def test_png_rejects_what_it_cannot_write_or_read():
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        encode_png(np.zeros((0, 4, 3), np.uint8))
    data = bytearray(encode_png(np.zeros((4, 4, 3), np.uint8)))
    with pytest.raises(ValueError):
        decode_png(b"GIF89a" + bytes(data[6:]))
    data[-20] ^= 0xFF  # inside the IDAT chunk: its CRC no longer matches
    with pytest.raises(ValueError):
        decode_png(bytes(data))
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint8), "L").save(buf, "PNG")  # greyscale
    with pytest.raises(ValueError):
        decode_png(buf.getvalue())
    assert zlib.crc32(b"IEND") == 0xAE426082  # the chunk CRC is zlib's
