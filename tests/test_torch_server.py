"""The port's preview server (volxel_tpu_torch.api.server) on the CPU.

The render loop's body is `PreviewServer.step()`; the command tests call it
directly, without the render thread, so nothing races. The routes are
tested through one server on an ephemeral port with its render thread
running. No wait is longer than WAIT seconds. Tolerance: the fallback
histogram equals the JAX server's on the same grid exactly; the rest are
host values.
"""

from __future__ import annotations

import io
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu import Renderer as JRenderer
from volxel_tpu.api.server import PreviewServer as JPreviewServer
from volxel_tpu.grid import construct_brick_grid as jax_construct
from volxel_tpu_torch import Renderer
from volxel_tpu_torch.api.server import _PAGE, PreviewServer
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.scene.camera import Camera
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume

SIDE = 16
WAIT = 15.0  # seconds, the longest any test waits for the render thread
EYE = np.eye(4, dtype=np.float32)


def _volume():
    vol = synthetic_ct_volume((16, 16, 16), bits_stored=12)
    return vol.astype(np.float32) / vol.max()


def _server(max_samples: int = 6) -> PreviewServer:
    r = Renderer(SIDE, SIDE, device="cpu")
    r.restart_from_grid(construct_brick_grid(_volume(), transform=EYE))
    r.settings.max_samples = max_samples
    return PreviewServer(r, port=0)


def test_rotate_restarts_accumulation_and_serves_a_preview():
    s = _server()
    r = s.renderer
    assert s.step() == "frame" and s.step() == "frame"
    assert r.frame_index == 2 and s._png_version == 2
    pos = r.camera.pos.copy()
    s._commands.put({"type": "rotate", "by": [0.3, 0.1]})
    assert s.step() == "preview"  # the drag preview, while the motion lasts
    assert r.frame_index == 0 and not np.allclose(r.camera.pos, pos)
    assert s._png_version == 3
    preview = Image.open(io.BytesIO(s._png))
    assert preview.size == (SIDE // 2, SIDE // 2)  # preview_scale 0.5
    s._motion_until = 0.0  # the interaction stopped
    assert s.step() == "frame" and r.frame_index == 1
    assert Image.open(io.BytesIO(s._png)).size == (SIDE, SIDE)


def test_zoom_and_pan_apply():
    s = _server()
    s.dvr_preview = False
    cam = Camera(1.0)
    for cmd in ({"type": "zoom", "by": 0.9}, {"type": "pan", "by": [0.05, -0.02]}, {"type": "zoom", "by": 1.1}):
        s._commands.put(cmd)
    s.step()
    cam.zoom(0.9)
    cam.translate_on_plane(0.05, -0.02)
    cam.zoom(1.1)
    np.testing.assert_array_equal(s.renderer.camera.pos, cam.pos)
    np.testing.assert_array_equal(s.renderer.camera.view, cam.view)
    assert s.renderer.frame_index == 1  # restarted, then one frame


def test_bad_commands_and_render_errors_do_not_stop_the_loop():
    s = _server(max_samples=1)
    r = s.renderer
    assert s.step() == "frame"
    s._commands.put({"type": "bogus"})
    assert s.step() == "idle"  # converged: the error stays at /state
    assert s.last_error == "input error: unknown input command 'bogus'"
    s._commands.put({"type": "settings", "values": {"no_such_setting": 1}})
    s.step()
    assert "unknown setting" in s.last_error
    # a value setattr takes but the frame cannot render with: reverted
    s._commands.put({"type": "settings", "values": {"render_mode": "pathtrace", "bounces": 2}})
    assert s.step() == "error"
    assert s.last_error.startswith("render error:")
    assert r.settings.render_mode == "default" and r.settings.bounces == 3
    assert s.step() == "frame" and s.last_error is None


def test_settings_transfer_light_clip_and_mode_commands():
    s = _server()
    s.dvr_preview = False
    r = s.renderer
    for cmd in (
        {"type": "settings", "values": {"gradient_shading": True}},
        {"type": "transfer", "colors": [{"color": [1, 1, 1, 0], "stop": 0}, {"color": [1, 0, 0, 1], "stop": 1}]},
        {"type": "light_drag", "by": [10, -4]},
        {"type": "render_mode", "mode": "raymarch"},
    ):
        s._commands.put(cmd)
    assert s.step() == "frame"
    assert r.settings.gradient_shading and r.render_mode == "raymarch"
    assert r._transfer_colors[1]["color"] == [1, 0, 0, 1]
    assert r.settings.light_dir != [-0.5773502691896258] * 3
    s._commands.put({"type": "clip_begin", "ndc": [0.25, 0.2]})
    s._commands.put({"type": "clip_drag", "ndc": [0.1, 0.08]})
    s._commands.put({"type": "clip_end"})
    s.step()
    assert r.settings.volume_clip_min != [0.0] * 3 or r.settings.volume_clip_max != [1.0] * 3
    assert s._clip is r.clip_controller and not s._clip.adjusting


def test_fallback_histogram_matches_jax_server():
    s = _server()
    jr = JRenderer(width=8, height=8)
    jr.restart_from_grid(jax_construct(_volume(), transform=EYE))
    hist, grad, gmax = s._fallback_histogram()
    jhist, jgrad, jgmax = JPreviewServer(jr, port=0)._fallback_histogram()
    np.testing.assert_array_equal(hist, jhist, strict=True)
    np.testing.assert_array_equal(grad, jgrad, strict=True)
    assert gmax == jgmax and s._fallback_histogram() is s._hist_cache


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=WAIT) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def _post(base, path, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    with urllib.request.urlopen(urllib.request.Request(base + path, data=data, method="POST"), timeout=WAIT) as resp:
        return resp.status, json.loads(resp.read())


def _until(fn, what):
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        value = fn()
        if value:
            return value
        time.sleep(0.02)
    raise AssertionError(f"{what} within {WAIT} s")


def test_routes_over_http():
    s = _server()
    port = s.start()
    base = f"http://127.0.0.1:{port}"
    try:
        assert port != 0
        status, ctype, body = _get(base, "/")
        assert (status, ctype, body.decode()) == (200, "text/html", _PAGE)
        _until(lambda: s._png_version > 0, "a first frame")
        status, ctype, png = _get(base, "/frame.png")
        assert (status, ctype) == (200, "image/png")
        assert Image.open(io.BytesIO(png)).size == (SIDE, SIDE)
        state = json.loads(_get(base, "/state")[2])
        assert (state["width"], state["height"]) == (SIDE, SIDE) and state["samples"] > 0
        assert state["settings"]["display"]["renderMode"] == "default"
        transfer = json.loads(_get(base, "/transfer")[2])
        assert transfer["type"] == "color_stops" and transfer["colors"]
        assert json.loads(_get(base, "/settings.json")[2]) == state["settings"]
        hist = json.loads(_get(base, "/histogram")[2])
        assert len(hist["bars"]) == 256 and hist["range"] == s.renderer.settings.sample_range
        assert json.loads(_get(base, "/benchmark_result")[2]) == {"running": False}
        with pytest.raises(urllib.error.HTTPError) as missing:
            _get(base, "/nothing")
        assert missing.value.code == 404

        assert _post(base, "/input", {"type": "zoom", "by": 0.9}) == (200, {"ok": True})
        assert _post(base, "/settings", {"exposure": 3.0}) == (200, {"ok": True})
        assert _post(base, "/transfer", {"colors": transfer["colors"][:2]}) == (200, {"ok": True})
        _until(lambda: s.renderer.settings.exposure == 3.0, "the settings applied")
        export = json.loads(_get(base, "/settings.json")[2])
        export["display"]["bounces"] = 2
        assert _post(base, "/settings_import", export) == (200, {"ok": True})
        with pytest.raises(urllib.error.HTTPError) as bad:
            _post(base, "/settings_import", {"version": 3})
        assert bad.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as bad_json:
            _post(base, "/input", b"{not json")
        assert bad_json.value.code == 400
        assert _post(base, "/benchmark", {"samples": 3}) == (200, {"ok": True})
        result = _until(lambda: (lambda b: b if b.get("time_per_sample_ms") else None)(
            json.loads(_get(base, "/benchmark_result")[2])), "the benchmark's result")
        assert result["running"] is False and result["done"] >= 3 and result["viewport"] == [SIDE, SIDE]
        assert result["device"]["accelerator"]["platform"] == "cpu"
        assert s.renderer.settings.bounces == 2

        with urllib.request.urlopen(base + "/stream", timeout=WAIT) as stream:
            assert stream.headers.get("Content-Type") == "multipart/x-mixed-replace; boundary=frame"
            assert stream.readline() == b"--frame\r\n"
            assert stream.readline() == b"Content-Type: image/png\r\n"
            length = int(stream.readline().split(b":")[1])
            stream.readline()
            assert Image.open(io.BytesIO(stream.read(length))).size == (SIDE, SIDE)
    finally:
        s.stop()
    assert not s._render_thread.is_alive()
