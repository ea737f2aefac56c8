"""The port's Renderer surface for the app layer, against the JAX package.

The error state, the URL loaders, the transfer-function text loader, the
light sync, the sample weights, the low-res warm-up, the clip overlay and
its controller, checkpoints and time-series playback. Both packages render
at 8x8 to 48x48 on the CPU (the port through its plain versions).
Tolerances: rendered images atol 2e-2, as tests/test_torch_render.py holds
the path tracer (an ulp-level flip of a stochastic compare changes one
lane's path); the clip overlay atol 1e-6 on one framebuffer carried from
the JAX renderer (the tonemap's tolerance in tests/test_torch_pallas_ops.py);
the port's own checkpoint resumes bit for bit; host values exactly.
"""

from __future__ import annotations

import json
import threading
import urllib.error
from functools import partial
from http.server import HTTPServer, SimpleHTTPRequestHandler
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu import Renderer as JRenderer
from volxel_tpu.api.checkpoint import save_checkpoint as jax_save_checkpoint
from volxel_tpu.grid import construct_brick_grid as jax_construct
from volxel_tpu_torch import Renderer as TRenderer
from volxel_tpu_torch.api.checkpoint import CHECKPOINT_VERSION, load_checkpoint, save_checkpoint
from volxel_tpu_torch.api.timeseries import TimeSeriesPlayer
from volxel_tpu_torch.grid import construct_brick_grid as torch_construct
from volxel_tpu_torch.grid import grid_differences
from volxel_tpu_torch.render.sampling import device_grid_from_brick
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume, synthetic_env_hdr, write_dicom_zip

FIXTURE = Path(__file__).parent / "fixtures" / "reference_benchmark.json"
EYE = np.eye(4, dtype=np.float32)
IMAGE_ATOL = 2e-2


def _volume(side=32):
    vol = synthetic_ct_volume((side,) * 3, bits_stored=12)
    return vol.astype(np.float32) / vol.max()


def _pair(side=16, **settings):
    """(port, JAX) Renderers on one 32^3 scene with the reference's
    settings at full resolution."""
    data = _volume()
    out = []
    for r, grid in ((TRenderer(side, side, device="cpu"), torch_construct(data, transform=EYE)),
                    (JRenderer(width=side, height=side), jax_construct(data, transform=EYE))):
        r.restart_from_grid(grid)
        r.restore_settings(json.loads(FIXTURE.read_text())["sharedSettings"][0])
        r.settings.resolution_factor = 1.0
        r.settings.bounces = 1
        for name, value in settings.items():
            setattr(r.settings, name, value)
        r.restart_rendering()
        out.append(r)
    return out


# -- the error state (viewer.ts:797-821) -----------------------------------------


def test_error_state_gates_render_frame():
    """As tests/test_api.py::test_error_state_gates_renderer: a failed load
    errors the renderer, which gates restarts and makes render_frame raise;
    clear_error resumes; suspend pauses without an error."""
    r = TRenderer(8, 8, device="cpu")
    grid = torch_construct(_volume(16))
    r.restart_from_grid(grid)
    with pytest.raises(Exception):
        r.restart_from_zip(b"garbage")
    assert r.errored and r.suspend and r.last_error is not None
    other = torch_construct(_volume(24))
    r.restart_from_grid(other)  # gated while errored (viewer.ts:1156)
    assert r.grid is grid
    with pytest.raises(RuntimeError, match="error state") as info:
        r.render_frame()
    assert info.value.__cause__ is r.last_error
    r.clear_error()
    assert not r.errored and r.last_error is None and not r.suspend
    r.restart_from_grid(other)
    assert r.grid is other
    r.render_frame()
    assert r.frame_index == 1
    r.suspend = True
    fb = r.render_frame()
    assert r.frame_index == 1 and fb is r._framebuffer
    with pytest.raises(Exception):
        r.restart_from_files([b"not a dicom"])
    assert r.errored


# -- URL loaders -----------------------------------------------------------------


@pytest.fixture
def http_dir(tmp_path):
    """A directory served over HTTP on 127.0.0.1 (an ephemeral port)."""
    httpd = HTTPServer(("127.0.0.1", 0), partial(SimpleHTTPRequestHandler, directory=str(tmp_path)))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield tmp_path, f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_from_attributes_urls(http_dir):
    """zip_url / env_url fetch over HTTP as the JAX package does
    (tests/test_api.py::test_from_attributes_urls), load what the local
    paths load, and a 404 raises HTTPError."""
    tmp, base = http_dir
    vol = synthetic_ct_volume((16, 16, 16), bits_stored=12)
    (tmp / "scan.zip").write_bytes(write_dicom_zip(vol, bits_stored=12))
    (tmp / "sky.hdr").write_bytes(synthetic_env_hdr(16, 8))
    r = TRenderer.from_attributes(width=8, height=8, zip_url=f"{base}/scan.zip", env_url=f"{base}/sky.hdr",
                                  device="cpu")
    local = TRenderer.from_attributes(width=8, height=8, zip_path=tmp / "scan.zip", env_path=tmp / "sky.hdr",
                                      device="cpu")
    assert grid_differences(r.grid, local.grid) == []
    assert r.environment.texture.shape[0] == 8  # the fetched map applied
    assert torch.equal(r.environment.state.envmap, local.environment.state.envmap)
    fb = r.render_frame()
    assert bool(torch.isfinite(fb).all())
    with pytest.raises(urllib.error.HTTPError):
        TRenderer.from_attributes(width=8, height=8, zip_url=f"{base}/missing.zip", device="cpu")


# -- transfer text, light sync, sample weights ---------------------------------------


def test_load_transfer_function_sync_light_and_sample_weight_match_jax():
    tr, jr = _pair(8)
    text = "0 0 0 0\n0.2 0.1 0.05 0.3\n1 0.5 0.2 1\n"
    for r in (tr, jr):
        r.load_transfer_function(text)
    assert tr._transfer_type == jr._transfer_type == "full"
    assert tr._transfer_colors == jr._transfer_colors
    np.testing.assert_array_equal(tr._lut.numpy(), np.asarray(jr._lut))
    with pytest.raises(ValueError):
        tr.load_transfer_function("no rows here")

    for r in (tr, jr):
        r.render_frame()
        r.maybe_sync_light()  # off: nothing changes
        assert r.frame_index == 1
        r.settings.sync_light_dir = True
        r.camera.rotate_around_view(0.5, -0.25)
        r.maybe_sync_light()
        assert r.frame_index == 0
    assert tr.settings.light_dir == jr.settings.light_dir

    for f in range(14):
        tr.frame_index = jr.frame_index = f
        assert tr.sample_weight() == jr.sample_weight()


# -- the low-res warm-up (viewer.ts:132, 1185-1188) ----------------------------------


def test_warmup_preview_images_match_jax():
    """image() during the warm-up shows the 0.33-resolution sample,
    upsampled; the accumulator is untouched until frame 5; both as JAX."""
    tr, jr = _pair(16, warmup_low_res=True)
    for frame in range(1, 8):
        tr.render_frame()
        jr.render_frame()
        timg, jimg = tr.image(), jr.image()
        assert timg.shape == (16, 16, 3) and np.isfinite(timg).all()
        np.testing.assert_allclose(timg, jimg, rtol=0, atol=IMAGE_ATOL)
        if frame <= 5:
            assert tr._warmup_preview[:2] == (5, 5)
            assert not bool(tr._framebuffer.any())  # warm-up frames have zero weight
        else:
            assert tr._warmup_preview is None
    np.testing.assert_allclose(tr.raw_image(), jr.raw_image(), rtol=0, atol=IMAGE_ATOL)


@pytest.mark.parametrize("samples", [4, 12])
def test_render_with_warmup_low_res_matches_jax(samples):
    """render(n) with the flag on: up to six samples through render_frame
    (the warm-up previews), beyond that the mean of frames [5, n) at full
    resolution; both as JAX."""
    tr, jr = _pair(16, warmup_low_res=True)
    timg, jimg = tr.render(samples), jr.render(samples)
    assert tr.frame_index == jr.frame_index == samples
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=IMAGE_ATOL)


# -- the clip overlay and its controller (viewer.ts:1267-1288, 1359-1440) ------------


def test_clip_overlay_and_drag_match_jax():
    tr, jr = _pair(48)
    for r in (tr, jr):
        r.camera.zoom(3.0)
        r.render_frame()
    tr._framebuffer = torch.from_numpy(np.array(jr._framebuffer))  # one framebuffer: the overlay alone differs
    plain = tr.image()
    overlaid = tr.image(show_clipping=True)
    assert not np.allclose(plain, overlaid)
    np.testing.assert_allclose(overlaid, jr.image(show_clipping=True), rtol=0, atol=1e-6)

    controls = tr.make_clip_controller(), jr.make_clip_controller()
    assert tr.clip_controller is controls[0]
    faces = [ctl.hover((0.25, 0.2)) for ctl in controls]
    assert faces[0] == faces[1] is not None
    np.testing.assert_allclose(tr.image(show_clipping=True), jr.image(show_clipping=True), rtol=0, atol=1e-6)
    for ctl in controls:
        assert ctl.begin_drag()
        ctl.drag((0.1, 0.08))
    np.testing.assert_allclose(tr.image(show_clipping=True), jr.image(show_clipping=True), rtol=0, atol=1e-6)
    for ctl in controls:
        ctl.end_drag()
    assert tr.settings.volume_clip_min == jr.settings.volume_clip_min
    assert tr.settings.volume_clip_max == jr.settings.volume_clip_max
    assert (tr.settings.volume_clip_min, tr.settings.volume_clip_max) != ([0.0] * 3, [1.0] * 3)
    assert tr.frame_index == jr.frame_index == 0
    np.testing.assert_allclose(tr.image(show_clipping=True), jr.image(show_clipping=True), rtol=0, atol=1e-6)


# -- checkpoints ---------------------------------------------------------------------


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint the JAX renderer wrote loads into the port's renderer:
    its settings, camera, frame index and framebuffer, and the next frames
    render as the JAX renderer's do."""
    path = tmp_path / "render.npz"
    tr, jr = _pair(16)
    jr.camera.rotate_around_view(0.4, 0.2)
    jr.camera.zoom(2.0)
    jr.settings.bounces = 2
    for _ in range(9):
        jr.render_frame()
    jax_save_checkpoint(jr, path)
    load_checkpoint(tr, path)
    assert tr.frame_index == 9 and tr.settings.bounces == 2
    np.testing.assert_array_equal(tr.camera.pos, jr.camera.pos)
    np.testing.assert_array_equal(tr._framebuffer.numpy(), np.asarray(jr._framebuffer))
    assert tr._framebuffer.device == tr.device
    for _ in range(5):
        tr.render_frame()
        jr.render_frame()
    np.testing.assert_allclose(tr.image(), jr.image(), rtol=0, atol=IMAGE_ATOL)


def test_checkpoint_round_trip_resumes_bit_for_bit(tmp_path):
    path = tmp_path / "render.npz"
    data = _volume(16)
    r1 = TRenderer(16, 16, device="cpu")
    r1.restart_from_grid(torch_construct(data, transform=EYE))
    r1.camera.rotate_around_view(0.4, 0.2)
    r1.settings.bounces = 2
    for _ in range(9):
        r1.render_frame()
    save_checkpoint(r1, path)
    with np.load(path) as saved:
        assert int(saved["version"]) == CHECKPOINT_VERSION and saved["framebuffer"].dtype == np.float32
    for _ in range(5):
        r1.render_frame()
    r2 = TRenderer(16, 16, device="cpu")
    r2.restart_from_grid(torch_construct(data, transform=EYE))
    load_checkpoint(r2, path)
    assert r2.frame_index == 9
    for _ in range(5):
        r2.render_frame()
    assert torch.equal(r2._framebuffer, r1._framebuffer)

    r3 = TRenderer(32, 32, device="cpu")
    r3.restart_from_grid(torch_construct(data, transform=EYE))
    with pytest.raises(ValueError, match="resolution"):
        load_checkpoint(r3, path)


# -- time series -----------------------------------------------------------------------


def test_timeseries_player_over_two_grids():
    """Two timesteps: each shown with its own device grid, the next one
    uploaded with it, the volume's placement kept, evict frees a step; and
    from_zips reads one zip a step."""
    data = _volume(16)
    r = TRenderer(8, 8, device="cpu")
    player = TimeSeriesPlayer(r, np.stack([data, data * 0.25]))
    assert len(player) == 2
    player.set_timestep(0)
    assert r.volume is not None and set(player._device_cache) == {0, 1}
    assert r._device_grid is player._device_cache[0] and r.frame_index == 0
    frames = list(player.play(samples_per_step=2))
    assert [t for t, _ in frames] == [0, 1]
    for _, img in frames:
        assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert r._device_grid is player._device_cache[1] and r.grid is player.grids[1]
    assert not np.array_equal(frames[0][1], frames[1][1])
    assert torch.equal(player._device_cache[1].dense, device_grid_from_brick(torch_construct(data * 0.25), "cpu").dense)
    player.evict(0)
    assert set(player._device_cache) == {1}
    with pytest.raises(ValueError):
        TimeSeriesPlayer(r, data)

    vol = synthetic_ct_volume((16, 16, 16), bits_stored=12)
    zipped = TimeSeriesPlayer.from_zips(r, [write_dicom_zip(vol, bits_stored=12)] * 2)
    assert len(zipped) == 2 and grid_differences(zipped.grids[0], zipped.grids[1]) == []
