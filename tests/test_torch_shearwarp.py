"""The port's shear-warp preview against the JAX package's.

Host math (shear_parameters, _homography, preview_homography and the
homography half of warp_to_screen) is a numpy copy and must give exactly
the same values. The intermediate image is held to the XLA scan and to the
Pallas kernel in interpret mode at atol 2e-5, the bound the JAX package's
own test holds those two to (tests/test_shearwarp.py): the port places a
slice with the Pallas kernel's 4-tap form, the XLA scan with a separable
one, and the two round apart at the ulp level. Tonemapped images from the
Renderer are held at atol 1e-5.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu import Renderer as JRenderer
from volxel_tpu.grid import construct_brick_grid as jax_construct
from volxel_tpu.render import shearwarp as jsw
from volxel_tpu.utils.fixtures import synthetic_ct_volume
from volxel_tpu_torch import Renderer as TRenderer
from volxel_tpu_torch import kernels
from volxel_tpu_torch.grid import construct_brick_grid as torch_construct
from volxel_tpu_torch.render import shearwarp as tsw
from volxel_tpu_torch.scene.camera import Camera
from volxel_tpu_torch.transfer.function import generate_transfer_function

REPO = Path(__file__).resolve().parent.parent
ATOL_INTERMEDIATE = 2e-5
ATOL_IMAGE = 1e-5
VIEWS = [[0.2, 0.3, 0.9], [-0.9, 0.1, 0.3], [0.1, -0.8, 0.2], [0, 0, 1]]  # tests/test_shearwarp.py's four
# both flips of every principal axis, and |s| = 1 on one or both shear axes
EDGE_VIEWS = [
    [1.0, 1.0, 1.0], [-1.0, 1.0, -1.0], [0.3, -1.0, 1.0], [0.2, 0.3, -0.9],
    [-0.9, 0.1, 0.3], [0.9, -0.5, 0.2], [0.1, -0.8, 0.2], [0.1, 0.8, -0.2], [0.0, 0.0, -1.0],
]


@pytest.fixture(scope="module")
def scene():
    """tests/test_shearwarp.py's 32x24x40 scene and two-stop LUT."""
    rng = np.random.default_rng(0)
    vol = np.zeros((32, 24, 40), np.float32)
    vol[8:24, 6:18, 10:30] = rng.random((16, 12, 20)).astype(np.float32)
    lut = generate_transfer_function(
        [{"color": [1.0, 0.5, 0.2, 0.3], "stop": 0.0}, {"color": [0.2, 0.6, 1.0, 0.9], "stop": 1.0}]
    )
    return vol, np.asarray(lut, np.float32)


def _np(*tensors):
    return [t.numpy() for t in tensors]


def test_shear_parameters_and_homography_identical():
    rng = np.random.default_rng(3)
    for d in VIEWS + EDGE_VIEWS + list(rng.normal(size=(20, 3))):
        assert tsw.shear_parameters(d) == jsw.shear_parameters(d)
    for _ in range(5):
        src, dst = rng.random((4, 2)) * 100, rng.random((4, 2)) * 50
        np.testing.assert_array_equal(tsw._homography(src, dst), jsw._homography(src, dst))


def _camera_matrices(angle, aspect):
    cam = Camera(1.0)
    cam.rotate_around_view(*angle)
    cam.zoom(2.0)
    forward = cam.view - cam.pos
    return forward, cam.view_matrix().astype(np.float64), cam.proj_matrix(aspect).astype(np.float64)


@pytest.mark.parametrize("angle", [(0.5, 0.3), (2.0, -0.4), (-1.2, 1.1), (3.1, 0.0)])
def test_preview_and_warp_homographies_identical(angle, monkeypatch):
    """preview_homography and warp_to_screen's homography (recorded from
    the JAX function's own _homography call) equal the originals."""
    combined = np.diag([1 / 64, 1 / 64, 1 / 64, 1.0]) @ np.array(
        [[1, 0, 0, -32], [0, 1, 0, -32], [0, 0, 1, -32], [0, 0, 0, 1]], np.float64)
    forward, view, proj = _camera_matrices(angle, 48 / 40)
    shape = (64, 64, 64)
    for mid in (None, np.array([12.0, 20.0, 28.0])):
        got = tsw.preview_homography(forward, shape, combined, view, proj, 48, 40, occupied_mid=mid)
        want = jsw.preview_homography(forward, shape, combined, view, proj, 48, 40, occupied_mid=mid)
        assert got[:4] == want[:4]
        assert got[4].dtype == want[4].dtype
        np.testing.assert_array_equal(got[4], want[4])

        recorded = []
        original = jsw._homography
        monkeypatch.setattr(jsw, "_homography", lambda s, d: recorded.append(original(s, d)) or recorded[-1])
        jsw.warp_to_screen(jnp.zeros((70, 90, 3)), jnp.ones((70, 90)), forward, shape, combined, view, proj, 48, 40,
                           occupied_mid=mid)
        monkeypatch.undo()
        np.testing.assert_array_equal(
            tsw.warp_homography(forward, shape, 70, 90, combined, view, proj, 48, 40, mid), recorded[0])


@pytest.mark.parametrize("view_dir", VIEWS)
def test_static_canvas_matches_xla_and_pallas(scene, view_dir):
    vol, lut = scene
    c, t = _np(*tsw.render_dvr(torch.from_numpy(vol), torch.from_numpy(lut), view_dir, vol_maj=1.0))
    for use_pallas in (False, True):
        cj, tj = jsw.render_dvr(jnp.asarray(vol), jnp.asarray(lut), view_dir, vol_maj=1.0, use_pallas=use_pallas,
                                interpret=use_pallas)
        assert c.shape == cj.shape and t.shape == tj.shape
        np.testing.assert_allclose(c, np.asarray(cj), atol=ATOL_INTERMEDIATE, rtol=0)
        np.testing.assert_allclose(t, np.asarray(tj), atol=ATOL_INTERMEDIATE, rtol=0)
    assert c.max() > 0.05 and t.min() < 0.9  # the box is drawn and absorbs


def _fixed_args(vol, view_dir, density_scale=1.3):
    perm, flip, sx, sy = tsw.shear_parameters(view_dir)
    pvol = np.ascontiguousarray(np.transpose(vol, perm)[::-1] if flip else np.transpose(vol, perm))
    return pvol, sx, sy, density_scale * float(np.sqrt(1.0 + sx * sx + sy * sy))


@pytest.mark.parametrize("view_dir", VIEWS)
def test_fixed_canvas_matches_xla_and_pallas(scene, view_dir):
    vol, lut = scene
    pvol, sx, sy, sigma_dt = _fixed_args(vol, view_dir)
    c, t = _np(*tsw.shearwarp_intermediate(torch.from_numpy(pvol), torch.from_numpy(lut), sx, sy, 1.0, sigma_dt,
                                           fixed_canvas=True))
    z_n, y_n, x_n = pvol.shape
    assert t.shape == (y_n + z_n, x_n + z_n)
    args = (jnp.asarray(pvol), jnp.asarray(lut), jnp.float32(sx), jnp.float32(sy), jnp.float32(1.0),
            jnp.float32(sigma_dt))
    cx, tx = jsw._shearwarp_intermediate_xla_dyn(*args)
    with pltpu.force_tpu_interpret_mode():
        cp, tp = jsw._shearwarp_intermediate_pallas_dyn(*args)
    for cj, tj in ((cx, tx), (cp, tp)):
        np.testing.assert_allclose(c, np.asarray(cj), atol=ATOL_INTERMEDIATE, rtol=0)
        np.testing.assert_allclose(t, np.asarray(tj), atol=ATOL_INTERMEDIATE, rtol=0)


def test_last_row_and_column_stay_transparent(scene):
    """On both canvases, for every principal axis and flip and at |s| = 1,
    the canvas's last row and last column keep t == 1 exactly, in the
    port and in the JAX XLA scan: max(t) <= 1e-4 never holds, so the JAX
    versions' early out never fires and the port drops it."""
    vol, lut = scene
    dense = np.maximum(vol, 0.7)  # every voxel opaque enough to matter
    tlut = torch.from_numpy(lut)
    for view_dir in EDGE_VIEWS:
        _, t = tsw.render_dvr(torch.from_numpy(dense), tlut, view_dir, vol_maj=1.0, density_scale=8.0)
        _, tj = jsw.render_dvr(jnp.asarray(dense), jnp.asarray(lut), view_dir, vol_maj=1.0, density_scale=8.0,
                               use_pallas=False)
        pvol, sx, sy, sigma_dt = _fixed_args(dense, view_dir, 8.0)
        _, tf = tsw.shearwarp_intermediate(torch.from_numpy(pvol), tlut, sx, sy, 1.0, sigma_dt, fixed_canvas=True)
        for tt in (t.numpy(), np.asarray(tj), tf.numpy()):
            assert (tt[-1, :] == 1.0).all() and (tt[:, -1] == 1.0).all(), view_dir
            assert tt.min() < 1e-3  # the rest of the canvas does go opaque


@pytest.mark.parametrize("d", [(2.0, 1.0, 1.0), (-2.0, 1.0, 1.0), (1.0, 2.0, 1.0), (1.0, 1.0, 2.0), (1.0, 1.0, -2.0)])
def test_shear_collinear_voxels_align(d):
    """Two voxels collinear with the view ray land on the same intermediate
    pixel (tests/test_shearwarp.py's property, on the port)."""
    n = 12
    vol = np.zeros((n, n, n), np.float32)
    p0 = np.array([4, 4, 4], np.float64)
    for p in (p0, p0 + np.asarray(d)):
        x, y, z = (int(v) for v in p)
        vol[z, y, x] = 1.0
    lut = np.ones((128, 4), np.float32)
    lut[0] = 0.0
    c, _ = tsw.render_dvr(torch.from_numpy(vol), torch.from_numpy(lut), np.asarray(d), vol_maj=1.0,
                          density_scale=8.0)
    lum = c.numpy().sum(axis=-1)
    ys, xs = np.nonzero(lum > 0.05 * lum.max())
    assert np.ptp(ys) <= 1 and np.ptp(xs) <= 1


def _renderers(side):
    vol = synthetic_ct_volume((24, 24, 24), bits_stored=12)
    data = vol.astype(np.float32) / vol.max()
    eye = np.eye(4, dtype=np.float32)
    jr = JRenderer(width=side, height=side)
    jr.restart_from_grid(jax_construct(data, transform=eye))
    tr = TRenderer(side, side, device="cpu")
    tr.restart_from_grid(torch_construct(data, transform=eye))
    for r in (jr, tr):
        r.camera.zoom(2.0)
    return jr, tr


def test_renderer_dvr_matches_jax():
    jr, tr = _renderers(40)
    kernels.reset_launch_counts()
    for angle in ((0.5, 0.3), (1.9, -0.6)):
        for r in (jr, tr):
            r.camera.rotate_around_view(*angle)
        for screen in (False, True):
            got = tr.render_dvr(screen=screen)
            want = jr.render_dvr(use_pallas=False, screen=screen)
            assert got.shape == want.shape and got.dtype == np.float32
            np.testing.assert_allclose(got, want, atol=ATOL_IMAGE, rtol=0)
    assert got.shape == (40, 40, 3) and got.std() > 0.01
    assert all(v == 0 for v in kernels.LAUNCHES.values())  # CPU: plain versions only


def test_renderer_preview_matches_jax():
    """render_preview over views of every principal axis and both flips
    (six cached permuted volumes), at full and half scale."""
    jr, tr = _renderers(48)
    keys = set()
    for angle in ((0.5, 0.3), (1.57, 0.1), (1.57, 0.0), (1.57, 0.0), (0.0, 1.2), (0.0, -2.5), (0.3, 0.2)):
        for r in (jr, tr):
            r.camera.rotate_around_view(*angle)
        keys.add(tsw.shear_parameters(tr._index_view_dir())[:2])
        for scale in (1.0, 0.5):
            got = tr.render_preview(scale=scale)
            want = jr.render_preview(use_pallas=False, scale=scale)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=ATOL_IMAGE, rtol=0)
    assert len(keys) == 6 and set(tr._preview_vol_cache[1]) == keys
    assert got.shape == (24, 24, 3) and got.std() > 0.01


def test_port_imports_every_module_without_jax():
    """A fresh interpreter with jax and volxel_tpu blocked imports every
    module of the port and renders a 16x16 preview and DVR image on the CPU."""
    code = """
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["volxel_tpu"] = None
import numpy as np
import volxel_tpu_torch
names = [m.name for m in pkgutil.walk_packages(volxel_tpu_torch.__path__, "volxel_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from volxel_tpu_torch import Renderer
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume
vol = synthetic_ct_volume((16, 16, 16), bits_stored=12)
r = Renderer(16, 16, device="cpu")
r.restart_from_grid(construct_brick_grid(vol.astype(np.float32) / vol.max()))
a, b = r.render_preview(), r.render_dvr(screen=True)
print(json.dumps({"modules": names, "finite": bool(np.isfinite(a).all() and np.isfinite(b).all()),
                  "shapes": [list(a.shape), list(b.shape)]}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("volxel_tpu_torch.render.shearwarp", "volxel_tpu_torch.render.gather", "volxel_tpu_torch.kernels"):
        assert name in res["modules"]
    assert res["finite"] and res["shapes"] == [[16, 16, 3], [16, 16, 3]]
