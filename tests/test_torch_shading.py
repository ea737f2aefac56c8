"""Gradient shading and debug hits: the port against the JAX package.

The same 32^3 volume and the reference's settings export go through both
Renderers at 16x16 on the CPU (the port through its plain versions).
Tolerances:

- `density_gradient` on a JAX grid carried across with
  `api/convert.from_jax_state`: rtol 1e-6 (both sum the eight taps in one
  order; XLA may contract a product into an FMA).
- gradient-shaded images in the three modes: atol 2e-2 on the tonemapped
  image, as tests/test_torch_render.py holds the path tracer (an ulp-level
  flip of a stochastic compare moves one lane's first hit).
- debug-hits images, also with `RenderConfig.hide_envmap`: atol 1e-5 on
  the linear image (the environment's acos and atan2 round an ulp apart
  in XLA and ATen; the tonemap's gamma magnifies that near black, so the
  tonemapped image is held at 2e-2).
- `background_color` with `hide_envmap`: atol 1e-6; without it, the
  environment lookup at test_torch_environment.py's rtol 1e-5, atol 1e-6.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu import Renderer as JRenderer
from volxel_tpu.grid import construct_brick_grid as jax_construct
from volxel_tpu.render.sampling import device_grid_from_brick as jax_device_grid
from volxel_tpu.render.shading import density_gradient as jax_density_gradient
from volxel_tpu.scene.environment import background_color as jax_background_color
from volxel_tpu.utils.fixtures import synthetic_ct_volume
from volxel_tpu_torch import Renderer as TRenderer
from volxel_tpu_torch.api.convert import from_jax_state
from volxel_tpu_torch.grid import construct_brick_grid as torch_construct
from volxel_tpu_torch.render import pathtrace
from volxel_tpu_torch.render.shading import density_gradient
from volxel_tpu_torch.scene.environment import background_color, default_environment

FIXTURE = Path(__file__).parent / "fixtures" / "reference_benchmark.json"
W = H = 16
FRAMES = 12  # frames 5..11 accumulate
EYE = np.eye(4, dtype=np.float32)


def _volume():
    vol = synthetic_ct_volume((32, 32, 32), bits_stored=12)
    return vol.astype(np.float32) / vol.max()


def _setup(r, grid, mode, **settings):
    r.restart_from_grid(grid)
    r.restore_settings(json.loads(FIXTURE.read_text())["sharedSettings"][0])
    r.settings.resolution_factor = 1.0
    r.render_mode = mode
    r.settings.bounces = 1
    for name, value in settings.items():
        setattr(r.settings, name, value)
    r.restart_rendering()
    return r


def _pair(mode, **settings):
    """(port, JAX) Renderers on the same scene, FRAMES frames rendered."""
    data = _volume()
    tr = _setup(TRenderer(W, H, device="cpu"), torch_construct(data, transform=EYE), mode, **settings)
    jr = _setup(JRenderer(width=W, height=H), jax_construct(data, transform=EYE), mode, **settings)
    for _ in range(FRAMES):
        tr.render_frame()
        jr.render_frame()
    return tr, jr


def test_density_gradient_matches_jax():
    jr = JRenderer(width=8, height=8)
    jr.restart_from_grid(jax_construct(_volume(), transform=EYE))
    _, _, jparams, jlut, jenv, *_ = jr._prime_operands(jr._config())
    jgrid = jax_device_grid(jax_construct(_volume(), transform=EYE))
    grid, params, _, _ = from_jax_state(*jax.tree_util.tree_map(np.asarray, (jgrid, jparams, jlut, jenv)),
                                        device="cpu")
    rng = np.random.default_rng(5)
    # inside, on the edges and past the edges of the field (taps read 0 there)
    ipos = rng.uniform(-2.0, 34.0, (4096, 3)).astype(np.float32)
    want = np.asarray(jax_density_gradient(jgrid, jparams, jnp.asarray(ipos)))
    got = density_gradient(grid, params, torch.from_numpy(ipos)).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("mode", ["default", "raymarch", "no_dda"])
def test_gradient_shading_matches_jax(mode):
    tr, jr = _pair(mode, gradient_shading=True)
    img = tr.image()
    assert np.isfinite(img).all() and img.max() > img.min()
    np.testing.assert_allclose(img, jr.image(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("mode", ["default", "raymarch", "no_dda"])
def test_debug_hits_match_jax(mode):
    tr, jr = _pair(mode, debug_hits=True)
    np.testing.assert_allclose(tr.raw_image(), jr.raw_image(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tr.image(), jr.image(), rtol=0, atol=2e-2)


def test_debug_hits_hide_envmap_match_jax():
    """RenderConfig.hide_envmap, which no Renderer setting sets in either
    package, through render_pixels: the debug-hits background is the
    checker in place of the map. The camera backs off to twice its
    distance, so that most rays miss the box."""
    data = _volume()
    tr, shown = (_setup(TRenderer(W, H, device="cpu"), torch_construct(data, transform=EYE), "default",
                        debug_hits=True) for _ in range(2))
    jr = _setup(JRenderer(width=W, height=H), jax_construct(data, transform=EYE), "default", debug_hits=True)
    for r in (tr, shown, jr):
        assert r.camera.zoom(2.0)
        r.restart_rendering()
    tr._config = lambda: TRenderer._config(tr)._replace(hide_envmap=True)
    jr._config = lambda: JRenderer._config(jr)._replace(hide_envmap=True)
    for r in (tr, shown, jr):
        r.render_frame()
    got, want = tr.raw_image(), jr.raw_image()
    assert (np.abs(got - shown.raw_image()).max(axis=-1) > 1e-3).mean() > 0.5  # the checker, not the map
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("hide", [False, True])
def test_background_color_matches_jax(hide):
    rng = np.random.default_rng(9)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    light = np.array([-1.0, -1.0, -1.0], np.float32) / np.sqrt(3.0)
    jr = JRenderer(width=8, height=8)
    env = default_environment("cpu")
    want = np.asarray(jax_background_color(jr.environment.state, jnp.asarray(d), hide, jnp.asarray(light)))
    got = background_color(env.state, torch.from_numpy(d), hide, torch.from_numpy(light)).numpy()
    if hide:
        assert len(np.unique(want)) == 2  # the checker's two shades
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:  # the environment lookup, held as tests/test_torch_environment.py holds it
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_debug_hits_build_no_premultiplied_pyramid(monkeypatch):
    """A debug-hits frame of the default mode leaves the premultiplied
    pyramid unbuilt and runs no leg, as the JAX guard does; the next frame
    without debug hits builds it."""
    from volxel_tpu_torch.render import modes

    built = []
    real = pathtrace.with_premul_majorant
    monkeypatch.setattr(pathtrace, "with_premul_majorant", lambda *a: built.append(1) or real(*a))

    def no_leg(*args, **kwargs):
        raise AssertionError("a debug-hits frame ran a leg")

    r = TRenderer(8, 8, device="cpu")
    r.restart_from_grid(torch_construct(_volume()))
    r.settings.debug_hits = True
    with monkeypatch.context() as m:
        for name in ("dda_leg_sample", "dda_leg_shadow"):
            m.setattr(modes, name, no_leg)
        fb = r.render_frame()
    assert built == [] and bool(torch.isfinite(fb).all())
    r.settings.debug_hits = False
    r.render_frame()
    assert built == [1]
