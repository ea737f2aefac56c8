"""The port's ray utilities against the JAX package's.

Tolerance rtol 1e-6 / atol 1e-6: the port writes the small matrix products
out elementwise where XLA uses a dot, and XLA:CPU may contract multiply-adds
into FMAs, so results can differ by an ulp or two.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu.render import rays as jrays
from volxel_tpu.scene.camera import Camera
from volxel_tpu_torch.render import rays as trays

TOL = dict(rtol=1e-6, atol=1e-6)
RNG = np.random.default_rng(5)


def _unit(n):
    v = RNG.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_camera_rays_match():
    cam = Camera(1.0)
    cam.rotate_around_view(0.6, 0.4)
    cam.zoom(2.0)
    inv_view = np.linalg.inv(cam.view_matrix()).astype(np.float32)
    inv_proj = np.linalg.inv(cam.proj_matrix(16 / 9)).astype(np.float32)
    ndc = RNG.random((4096, 2), dtype=np.float32)
    j = jrays.camera_rays(jnp.asarray(inv_view), jnp.asarray(inv_proj), jnp.asarray(ndc))
    t = trays.camera_rays(torch.from_numpy(inv_view), torch.from_numpy(inv_proj), torch.from_numpy(ndc))
    np.testing.assert_allclose(t.origin.numpy(), np.asarray(j.origin), **TOL)
    np.testing.assert_allclose(t.direction.numpy(), np.asarray(j.direction), **TOL)
    jit = RNG.random((12 * 8, 2), dtype=np.float32)
    np.testing.assert_allclose(trays.pixel_ndc(12, 8, torch.from_numpy(jit)).numpy(),
                               np.asarray(jrays.pixel_ndc(12, 8, jnp.asarray(jit))), **TOL)


def test_ray_box_matches():
    o = RNG.uniform(-2, 2, (4096, 3)).astype(np.float32)
    d = _unit(4096)
    lo, hi = np.array([-0.5, -0.4, -0.3], np.float32), np.array([0.5, 0.4, 0.3], np.float32)
    jh, jn, jf = jrays.ray_box_intersection(jrays.Rays(jnp.asarray(o), jnp.asarray(d)), jnp.asarray(lo), jnp.asarray(hi))
    th, tn, tf = trays.ray_box_intersection(
        trays.Rays(torch.from_numpy(o), torch.from_numpy(d)), torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    hit = np.asarray(jh)
    np.testing.assert_allclose(tn.numpy()[hit], np.asarray(jn)[hit], **TOL)
    np.testing.assert_allclose(tf.numpy()[hit], np.asarray(jf)[hit], **TOL)


@pytest.mark.parametrize("g", [0.0, 0.3, -0.6])
def test_henyey_greenstein_matches(g):
    cos_t = RNG.uniform(-1, 1, 4096).astype(np.float32)
    gj, gt = jnp.float32(g), torch.tensor(g, dtype=torch.float32)
    np.testing.assert_allclose(trays.phase_henyey_greenstein(torch.from_numpy(cos_t), gt).numpy(),
                               np.asarray(jrays.phase_henyey_greenstein(jnp.asarray(cos_t), gj)), **TOL)
    d = _unit(4096)
    xi = RNG.random((4096, 2), dtype=np.float32)
    j = jrays.sample_phase_henyey_greenstein(jnp.asarray(d), gj, jnp.asarray(xi))
    t = trays.sample_phase_henyey_greenstein(torch.from_numpy(d), gt, torch.from_numpy(xi))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_shading_helpers_match():
    rgb = RNG.uniform(0, 3, (4096, 3)).astype(np.float32)
    np.testing.assert_allclose(trays.luma(torch.from_numpy(rgb)).numpy(), np.asarray(jrays.luma(jnp.asarray(rgb))), **TOL)
    a, b = RNG.random(4096, dtype=np.float32), RNG.random(4096, dtype=np.float32)
    np.testing.assert_allclose(trays.power_heuristic(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jrays.power_heuristic(jnp.asarray(a), jnp.asarray(b))), **TOL)
    x = np.array([1.0, np.nan, np.inf, -np.inf, -2.0], np.float32)
    np.testing.assert_array_equal(trays.sanitize(torch.from_numpy(x)).numpy(), np.asarray(jrays.sanitize(jnp.asarray(x))))
    n, v = _unit(4096), _unit(4096)
    np.testing.assert_allclose(trays.align_to(torch.from_numpy(n), torch.from_numpy(v)).numpy(),
                               np.asarray(jrays.align_to(jnp.asarray(n), jnp.asarray(v))), **TOL)
