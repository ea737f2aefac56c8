"""The importance pyramid and the display tonemap of the port.

On the CPU the dispatchers take the plain versions, held against the JAX
package's XLA forms at the tolerances tests/test_pallas_ops.py uses:
rtol 1e-6 for the pyramid (XLA takes each 2x2 mean in its own order; the
plain version sums in the CUDA kernel's order, which a numpy float32
reference pins bit for bit) and atol 1e-6 for the tonemap (pow and
division may round an ulp apart). The CUDA kernels are held against the
plain versions on the card by the tests in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu.render.pallas_ops import build_importance_pyramid_xla
from volxel_tpu.render.pathtrace import tonemap as jax_tonemap
from volxel_tpu_torch import kernels
from volxel_tpu_torch.render import pallas_ops, pathtrace
from volxel_tpu_torch.scene.environment import IMP_BASE_MIP


def _base():
    return np.random.default_rng(0).uniform(0, 5, (512, 512)).astype(np.float32)


def _framebuffer():
    return np.random.default_rng(1).uniform(0, 4, (1920 * 1080 // 64, 3)).astype(np.float32)


def test_pyramid_plain_matches_xla():
    kernels.reset_launch_counts()
    out = pallas_ops.build_importance_pyramid(torch.from_numpy(_base()))
    ref = build_importance_pyramid_xla(jnp.asarray(_base()))
    assert len(out) == IMP_BASE_MIP and tuple(out[-1].shape) == (1, 1)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert kernels.LAUNCHES["importance_pyramid"] == 0  # CPU tensors take the plain version


def _special_base():
    """The seeded base with NaN, +-inf and the largest floats at scattered
    texels, each alone in its 2x2 block (so that no sum of two of them
    decides a texel in one order and not in another) and in none of the
    blocks of the first 16 rows."""
    rng = np.random.default_rng(3)
    base = _base()
    blocks = rng.choice(np.arange(8 * 256, 256 * 256), 300, replace=False)
    special = np.array([np.nan, np.inf, -np.inf, 3.4e38, -3.4e38], dtype=np.float32)
    ys, xs = 2 * (blocks // 256) + rng.integers(0, 2, blocks.size), 2 * (blocks % 256) + rng.integers(0, 2, blocks.size)
    base[ys, xs] = special[np.arange(blocks.size) % special.size]
    return base


def test_pyramid_plain_matches_xla_on_special_values():
    """NaN and +-inf reach every level above them as in JAX, a largest float
    alone in its block gives its quarter, and the levels agree elsewhere at
    rtol 1e-6."""
    base = _special_base()
    out = pallas_ops.build_importance_pyramid(torch.from_numpy(base))
    ref = build_importance_pyramid_xla(jnp.asarray(base))
    for a, b in zip(out, ref):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
        np.testing.assert_allclose(a, b, rtol=1e-6)
    assert np.isnan(out[0].numpy()).any() and np.isinf(out[0].numpy()).any() and np.isnan(out[-1].numpy()).all()
    assert np.isfinite(out[2].numpy()[:2]).all()  # the first 16 rows of the base hold no special value


@pytest.mark.parametrize("special", [False, True])
def test_pyramid_plain_sums_in_the_kernel_order(special):
    """Every texel is ((top-left + top-right) + (bottom-left + bottom-right))
    * 0.25 of the level below, bit for bit, as numpy computes it in float32
    (the CUDA kernel's order), on the seeded base and on one with special
    values and denormals; a NaN where numpy has one (the CPU's NaN sign
    bits are its own; on the card the kernel's NaN bits are held to the
    plain version's in tests/test_torch_cuda.py)."""
    base = _special_base() if special else _base()
    if special:
        base[16:20, 16:20] = np.float32(1e-40)
    level = base
    np.seterr(invalid="ignore", over="ignore")
    for got in pallas_ops.build_importance_pyramid_plain(torch.from_numpy(base)):
        level = ((level[0::2, 0::2] + level[0::2, 1::2]) + (level[1::2, 0::2] + level[1::2, 1::2])) * np.float32(0.25)
        assert level.dtype == np.float32
        got = got.numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(level))
        np.testing.assert_array_equal(np.where(np.isnan(got), 0, got.view(np.int32)),
                                      np.where(np.isnan(level), 0, level.view(np.int32)))


def test_tonemap_plain_matches_jax():
    kernels.reset_launch_counts()
    fb = _framebuffer()
    for exposure, gamma in ((5.5, 2.2), (1.0, 1.0), (0.3, 2.6)):
        a = pallas_ops.tonemap_display(torch.from_numpy(fb), exposure, gamma).numpy()
        b = np.asarray(jax_tonemap(jnp.asarray(fb), jnp.float32(exposure), jnp.float32(gamma)))
        np.testing.assert_allclose(a, b, atol=1e-6)
        np.testing.assert_array_equal(pathtrace.tonemap(torch.from_numpy(fb), exposure, gamma).numpy(), a)
    assert kernels.LAUNCHES["tonemap"] == 0
