"""The importance pyramid and the display tonemap of the port.

On the CPU the dispatchers take the plain versions, held against the JAX
package's XLA forms at the tolerances tests/test_pallas_ops.py uses:
rtol 1e-6 for the pyramid (a 4-term mean summed in another order) and
atol 1e-6 for the tonemap (pow and division may round an ulp apart). The
CUDA kernels are held against the plain versions on the card by the tests
in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
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


def test_tonemap_plain_matches_jax():
    kernels.reset_launch_counts()
    fb = _framebuffer()
    for exposure, gamma in ((5.5, 2.2), (1.0, 1.0), (0.3, 2.6)):
        a = pallas_ops.tonemap_display(torch.from_numpy(fb), exposure, gamma).numpy()
        b = np.asarray(jax_tonemap(jnp.asarray(fb), jnp.float32(exposure), jnp.float32(gamma)))
        np.testing.assert_allclose(a, b, atol=1e-6)
        np.testing.assert_array_equal(pathtrace.tonemap(torch.from_numpy(fb), exposure, gamma).numpy(), a)
    assert kernels.LAUNCHES["tonemap"] == 0
