"""The port's step statistics (utils/stepstats.py) on the CPU: the loop-cap
variance study of tests/test_stepstats.py, and the percentiles against the
JAX package's on the same scene.

The scene is tests/test_stepstats.py's heavy one: a 48^3 volume at 3x
density (the reference's stress protocol, performance.txt:1-10), 48x48
pixels. The port counts each lane's march steps or events from its legs'
budget or events left; the JAX forms count the same per-lane iterations
under a global loop cap. The two coincide while no cap binds, which the
first test pins, and there (2,304 lanes, under the 6,144 below which the
JAX default path and its pyr path coincide, ROADMAP.md §3) the percentiles,
maxima and fractions at the cap are held equal to JAX's exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu import Renderer as JRenderer
from volxel_tpu.grid import construct_brick_grid as jax_construct
from volxel_tpu.utils.fixtures import synthetic_ct_volume
from volxel_tpu.utils.stepstats import step_statistics as jax_step_statistics
from volxel_tpu_torch import Renderer
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.render import modes
from volxel_tpu_torch.render.rng import seed_rays
from volxel_tpu_torch.utils.stepstats import step_statistics

EYE = np.eye(4, dtype=np.float32)


def _dense(r, construct):
    vol = synthetic_ct_volume((48, 48, 48), bits_stored=12)
    r.restart_from_grid(construct(vol.astype(np.float32) / vol.max(), transform=EYE))
    r.camera.rotate_around_view(0.5, 0.3)
    r.camera.zoom(2.0)
    r.settings.density_multiplier = 3.0  # the reference's stress protocol (performance.txt:2)
    return r


@pytest.fixture(scope="module")
def dense_renderer():
    return _dense(Renderer(48, 48, device="cpu"), construct_brick_grid)


@pytest.mark.parametrize("mode", ["default", "no_dda"])
def test_caps_do_not_bind_on_dense_scene(dense_renderer, mode):
    stats = step_statistics(dense_renderer, mode)
    for kind in ("sample", "transmittance"):
        s = stats[kind]
        assert s["frac_at_cap"] == 0.0, f"{mode}/{kind} lanes hit the cap: {s}"
        # 25% headroom between the observed max and the cap
        assert s["max"] <= 0.75 * s["cap"], f"{mode}/{kind} too close to cap: {s}"


def test_steps_respond_to_density(dense_renderer):
    """Heavier scenes take more null-collision events."""
    heavy = step_statistics(dense_renderer, "no_dda")
    dense_renderer.settings.density_multiplier = 0.5
    try:
        lighter = step_statistics(dense_renderer, "no_dda")
    finally:
        dense_renderer.settings.density_multiplier = 3.0
    assert heavy["sample"]["p90"] > lighter["sample"]["p90"]


@pytest.mark.parametrize("mode", ["default", "no_dda"])
def test_per_lane_steps_do_not_change_images(dense_renderer, mode):
    """with_stats only appends the counts: every other output of both legs
    is bit-equal to the plain call's."""
    r = dense_renderer
    grid, params = r._device_grid, r.volume_params()
    grid = grid._replace(maj_alpha=modes.build_premul_majorant(grid.maj_mips, params, r._lut).contiguous())
    n = 64
    state = seed_rays(torch.arange(n), 0)
    origin = torch.tensor([[0.5, 0.5, -2.0]]).repeat(n, 1)
    direction = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    active = torch.ones(n, dtype=torch.bool)
    for leg in modes.get_mode_functions(mode):
        plain = leg(grid, params, r._lut, origin, direction, state, active)
        stats = leg(grid, params, r._lut, origin, direction, state, active, with_stats=True)
        assert len(stats) == len(plain) + 1 and stats[-1].shape == (n,) and bool((stats[-1] >= 0).all())
        for a, b in zip(plain, stats[:-1]):
            assert torch.equal(a, b) if a.dtype != torch.float32 else torch.equal(a.view(torch.int32),
                                                                                  b.view(torch.int32))


@pytest.mark.parametrize("mode", ["default", "no_dda", "raymarch"])
def test_percentiles_match_jax(dense_renderer, mode):
    jr = _dense(JRenderer(width=48, height=48), jax_construct)
    ours = step_statistics(dense_renderer, mode)
    assert ours == jax_step_statistics(jr, mode)
    assert ours["mode"] == mode and ours["sample"]["cap"] == {"default": 1024, "no_dda": 512, "raymarch": 64}[mode]


def test_physical_majorant_leaves_the_counts_as_jax():
    """With physical_majorant on, the default mode's pyramid is still built
    with no majorant envelope, as the JAX package's pass reads the device
    grid as it is: on the heavy scene under a transfer whose alpha falls
    past a peak (where the envelope, its prefix maximum, raises bricks'
    majorants and so the counts), the percentiles, maxima and fractions at
    the cap equal JAX's exactly, and the counts with the setting off."""
    rows = [[1.0, 1.0, 1.0, i / 127 if i < 32 else 0.02] for i in range(128)]
    r = _dense(Renderer(48, 48, device="cpu"), construct_brick_grid)
    jr = _dense(JRenderer(width=48, height=48), jax_construct)
    for x in (r, jr):
        x.set_transfer_full(rows)
    off = step_statistics(r, "default")
    r.settings.physical_majorant = jr.settings.physical_majorant = True
    ours = step_statistics(r, "default")
    assert ours == jax_step_statistics(jr, "default")
    assert ours == off
