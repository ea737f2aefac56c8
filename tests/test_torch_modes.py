"""The port's no_dda legs and raymarch shadow leg against the JAX package's.

Both sides get the same scene state (the JAX renderer's grid, params and
LUT for the 32^3 synthetic CT volume under the reference's settings export,
carried into the port by api.convert.from_jax_state) and the same seeded
rays: 4096 lanes from outside the box towards random points inside it,
10% of them inactive, RNG states seeded by pixel index as the renderer
seeds them.

Tolerances: XLA:CPU contracts multiply-adds into FMAs and rounds log and
exp an ulp apart from ATen, so a free-flight distance or a raymarch
position can differ by an ulp and, rarely, flip a compare; that lane then
follows another valid realization. Hence equality on nearly every lane
(shares stated per test), and transmittances to rtol 1e-5 on the lanes
whose draws agree.
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
from volxel_tpu.grid import construct_brick_grid
from volxel_tpu.render import modes as jmodes
from volxel_tpu.render.rng import seed_rays as jax_seed_rays
from volxel_tpu.utils.fixtures import synthetic_ct_volume
from volxel_tpu_torch.api.convert import from_jax_state
from volxel_tpu_torch.render import modes as tmodes
from volxel_tpu_torch.render.rng import seed_rays

FIXTURE = Path(__file__).parent / "fixtures" / "reference_benchmark.json"
N = 4096


def make_scene():
    """The JAX renderer's state for the 32^3 scene, carried into the port,
    and the seeded lanes for both."""
    vol = synthetic_ct_volume((32, 32, 32), bits_stored=12)
    r = JRenderer(width=16, height=16)
    r.restart_from_grid(construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32)))
    r.restore_settings(json.loads(FIXTURE.read_text())["sharedSettings"][0])
    jgrid, jparams, jlut = r._device_grid, r.volume_params(), r._lut
    tgrid, tparams, tlut, _ = from_jax_state(
        *jax.tree_util.tree_map(np.asarray, (jgrid, jparams, jlut, r.environment.state)), device="cpu"
    )
    lo, hi = np.asarray(jparams.aabb_lo), np.asarray(jparams.aabb_hi)
    rng = np.random.default_rng(21)
    centre, size = (lo + hi) / 2, hi - lo
    origin = (centre + rng.normal(size=(N, 3)) * size).astype(np.float32)
    target = (lo + rng.random((N, 3)) * size).astype(np.float32)
    d = target - origin
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    active = rng.random(N) > 0.1
    return dict(
        j=(jgrid, jparams, jlut), t=(tgrid, tparams, tlut),
        jrays=(jnp.asarray(origin), jnp.asarray(d), jax_seed_rays(jnp.arange(N, dtype=jnp.uint32), jnp.uint32(3)),
               jnp.asarray(active)),
        trays=(torch.from_numpy(origin), torch.from_numpy(d), seed_rays(torch.arange(N, dtype=torch.int64), 3),
               torch.from_numpy(active)),
        active=active,
    )


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _both(scene, jfn, tfn):
    j = jfn(*scene["j"], *scene["jrays"])
    t = tfn(*scene["t"], *scene["trays"])
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


def test_transmittance_raymarch_matches_jax(scene):
    """All 64 steps draw on every lane inside the box, whatever the taps,
    so the RNG words are equal on every lane; Tr to rtol 1e-5 on >= 99% of
    lanes (a forked tap moves tau) and 1 where the lane is inactive."""
    (js, jtr), (ts, ttr) = _both(scene, jmodes.transmittance_raymarch, tmodes.transmittance_raymarch)
    np.testing.assert_array_equal(ts, js.astype(np.int64))
    close = np.isclose(ttr, jtr, rtol=1e-5, atol=0)
    assert close.mean() >= 0.99, f"Tr differs on {(~close).sum()} of {N} lanes"
    assert (ttr[~scene["active"]] == 1.0).all()
    assert 0.05 < (ttr < 0.999).mean() and (ttr > 0).any()  # the rays do cross density


def test_sample_volume_simple_matches_jax(scene):
    """Delta tracking: state, hit and rgb equal on >= 99% of lanes, t to
    rtol 1e-5 there."""
    (js, jh, jt, jrgb, jle), (ts, th, tt, trgb, tle) = _both(
        scene, jmodes.sample_volume_simple, tmodes.sample_volume_simple
    )
    same = (ts == js.astype(np.int64)).all(axis=-1) & (th == jh) & np.isclose(trgb, jrgb, rtol=1e-6, atol=0).all(-1)
    assert same.mean() >= 0.99, f"{(~same).sum()} of {N} lanes differ"
    np.testing.assert_allclose(tt[same & th], jt[same & th], rtol=1e-5)
    assert 0.1 < th.mean() < 0.9 and not th[~scene["active"]].any()
    assert (tle == 0).all()


def test_transmittance_simple_matches_jax(scene):
    """Ratio tracking: state equal and Tr to rtol 1e-5 on >= 99% of lanes."""
    (js, jtr), (ts, ttr) = _both(scene, jmodes.transmittance_simple, tmodes.transmittance_simple)
    same = (ts == js.astype(np.int64)).all(axis=-1) & np.isclose(ttr, jtr, rtol=1e-5, atol=0)
    assert same.mean() >= 0.99, f"{(~same).sum()} of {N} lanes differ"
    assert (ttr[~scene["active"]] == 1.0).all()
    # russian roulette kills lanes (0) and renormalizes its survivors (1)
    assert 0.05 < (ttr[scene["active"]] == 0).mean() < 0.95
