"""The port's DDA march against the JAX package's Pallas march.

The JAX side is volxel_tpu.render.pyrmarch.pyr_march in interpret mode
(its CPU form), on the byte-plane packing of the same premultiplied
pyramid; the port's side is its plain PyTorch march (render.pyrmarch),
which the plain default legs run in rounds. Both get identical f32 lanes
of the 32^3 scene: camera rays at their first march and at random
mid-march states.

Tolerance: XLA:CPU contracts `tau - maj * dt` into a fused multiply-add and
eager PyTorch does not, so the two can disagree where tau_new lands within
an ulp of 0 and the collision test flips. Hence `kind` and `budget` must
agree on >= 99.9% of lanes; on lanes whose `kind` agrees, `mip` must be
exact, `t` within rtol 1e-5 and `tau` within atol 1e-5.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu import Renderer as JRenderer
from volxel_tpu.grid import construct_brick_grid
from volxel_tpu.render import modes as jmodes
from volxel_tpu.render import rays as jrays
from volxel_tpu.render.pyrmarch import pyr_march as jax_pyr_march
from volxel_tpu.render.sampling import pack_premul_pyramid
from volxel_tpu.utils.fixtures import synthetic_ct_volume
from volxel_tpu_torch import kernels
from volxel_tpu_torch.render import pyrmarch as tpyr

FIXTURE = Path(__file__).parent / "fixtures" / "reference_benchmark.json"
SIDE = 64  # 4096 lanes
CAP = 1024


@pytest.fixture(scope="module")
def lanes():
    vol = synthetic_ct_volume((32, 32, 32), bits_stored=12)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    r = JRenderer(width=SIDE, height=SIDE)
    r.restart_from_grid(grid)
    r.restore_settings(json.loads(FIXTURE.read_text())["sharedSettings"][0])
    r.settings.resolution_factor = 1.0
    params = r.volume_params()
    dgrid = r._device_grid
    maj_alpha = jmodes.build_premul_majorant(dgrid.maj_mips, params, r._lut)

    inv_view = jnp.asarray(np.linalg.inv(r.camera.view_matrix()).astype(np.float32))
    inv_proj = jnp.asarray(np.linalg.inv(r.camera.proj_matrix(1.0)).astype(np.float32))
    rng = np.random.default_rng(2)
    ndc = jrays.pixel_ndc(SIDE, SIDE, jnp.asarray(rng.random((SIDE * SIDE, 2), dtype=np.float32)))
    rays = jrays.camera_rays(inv_view, inv_proj, ndc)
    hit, near, far = jrays.ray_box_intersection(rays, params.aabb_lo, params.aabb_hi)
    ipos, idir = jmodes._to_index_space(params, rays.origin, rays.direction)
    ipos, idir = np.array(ipos), np.array(idir)
    near, far, hit = np.asarray(near), np.asarray(far), np.asarray(hit)

    n = SIDE * SIDE
    mid = rng.random(n) < 0.5  # half the lanes start mid-march
    t = np.where(mid, near + rng.random(n, dtype=np.float32) * (far - near), near + np.float32(1e-6))
    mip = np.where(mid, rng.integers(0, 13, n) * 0.25, 3.0)
    tau = -np.log1p(-rng.random(n, dtype=np.float32))
    return dict(
        maj_alpha=np.array(maj_alpha), extent=tuple(int(v) for v in np.asarray(dgrid.extent)),
        ipos=ipos, idir=idir, ri=(np.float32(1.0) / idir).astype(np.float32),
        t=t.astype(np.float32), tau=tau.astype(np.float32), mip=mip.astype(np.float32),
        far=far.astype(np.float32), running=hit & (t < far),
    )


@pytest.mark.parametrize("budget", [CAP, 3])
def test_plain_march_matches_jax_pallas_march(lanes, budget):
    n = lanes["t"].shape[0]
    jb = np.full(n, budget, np.float32)
    j = jax_pyr_march(
        pack_premul_pyramid(jnp.asarray(lanes["maj_alpha"]), "int8"), lanes["maj_alpha"].shape,
        jnp.asarray(np.array(lanes["extent"], np.int32)),
        *(jnp.asarray(lanes[k]) for k in ("ipos", "idir", "ri", "t", "tau", "mip", "far")),
        jnp.asarray(jb), jnp.asarray(lanes["running"]), CAP, interpret=True,
    )
    j_t, j_tau, j_mip, j_maj, j_kind, j_budget = (np.asarray(a) for a in j)

    kernels.reset_launch_counts()
    out = tpyr.pyr_march_plain(
        torch.from_numpy(lanes["maj_alpha"]), lanes["extent"],
        *(torch.from_numpy(lanes[k]) for k in ("ipos", "idir", "ri", "t", "tau", "mip", "far")),
        torch.full((n,), budget, dtype=torch.int32), torch.from_numpy(lanes["running"]), CAP,
    )
    assert not any(kernels.LAUNCHES.values())  # the plain march launches nothing
    t_t, t_tau, t_mip, t_maj, t_kind, t_budget = (a.numpy() for a in out)

    running = lanes["running"]
    assert running.sum() > n // 4
    same = t_kind == j_kind.astype(np.int32)
    assert same.mean() >= 0.999, f"kind differs on {(~same).sum()} of {n} lanes"
    assert (t_budget == j_budget.astype(np.int32)).mean() >= 0.999
    np.testing.assert_array_equal(t_mip[same], j_mip[same])
    np.testing.assert_allclose(t_t[same], j_t[same], rtol=1e-5)
    np.testing.assert_allclose(t_tau[same], j_tau[same], rtol=0, atol=1e-5)
    coll = same & (t_kind == tpyr.KIND_COLL)
    np.testing.assert_allclose(t_maj[coll], j_maj[coll], rtol=1e-6)
    # the budget binds: with 3 steps some lanes stop short of a collision
    if budget == 3:
        assert ((t_kind == tpyr.KIND_DONE) & (t_budget == 0)).sum() > 0
    # every running lane ends parked, done or out of budget — none idle
    assert (t_kind[running] != tpyr.KIND_IDLE).all()
