"""The port's tile march (render/tilemarch.py) and stochastic tricubic
filter against the JAX package's.

The JAX side runs its plain references on the CPU: serial_march_sums (the
XLA arm that tile_march_sums' hit lanes are pinned bit-equal to) and
modes.sample_volume_raymarch (which sample_volume_raymarch_tiled, the path
through the Pallas tile_march_sample, is pinned bit-equal to by
tests/test_tilemarch.py::test_raymarch_tiled_bit_identical). The port's
side is the plain PyTorch version the CPU dispatch takes. The scenes are
tests/test_tilemarch.py's, from the same seeds.

Tolerances: XLA:CPU contracts `start + i * dt`, `ipos + t * idir` and the
cubic weights' multiply-adds into FMAs and eager PyTorch does not, so a
position or weight can differ by an ulp; that flips a floor or a reservoir
compare now and then and the lane then takes another (equally valid) tap.
Hence "equal on nearly every lane", with the share stated per test; the
draw count per lane does not depend on those compares, so RNG words that
only depend on it must be equal everywhere.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from tests.torch_lanes import advance_words
from volxel_tpu.render import modes as jmodes
from volxel_tpu.render import sampling as jsampling
from volxel_tpu.render.rng import seed_rays as jax_seed_rays
from volxel_tpu.render.sampling import DeviceGrid as JGrid
from volxel_tpu.render.sampling import VolumeParams as JParams
from volxel_tpu.render.tilemarch import LANES, pack_tile_rays, serial_march_sums
from volxel_tpu_torch import kernels
from volxel_tpu_torch.render import modes as tmodes
from volxel_tpu_torch.render import sampling as tsampling
from volxel_tpu_torch.render import tilemarch as ttm
from volxel_tpu_torch.render.rng import seed_rays

EXT = 64  # (Z, Y, X) test volume, as tests/test_tilemarch.py


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _bf16(a):
    return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)


@pytest.mark.parametrize("steps", [16, 1, 7, 65])
def test_sums_match_jax_serial_march_sums(steps):
    """tests/test_tilemarch.py's `scene`: 3 x 384 coherent lanes through a
    random 64^3 field, 16 steps, and step counts that are not a multiple of
    the card kernel's chunk of loads (1, 7, 65: past 64, lanes leave the
    field). Sums equal on >= 99% of lanes; where a floor flipped, the sums
    still agree to within one tap (<= 1.0)."""
    rng = np.random.default_rng(7)
    dense = jnp.asarray(rng.random((EXT, EXT, EXT), np.float32), jnp.bfloat16)
    ntiles = 3
    origin = rng.uniform(5, 20, (ntiles, 1, 3)).astype(np.float32)
    base_dir = rng.normal(size=(ntiles, 1, 3)).astype(np.float32)
    base_dir /= np.linalg.norm(base_dir, axis=-1, keepdims=True)
    spread = rng.normal(scale=0.01, size=(ntiles, LANES, 3)).astype(np.float32)
    idir = base_dir + spread
    ipos = np.broadcast_to(origin, (ntiles, LANES, 3)).copy()
    start = rng.uniform(0, 1, (ntiles, LANES)).astype(np.float32)
    dt = np.full((ntiles, LANES), 0.9, np.float32)
    far = np.full((ntiles, LANES), 80.0, np.float32)
    valid = rng.random((ntiles, LANES)) > 0.1
    rays = pack_tile_rays(*(jnp.asarray(a) for a in (ipos, idir, start, dt, far, valid)))
    ref = np.asarray(serial_march_sums(dense, rays, jnp.asarray([EXT, EXT, EXT, 0], jnp.int32), steps=steps))
    ref = ref.reshape(-1)

    kernels.reset_launch_counts()
    n = ntiles * LANES
    ours = ttm.tile_march_sums(
        _bf16(dense), _t(ipos.reshape(n, 3)), _t(idir.reshape(n, 3)), _t(start.reshape(n)),
        _t(dt.reshape(n)), _t(far.reshape(n)), _t(valid.reshape(n)), (EXT, EXT, EXT), steps=steps,
    ).numpy()
    assert kernels.LAUNCHES["tile_march_sums"] == 0  # CPU tensors take the plain version
    same = ours == ref
    assert same.mean() >= 0.99, f"sums differ on {(~same).sum()} of {n} lanes"
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1.0)
    assert np.all(ours[~valid.reshape(n)] == 0.0)
    assert (ours > 0).mean() > 0.5  # the lanes really march through the field


@pytest.mark.parametrize("masked", [False, True])
def test_stochastic_tricubic_offsets_match_jax(masked):
    """Taps equal on >= 99.9% of 4096 lanes (an FMA-contracted weight can
    flip a reservoir compare); RNG words equal on every lane, since the nine
    draws are taken or skipped by the mask alone."""
    rng = np.random.default_rng(12)
    n = 4096
    ipos = rng.uniform(-3, 40, (n, 3)).astype(np.float32)
    mask = rng.random(n) > 0.3
    jstate = jax_seed_rays(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(9))
    state = seed_rays(torch.arange(n, dtype=torch.int64), 9)
    jm, tm = (jnp.asarray(mask), torch.from_numpy(mask)) if masked else (None, None)
    js, jtap = jsampling.stochastic_tricubic_offsets(jnp.asarray(ipos), jstate, jm)
    ts, ttap = tsampling.stochastic_tricubic_offsets(torch.from_numpy(ipos), state, tm)
    assert ttap.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    same = (ttap.numpy() == np.asarray(jtap)).all(axis=-1)
    assert same.mean() >= 0.999, f"taps differ on {(~same).sum()} of {n} lanes"
    # the pick lies in the tricubic support [floor(p - 0.5) - 1, floor(p - 0.5) + 2]
    base = np.floor(ipos - 0.5).astype(np.int32)
    assert ((ttap.numpy() >= base - 1) & (ttap.numpy() <= base + 2)).all()
    if masked:  # unmasked lanes consumed nothing
        np.testing.assert_array_equal(ts.numpy()[~mask], state.numpy()[~mask])


@pytest.fixture(scope="module")
def render_scene():
    """tests/test_tilemarch.py's `render_scene` (seed 3): 768 lanes through
    a random 64^3 field, a few wild lanes, 5% inactive."""
    rng = np.random.default_rng(3)
    dense = jnp.asarray(rng.random((EXT, EXT, EXT), np.float32) * 0.9, jnp.bfloat16)
    bdim = EXT // 8
    jgrid = JGrid(
        atlas=jnp.zeros((8, 8, 8), jnp.uint8),
        range_lo=jnp.zeros((bdim,) * 3, jnp.float32),
        range_hi=jnp.ones((bdim,) * 3, jnp.float32),
        ptr=jnp.zeros((bdim, bdim, bdim, 3), jnp.int32),
        maj_mips=jnp.ones((4, bdim, bdim, bdim), jnp.float32),
        extent=jnp.asarray([EXT, EXT, EXT], jnp.int32),
        dense=dense,
    )
    jparams = JParams(
        aabb_lo=jnp.zeros(3), aabb_hi=jnp.full((3,), float(EXT)),
        transform_inv=jnp.eye(4, dtype=jnp.float32),
        vol_min=jnp.float32(0.0), vol_maj=jnp.float32(1.2),
        inv_maj=jnp.float32(1 / 1.2), density_scale=jnp.float32(1.0),
        albedo=jnp.full((3,), 0.9), phase_g=jnp.float32(0.0),
        sample_range=jnp.asarray([0.02, 0.98], jnp.float32),
    )
    lut = rng.random((128, 4)).astype(np.float32)
    n = 2 * LANES
    origin = np.tile(np.array([[-10.0, 20.0, 25.0]], np.float32), (n, 1))
    origin[:, 1] += rng.normal(scale=1.0, size=n)
    origin[:, 2] += rng.normal(scale=1.0, size=n)
    d = np.tile(np.array([[1.0, 0.15, 0.1]], np.float32), (n, 1))
    d += rng.normal(scale=0.01, size=(n, 3)).astype(np.float32)
    d[::97] = rng.normal(size=d[::97].shape)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = rng.random(n) > 0.05
    tgrid = tsampling.DeviceGrid(dense=_bf16(dense), maj_mips=None, extent=(EXT,) * 3)
    tparams = tsampling.VolumeParams(*(_t(getattr(jparams, f), torch.float32) for f in JParams._fields))
    return dict(
        j=(jgrid, jparams, jnp.asarray(lut)), t=(tgrid, tparams, torch.from_numpy(lut)),
        origin=origin.astype(np.float32), d=d.astype(np.float32), active=active, n=n,
    )


def test_raymarch_sample_matches_jax(render_scene):
    """Port sample_volume_raymarch (the plain tile_march_sample on the CPU)
    against JAX modes.sample_volume_raymarch: state, hit and rgb equal on
    >= 99.5% of lanes, the rest being lanes forked by an FMA-rounded
    position or weight. t is the step's min(start + i * dt, far), which
    XLA:CPU rounds once as an FMA and PyTorch twice: on the unforked lanes
    it agrees to rtol 1e-6 (measured: an ulp apart on 15 of 768 lanes)."""
    s = render_scene
    n = s["n"]
    jstate = jax_seed_rays(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(5))
    j = jmodes.sample_volume_raymarch(*s["j"], jnp.asarray(s["origin"]), jnp.asarray(s["d"]), jstate,
                                      jnp.asarray(s["active"]))
    kernels.reset_launch_counts()
    t = tmodes.sample_volume_raymarch(*s["t"], torch.from_numpy(s["origin"]), torch.from_numpy(s["d"]),
                                      seed_rays(torch.arange(n, dtype=torch.int64), 5),
                                      torch.from_numpy(s["active"]))
    assert kernels.LAUNCHES["tile_march_sample"] == 0
    j_state, j_hit, j_t, j_rgb = (np.asarray(a) for a in j[:4])
    t_state, t_hit, t_t, t_rgb = (a.numpy() for a in t[:4])
    same = (t_state == j_state.astype(np.int64)).all(axis=-1) & (t_hit == j_hit) & (t_rgb == j_rgb).all(axis=-1)
    assert same.mean() >= 0.995, f"{(~same).sum()} of {n} lanes differ"
    np.testing.assert_allclose(t_t[same], j_t[same], rtol=1e-6, atol=0)
    assert t_hit.mean() > 0.2 and (~t_hit & s["active"]).any()  # both outcomes are exercised
    assert not t_hit[~s["active"]].any()
    np.testing.assert_array_equal(t_rgb[~t_hit], 1.0)
    assert (t[4].numpy() == 0).all()


def test_transmittance_plain_matches_jax(render_scene):
    """tile_march_transmittance_plain after the port's box test and start
    jitter, Tr = exp(-tau), against JAX modes.transmittance_raymarch: every
    lane inside the box draws at all 64 steps whatever its taps, so the RNG
    words are equal on every lane; Tr to
    rtol 1e-5 on >= 99% of lanes (an FMA-rounded position or weight forks a
    tap now and then) and 1 outside the box."""
    s = render_scene
    n = s["n"]
    jstate, jtr = jmodes.transmittance_raymarch(*s["j"], jnp.asarray(s["origin"]), jnp.asarray(s["d"]),
                                                jax_seed_rays(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(6)),
                                                jnp.asarray(s["active"]))
    grid, params, lut = s["t"]
    ipos, idir, near, far, dt, valid = tmodes._raymarch_setup(params, torch.from_numpy(s["origin"]),
                                                              torch.from_numpy(s["d"]), torch.from_numpy(s["active"]))
    state, xi = tmodes.rng_where(valid, seed_rays(torch.arange(n, dtype=torch.int64), 6))
    kernels.reset_launch_counts()
    out, tau = ttm.tile_march_transmittance_plain(grid.dense, ipos, idir, near + xi * dt, dt, far, valid, state, lut,
                                                  ttm.volume_scalars(params), (EXT, EXT, EXT))
    assert kernels.LAUNCHES["tile_march_transmittance"] == 0
    np.testing.assert_array_equal(out.numpy(), np.asarray(jstate).astype(np.int64))
    assert torch.equal(out[~valid], state[~valid])
    tr = torch.exp(-tau).numpy()
    close = np.isclose(tr, np.asarray(jtr), rtol=1e-5, atol=0)
    assert close.mean() >= 0.99, f"Tr differs on {(~close).sum()} of {n} lanes"
    assert (tr[~valid.numpy()] == 1.0).all() and (tau[~valid] == 0).all()
    assert 0.05 < (tr < 0.999).mean() and valid.float().mean() > 0.5


@pytest.mark.parametrize("target", ["drawn", "zero", "inf"])
def test_raymarch_camera_leg_draws_nine_a_step(render_scene, target):
    """The camera leg's speculative designs (PERF.md section 6:
    later steps' draws and taps issued before a step's hit test, each slot
    keeping the words before its draws) rest on the plain leg's draw law,
    and so does the words' check of its issue-only twins. Every lane's words
    after the plain camera leg are its prologue's words advanced by 9 x the
    steps it took (none outside the box); a lane that hit took the steps up
    to the first with tau >= its target (at t = min(start + (taken - 1) *
    dt, far)), one that did not took all 64. With the drawn targets lanes
    hit at many steps and some never; a target of 0 hits at step 0, +inf
    never."""
    s = render_scene
    n = s["n"]
    args = list(tmodes.raymarch_prologue(*s["t"], torch.from_numpy(s["origin"]), torch.from_numpy(s["d"]),
                                         seed_rays(torch.arange(n, dtype=torch.int64), 5),
                                         torch.from_numpy(s["active"])))
    if target != "drawn":
        args[7] = torch.full_like(args[7], 0.0 if target == "zero" else float("inf"))
    _, _, _, start, dt, far, valid, _, state, _, _, _ = args
    out, hit, t, _, _, taken = ttm.tile_march_plain(*args)
    assert torch.equal(out, advance_words(state, 9 * taken))
    assert torch.equal(taken[~valid], torch.zeros_like(taken[~valid])) and not hit[~valid].any()
    assert (taken[valid & ~hit] == ttm.STEPS).all()
    at = taken[hit] - 1
    assert torch.equal(t[hit], torch.minimum(start[hit] + at.to(torch.float32) * dt[hit], far[hit]))
    if target == "drawn":
        assert hit.sum() > 50 and (valid & ~hit).any() and len(set(at.tolist())) > 10
    else:
        assert torch.equal(hit, valid) if target == "zero" else not hit.any()
