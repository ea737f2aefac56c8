"""The port's default-mode legs (render/ddaleg.py) and its DDA collision
step (render/collide.py).

Legs: the port's sample_volume_dda and transmittance_dda (the reference
quirk and physical=True), each its setup and then the plain leg (rounds of
pyr_march_plain and one collision round) on the CPU, against
volxel_tpu.render.modes' on tests/test_torch_modes.py's scene:
4096 lanes, below the 6144 at which the JAX default path and its pyr path
part. The JAX side reads its majorant inline and the port the premultiplied
pyramid, which the JAX package pins bit-identical
(tests/test_render.py::test_premul_majorant_bit_identity).

Tolerances are tests/test_torch_modes.py's: XLA:CPU contracts
multiply-adds (the march's tau - maj * dt among them) and rounds log an ulp
apart from ATen, so a lane can fork onto another valid realization; hence
equality of state and outcome on >= 99% of lanes, and t or Tr to rtol 1e-5
on the lanes whose draws agree.

The collision step itself: the plain round on constructed lanes
(tests/torch_lanes.py), against what its contract says of each lane; and
the whole plain legs on constructed lanes: step budgets spent, russian
roulette kills, densities the sample range rejects, NaN and far-off lanes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from tests.test_torch_modes import N, make_scene
from tests.torch_lanes import VOL_MAJ, collide_lanes, leg_args, leg_call, leg_lanes
from volxel_tpu.render import modes as jmodes
from volxel_tpu_torch import kernels
from volxel_tpu_torch.render import collide, ddaleg
from volxel_tpu_torch.render import modes as tmodes
from volxel_tpu_torch.render.pyrmarch import KIND_COLL, KIND_DONE
from volxel_tpu_torch.render.rng import next_u32


@pytest.fixture(scope="module")
def scene():
    s = make_scene()
    tgrid, tparams, tlut = s["t"]
    premul = tmodes.build_premul_majorant(tgrid.maj_mips, tparams, tlut)
    s["t"] = (tgrid._replace(maj_alpha=premul.contiguous()), tparams, tlut)
    return s


def _both(scene, jfn, tfn):
    kernels.reset_launch_counts()
    j = jfn(*scene["j"], *scene["jrays"])
    t = tfn(*scene["t"], *scene["trays"])
    assert not any(kernels.LAUNCHES.values())  # CPU tensors take the plain versions
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


def test_sample_volume_dda_matches_jax(scene):
    """DDA distance sampling: state, hit and rgb equal on >= 99% of lanes,
    t to rtol 1e-5 on those that hit."""
    (js, jh, jt, jrgb, jle), (ts, th, tt, trgb, tle) = _both(scene, jmodes.sample_volume_dda, tmodes.sample_volume_dda)
    same = (ts == js.astype(np.int64)).all(axis=-1) & (th == jh) & (trgb == jrgb).all(axis=-1)
    assert same.mean() >= 0.99, f"{(~same).sum()} of {N} lanes differ"
    np.testing.assert_allclose(tt[same & th], jt[same & th], rtol=1e-5)
    assert 0.1 < th.mean() < 0.9 and not th[~scene["active"]].any()
    assert (tle == 0).all()


@pytest.mark.parametrize("physical", [False, True])
def test_transmittance_dda_matches_jax(scene, physical):
    """Ratio tracking along the DDA: state equal and Tr to rtol 1e-5 on >=
    99% of lanes; 1 where the lane is inactive; russian roulette kills
    lanes (0)."""
    (js, jtr), (ts, ttr) = _both(
        scene,
        lambda *a: jmodes.transmittance_dda(*a, physical=physical),
        lambda *a: tmodes.transmittance_dda(*a, physical=physical),
    )
    same = (ts == js.astype(np.int64)).all(axis=-1) & np.isclose(ttr, jtr, rtol=1e-5, atol=0)
    assert same.mean() >= 0.99, f"{(~same).sum()} of {N} lanes differ"
    assert (ttr[~scene["active"]] == 1.0).all()
    assert 0.05 < (ttr[scene["active"]] == 0).mean() < 0.95


def _words_after(state, draws):
    for _ in range(draws):
        state, _ = next_u32(state)
    return state


@pytest.mark.parametrize("leg", ["sample", "shadow"])
def test_collision_step_leaves_other_lanes_and_ends_done_ones(leg):
    """Every output is updated in place; a lane that is not both running and
    parked keeps every word and value, except that a running lane whose
    march is done stops."""
    lanes = collide_lanes("cpu", edge_cases=True)
    args = leg_args(lanes, leg)
    fn = collide.dda_collide_sample_plain if leg == "sample" else collide.dda_collide_shadow_plain
    out = fn(*args)
    assert all(o is a for o, a in zip(out, args[9:]))
    parked = lanes["running"] & (lanes["kind"] == KIND_COLL)
    done = lanes["running"] & (lanes["kind"] == KIND_DONE)
    names = ("state", "tau", "mip", "running") + (("hit", "rgb") if leg == "sample" else ("tr",))
    for name, after in zip(names, out):
        keep = ~parked
        if name == "running":
            assert not after[done].any()
            keep = keep & ~done
        a, b = after[keep], lanes[name][keep]
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b), name


@pytest.mark.parametrize("leg", ["sample", "shadow"])
def test_rejected_density_is_a_null_collision(leg):
    """With a sample range above every density, each parked lane takes the
    null branch: no hit and Tr unchanged, two draws (the real/null test and
    the tau redraw), tau = -log(1 - second draw), the mip two levels down
    (at least 0), still running."""
    lanes = collide_lanes("cpu", sample_range=(2.0, 3.0), alpha=1.0)
    args = leg_args(lanes, leg)
    fn = collide.dda_collide_sample_plain if leg == "sample" else collide.dda_collide_shadow_plain
    out = fn(*args)
    parked = lanes["running"] & (lanes["kind"] == KIND_COLL)
    state, tau, mip, running = out[:4]
    assert parked.sum() > 1000
    np.testing.assert_array_equal(state[parked], _words_after(lanes["state"][parked], 2))
    _, second = next_u32(_words_after(lanes["state"][parked], 1))
    xi2 = (second >> 8).to(torch.float32) * (1.0 / 16777216.0)
    assert torch.equal(tau[parked], -torch.log(1.0 - xi2))
    assert torch.equal(mip[parked], torch.clamp_min(lanes["mip"][parked] - 2.0, 0.0))
    assert running[parked].all()
    if leg == "sample":
        assert not out[4].any() and (out[5] == 1).all()
    else:
        assert torch.equal(out[4], lanes["tr"])


def test_real_collision_hits_with_the_lut_colour():
    """An opaque LUT at maj = vol_maj makes every parked lane's collision
    real (xi * maj < vol_maj): the lane hits with its LUT row's colour,
    stops, and consumes one draw; tau and mip stay."""
    lanes = collide_lanes("cpu", alpha=1.0, sample_range=(0.0, 10.0), maj=VOL_MAJ)
    state, tau, mip, running, hit, rgb = collide.dda_collide_sample_plain(*leg_args(lanes, "sample"))
    parked = lanes["running"] & (lanes["kind"] == KIND_COLL)
    assert torch.equal(hit, parked)
    assert not running[parked].any()
    np.testing.assert_array_equal(state[parked], _words_after(lanes["state"][parked], 1))
    assert torch.equal(tau, lanes["tau"]) and torch.equal(mip, lanes["mip"])
    assert set(rgb[parked].unique().tolist()) <= set(lanes["lut"][:, :3].reshape(-1).tolist())


def test_russian_roulette_kill_stops_the_lane():
    """In the shadow leg under the reference quirk, maj = vol_maj gives a
    ratio of 0 at every real collision: Tr drops below 0.1, russian
    roulette draws and kills (xi < 1 - 0), Tr = 0 and the lane stops after
    two draws (real/null, roulette); its tau is -log(1 - the next draw),
    which stays unconsumed."""
    lanes = collide_lanes("cpu", alpha=1.0, sample_range=(0.0, 10.0), maj=VOL_MAJ)
    state, tau, mip, running, tr = collide.dda_collide_shadow_plain(*leg_args(lanes, "shadow"))
    parked = lanes["running"] & (lanes["kind"] == KIND_COLL)
    assert (tr[parked] == 0).all() and not running[parked].any()
    after = _words_after(lanes["state"][parked], 2)
    np.testing.assert_array_equal(state[parked], after)
    _, nxt = next_u32(after)
    assert torch.equal(tau[parked], -torch.log(1.0 - (nxt >> 8).to(torch.float32) * (1.0 / 16777216.0)))
    assert torch.equal(tr[~parked], lanes["tr"][~parked])


def test_exhausted_budget_ends_the_lane():
    """A running lane that the march returns done (its step budget spent,
    or it left the box) stops at the next collision round, with no draw."""
    lanes = collide_lanes("cpu")
    lanes["kind"][:] = KIND_DONE
    for leg, fn in (("sample", collide.dda_collide_sample_plain), ("shadow", collide.dda_collide_shadow_plain)):
        args = leg_args(lanes, leg)
        out = fn(*args)
        assert not out[3].any()
        assert torch.equal(out[0], lanes["state"])


def _draws(before, after, most):
    """Per lane, how many xoshiro draws lead from the words `before` to
    `after` (-1 if more than `most`)."""
    count = torch.full((before.shape[0],), -1, dtype=torch.int64)
    for k in range(most + 1):
        count = torch.where((count < 0) & (before == after).all(dim=-1), k, count)
        before, _ = next_u32(before)
    return count


def _leg(leg):
    return ddaleg.dda_leg_sample if leg == "sample" else ddaleg.dda_leg_shadow


@pytest.mark.parametrize("leg", ["sample", "shadow"])
def test_leg_spends_its_budget_where_nothing_collides(leg):
    """With every majorant 0 tau never runs out, and a box exit 1e6 voxels
    on lies past any budget: each running lane spends its whole budget and
    draws nothing, a lane that does not run keeps it; no hit, rgb 1 and t
    moved on (sample), Tr unchanged (shadow). No launch on the CPU."""
    lanes = leg_lanes("cpu", maj=0.0, far=1e6)
    kernels.reset_launch_counts()
    out = _leg(leg)(*leg_call(lanes, leg))
    assert not any(kernels.LAUNCHES.values())
    run, cap = lanes["running"], ddaleg.DDA_SAMPLE_MAX_STEPS if leg == "sample" else ddaleg.DDA_TRANSMITTANCE_MAX_STEPS
    assert (out[-1][run] == 0).all() and (out[-1][~run] == cap).all()
    assert torch.equal(out[0], lanes["state"])
    if leg == "sample":
        _, hit, t, rgb, _ = out
        assert not hit.any() and (rgb == 1).all()
        assert (t[run] > lanes["t"][run] + 1000).all() and torch.equal(t[~run], lanes["t"][~run])
    else:
        assert torch.equal(out[1], lanes["tr"])


def test_russian_roulette_kill_ends_the_shadow_leg():
    """Under the reference quirk, majorants of vol_maj everywhere and an
    opaque LUT make a lane's first collision real with a ratio of 0, and
    russian roulette then always kills: a running lane either escapes
    before any collision (no draw, Tr kept) or ends at its first one with
    Tr = 0 after two draws (real/null, roulette)."""
    lanes = leg_lanes("cpu", alpha=1.0, sample_range=(0.0, 10.0), maj=VOL_MAJ)
    state, tr, _ = ddaleg.dda_leg_shadow(*leg_call(lanes, "shadow"))
    run = lanes["running"]
    draws = _draws(lanes["state"], state, 2)
    killed = run & (draws == 2)
    escaped = run & (draws == 0)
    assert torch.equal(killed | escaped, run) and killed.sum() > 100 and escaped.any()
    assert (tr[killed] == 0).all() and torch.equal(tr[~killed], lanes["tr"][~killed])


@pytest.mark.parametrize("leg", ["sample", "shadow"])
def test_rejected_density_never_ends_a_leg(leg):
    """With a sample range above every density each collision is null: two
    draws (the real/null test and the tau redraw) and the lane marches on,
    so every running lane draws an even number of times, some of them at
    several collisions; no hit (sample), Tr unchanged (shadow)."""
    lanes = leg_lanes("cpu", sample_range=(2.0, 3.0), alpha=1.0)
    out = _leg(leg)(*leg_call(lanes, leg))
    run = lanes["running"]
    draws = _draws(lanes["state"], out[0], 400)
    assert (draws[run] >= 0).all() and (draws[run] % 2 == 0).all() and (draws[~run] == 0).all()
    assert (draws >= 6).sum() > 100
    if leg == "sample":
        assert not out[1].any() and (out[3] == 1).all()
    else:
        assert torch.equal(out[1], lanes["tr"])


@pytest.mark.parametrize("leg", ["sample", "shadow", "physical"])
def test_nan_and_far_off_lanes_through_the_leg(leg):
    """Lanes with a NaN or infinite position or start never collide: they
    spend their budget and draw nothing (no hit, t NaN; Tr kept). Lanes 2e12
    voxels out, on lattice points, at degenerate majorants and Tr at the
    roulette threshold end within their budget. The inputs are left as they
    are."""
    lanes = leg_lanes("cpu", edge_cases=True)
    before = {k: v.clone() for k, v in lanes.items() if isinstance(v, torch.Tensor)}
    out = _leg(leg)(*leg_call(lanes, leg))
    for k, v in before.items():
        assert torch.equal(v.view(torch.int32) if v.is_floating_point() else v,
                           lanes[k].view(torch.int32) if v.is_floating_point() else lanes[k]), k
    nan = slice(0, 4)
    assert (out[-1][nan] == 0).all() and torch.equal(out[0][nan], lanes["state"][nan])
    assert ((out[-1] >= 0) & (out[-1] <= ddaleg.DDA_SAMPLE_MAX_STEPS)).all()
    if leg == "sample":
        assert not out[1][nan].any() and out[2][nan].isnan().all()
    else:
        assert torch.equal(out[1][nan], lanes["tr"][nan])
        assert not torch.equal(out[0][4:16], lanes["state"][4:16])
