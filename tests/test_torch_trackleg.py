"""The port's no_dda legs (render/trackleg.py): delta and ratio tracking.

Against the JAX package: the port's setup (modes._tracking_setup) and then
the plain leg, against volxel_tpu.render.modes.sample_volume_simple and
transmittance_simple on tests/test_torch_modes.py's scene and at that
file's tolerances (XLA:CPU contracts t - log(1 - xi) * inv_maj into an FMA
and rounds log an ulp apart from ATen, so a lane can fork onto another
valid realization: state and outcome equal on >= 99% of lanes, t or Tr to
rtol 1e-5 where the draws agree). Then with an alpha of 0 everywhere and a
majorant 5,000 times the box's diagonal, where nothing collides and
almost every lane spends all TRACKING_MAX_EVENTS events: the JAX loop,
which counts one global event counter, stops those lanes where the port's
per-lane count does.

On their own, bit for bit: the kernels (csrc/track_leg.cu) track each lane
alone until it ends, so a lane's outputs must not depend on the other
lanes of the call. Each plain leg is run on a scene's lanes and on
constructed lanes (tests/torch_lanes.py), then on a permutation and on a
subset of them, and every lane's outputs must stay the same bits.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from tests.test_torch_modes import N, make_scene
from tests.torch_lanes import advance_words, select_lanes, shadow_leg_draws, track_call, track_lanes
from volxel_tpu.render import modes as jmodes
from volxel_tpu_torch import kernels
from volxel_tpu_torch.render import modes as tmodes
from volxel_tpu_torch.render import trackleg
from volxel_tpu_torch.render.rng import next_u32
from volxel_tpu_torch.render.tilemarch import volume_scalars


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _port_leg(leg, grid, params, lut, origin, direction, state, active):
    """The port's setup, then the plain leg directly: the leg's outputs and
    the events each lane has left."""
    state, ipos, idir, far, t, running = tmodes._tracking_setup(params, origin, direction, state, active)
    args = (grid.dense, grid.extent, volume_scalars(params), lut, ipos, idir, far, t, state, running)
    if leg == "sample":
        return trackleg.track_leg_sample_plain(*args)
    return trackleg.track_leg_shadow_plain(*args, torch.ones_like(t))


def _jax_leg(leg, *args):
    fn = jmodes.sample_volume_simple if leg == "sample" else jmodes.transmittance_simple
    return [np.asarray(a) for a in fn(*args)]


def test_plain_sample_leg_matches_jax(scene):
    """Delta tracking: state, hit and rgb equal on >= 99% of lanes, t to
    rtol 1e-5 on those that hit; every running lane spends 1 to 512
    events."""
    js, jh, jt, jrgb, _ = _jax_leg("sample", *scene["j"], *scene["jrays"])
    kernels.reset_launch_counts()
    ts, th, tt, trgb, events = (a.numpy() for a in _port_leg("sample", *scene["t"], *scene["trays"]))
    assert not any(kernels.LAUNCHES.values())
    same = (ts == js.astype(np.int64)).all(axis=-1) & (th == jh) & np.isclose(trgb, jrgb, rtol=1e-6, atol=0).all(-1)
    assert same.mean() >= 0.99, f"{(~same).sum()} of {N} lanes differ"
    np.testing.assert_allclose(tt[same & th], jt[same & th], rtol=1e-5)
    assert 0.1 < th.mean() < 0.9 and not th[~scene["active"]].any()
    assert (events[~scene["active"]] == trackleg.TRACKING_MAX_EVENTS).all()
    assert (events[th] < trackleg.TRACKING_MAX_EVENTS).all() and (events >= 0).all()


def test_plain_shadow_leg_matches_jax(scene):
    """Ratio tracking: state equal and Tr to rtol 1e-5 on >= 99% of lanes;
    1 where the lane is inactive; russian roulette kills lanes."""
    js, jtr = _jax_leg("shadow", *scene["j"], *scene["jrays"])
    ts, ttr, events = (a.numpy() for a in _port_leg("shadow", *scene["t"], *scene["trays"]))
    same = (ts == js.astype(np.int64)).all(axis=-1) & np.isclose(ttr, jtr, rtol=1e-5, atol=0)
    assert same.mean() >= 0.99, f"{(~same).sum()} of {N} lanes differ"
    assert (ttr[~scene["active"]] == 1.0).all()
    assert 0.05 < (ttr[scene["active"]] == 0).mean() < 0.95
    assert (events[ttr == 0] < trackleg.TRACKING_MAX_EVENTS).all()


@pytest.mark.parametrize("leg", ["sample", "shadow"])
def test_event_cap_stops_lanes_as_the_jax_loop(scene, leg):
    """With alpha 0 in every LUT row nothing collides, tr stays 1 and no
    lane is killed; with free flights of 1/5000 of the box's diagonal on
    average a lane crosses the box in far more than 512 events. The port's
    lanes that spend all TRACKING_MAX_EVENTS end with 0 events left after
    512 free-flight draws (and as many real/null draws in the camera leg),
    and the JAX loop's global counter stops the same lanes with the same
    words, t to rtol 1e-5."""
    jgrid, jparams, jlut = scene["j"]
    tgrid, tparams, tlut = scene["t"]
    assert getattr(jgrid, "lut_mxu", None) is None
    diagonal = float(np.linalg.norm(np.asarray(jparams.aabb_hi) - np.asarray(jparams.aabb_lo)))
    vol_maj = np.float32(5000.0 / diagonal)
    inv_maj = np.float32(1.0) / vol_maj
    jout = _jax_leg(leg, jgrid, jparams._replace(vol_maj=jnp.float32(vol_maj), inv_maj=jnp.float32(inv_maj)),
                    jlut.at[:, 3].set(0.0), *scene["jrays"])
    lut = tlut.clone()
    lut[:, 3] = 0.0
    params = tparams._replace(vol_maj=torch.tensor(vol_maj), inv_maj=torch.tensor(inv_maj))
    tout = [a.numpy() for a in _port_leg(leg, tgrid, params, lut, *scene["trays"])]
    events = tout[-1]
    capped = events == 0
    inside = scene["active"] & (events < trackleg.TRACKING_MAX_EVENTS)
    assert capped[inside].mean() > 0.9 and not capped[~inside].any()
    words = scene["trays"][2][torch.from_numpy(capped)]
    draws = 2 * trackleg.TRACKING_MAX_EVENTS if leg == "sample" else trackleg.TRACKING_MAX_EVENTS
    for _ in range(draws + 1):  # the setup's first free flight, then the leg's
        words, _ = next_u32(words)
    np.testing.assert_array_equal(tout[0][capped], words.numpy())
    np.testing.assert_array_equal(tout[0][capped], jout[0][capped].astype(np.int64))
    if leg == "sample":
        assert not tout[1].any() and not jout[1].any()
        np.testing.assert_allclose(tout[2][capped], jout[2][capped], rtol=1e-5)
    else:
        assert (tout[1] == 1.0).all() and (jout[1] == 1.0).all()


def _scene_track_args(scene):
    """track_leg_sample's operands for the scene's lanes after the port's
    setup, with the shadow leg's tr (seeded in (0, 1))."""
    tgrid, tparams, tlut = scene["t"]
    state, ipos, idir, far, t, running = tmodes._tracking_setup(tparams, *scene["trays"])
    tr = torch.from_numpy(np.random.default_rng(6).uniform(0.0, 1.0, N).astype(np.float32))
    return dict(dense=tgrid.dense, extent=tgrid.extent, scalars=volume_scalars(tparams), lut=tlut, ipos=ipos,
                idir=idir, far=far, t=t, state=state, running=running, tr=tr)


def _lanes(which, scene):
    if which == "scene":
        return _scene_track_args(scene)
    return track_lanes("cpu", **({"edge_cases": True} if which == "edge" else {}))


def _bits(a):
    return a.view(torch.int32) if a.is_floating_point() else a


@pytest.mark.parametrize("leg", ["sample", "shadow"])
@pytest.mark.parametrize("which", ["scene", "random", "edge"])
def test_lanes_are_independent(scene, leg, which):
    """Every lane's outputs, events left included, are the same bits when
    the lanes are permuted and when only every third lane is tracked; the
    inputs are left as they are."""
    lanes = _lanes(which, scene)
    before = {k: v.clone() for k, v in lanes.items() if isinstance(v, torch.Tensor)}
    fn = trackleg.track_leg_sample if leg == "sample" else trackleg.track_leg_shadow
    whole = fn(*track_call(lanes, leg))
    n = lanes["t"].shape[0]
    perm = torch.from_numpy(np.random.default_rng(3).permutation(n))
    for idx in (perm, torch.arange(0, n, 3)):
        part = fn(*track_call(select_lanes(lanes, idx), leg))
        for a, b in zip(part, whole):
            assert torch.equal(_bits(a), _bits(b[idx]))
    for k, v in before.items():
        assert torch.equal(_bits(v), _bits(lanes[k])), k
    run = lanes["running"]
    assert (whole[-1][~run] == trackleg.TRACKING_MAX_EVENTS).all() and torch.equal(whole[0][~run], lanes["state"][~run])
    assert (whole[-1][run] < trackleg.TRACKING_MAX_EVENTS).all()


@pytest.mark.parametrize("leg", ["sample", "shadow"])
def test_constructed_lane_spends_all_events(leg):
    """With alpha 0 in every LUT row and a box exit 1e30 away, every running
    lane spends all 512 events and ends with 0 left, after 1024 draws in
    the camera leg (real/null and free flight) and 512 in the shadow leg
    where its tr stays at or above 0.1 (no roulette)."""
    lanes = track_lanes("cpu", alpha=0.0, far=1e30)
    fn = trackleg.track_leg_sample if leg == "sample" else trackleg.track_leg_shadow
    out = fn(*track_call(lanes, leg))
    run = lanes["running"]
    keep = run if leg == "sample" else run & (lanes["tr"] >= 0.1)
    events = out[-1]
    assert (events[keep] == 0).all() and (events[~run] == trackleg.TRACKING_MAX_EVENTS).all()
    draws = 2 * trackleg.TRACKING_MAX_EVENTS if leg == "sample" else trackleg.TRACKING_MAX_EVENTS
    words = lanes["state"][keep]
    for _ in range(draws):
        words, _ = next_u32(words)
    assert keep.sum() > 500 and torch.equal(out[0][keep], words)
    if leg == "sample":
        assert not out[1].any() and (out[2][run] > lanes["t"][run] + 100).all()
    else:
        assert torch.equal(out[1][keep], lanes["tr"][keep])


def test_rejected_and_edge_lanes_through_the_legs():
    """A sample range above every density makes every event null: no hit,
    Tr kept where no roulette draws, and the lanes fly on over several
    events. A lane that starts at or past its exit, or whose t or exit is
    NaN, takes exactly one event."""
    lanes = track_lanes("cpu", sample_range=(2.0, 3.0), alpha=1.0)
    _, hit, _, rgb, events = trackleg.track_leg_sample(*track_call(lanes, "sample"))
    _, tr, _ = trackleg.track_leg_shadow(*track_call(lanes, "shadow"))
    run = lanes["running"]
    kept = run & (lanes["tr"] >= 0.1)
    assert not hit.any() and (rgb == 1).all() and torch.equal(tr[kept], lanes["tr"][kept])
    assert ((trackleg.TRACKING_MAX_EVENTS - events[run]) > 3).sum() > 100
    started_past = run & (lanes["t"] >= lanes["far"])
    assert started_past.any() and (events[started_past] == trackleg.TRACKING_MAX_EVENTS - 1).all()
    edge = track_lanes("cpu", edge_cases=True)
    for leg in ("sample", "shadow"):
        fn = trackleg.track_leg_sample if leg == "sample" else trackleg.track_leg_shadow
        events = fn(*track_call(edge, leg))[-1]
        one = torch.tensor([3, 4, 12, 13])  # t NaN, exit NaN, starting at the exit
        assert (events[one] == trackleg.TRACKING_MAX_EVENTS - 1).all()


@pytest.mark.parametrize("which", ["random", "edge"])
def test_camera_leg_draws_two_a_null_event_and_one_a_hit(which):
    """The camera leg's kernels issue an event's taps before the previous
    event is decoded: a null event takes exactly two draws (real/null, free
    flight) and a hit ends the lane after one, so the next event's t is a
    function of the words and t alone. In the plain leg every lane's words
    after the leg are its input words advanced by exactly 2 * events taken
    - hit draws (none where the lane does not run)."""
    lanes = track_lanes("cpu", **({"edge_cases": True} if which == "edge" else {}))
    state, hit, _, _, events = trackleg.track_leg_sample_plain(*track_call(lanes, "sample"))
    taken = torch.where(lanes["running"], trackleg.TRACKING_MAX_EVENTS - events, 0).to(torch.int64)
    assert hit.any() and (taken > 1).any() and not hit[~lanes["running"]].any()
    assert torch.equal(state, advance_words(lanes["state"], 2 * taken - hit.to(torch.int64)))


@pytest.mark.parametrize("which", ["random", "edge"])
def test_shadow_leg_draws_one_an_event_and_one_a_roulette(which):
    """The plain shadow leg's draw law: an event makes one roulette draw
    where tr < 0.1 and then, unless that draw killed the lane, one free
    flight. So every lane's words advance by events taken + roulette draws
    (counted at the events where tr < 0.1) - 1 if the roulette killed the
    lane (no free flight after it); lanes that survive a roulette draw
    exist, and a killed lane ends with tr = 0."""
    lanes = track_lanes("cpu", **({"edge_cases": True} if which == "edge" else {}))
    (state, tr, events), roulette, killed = shadow_leg_draws(track_call(lanes, "shadow"))
    run = lanes["running"]
    taken = torch.where(run, trackleg.TRACKING_MAX_EVENTS - events, 0).to(torch.int64)
    assert (roulette > killed.to(torch.int64)).sum() > 10 and killed.sum() > 10
    assert not (roulette[~run].any() or killed[~run].any()) and (tr[killed] == 0).all()
    assert torch.equal(state, advance_words(lanes["state"], taken + roulette - killed.to(torch.int64)))


def test_field_end_lanes_tap_the_last_column_and_element():
    """tests/torch_lanes.py's field_end_lanes (the card tests' paired-load
    edge) reach what they are built for: at the first event some running
    lanes' cells start on the last x column (the x + 1 tap outside, ex ==
    nx), some on the column before it, some on the field's final element;
    and both plain legs run over them with every lane's events and words
    accounted for."""
    from tests.torch_lanes import FIELD_END_SHAPE, field_end_lanes

    lanes = field_end_lanes("cpu")
    nz, ny, nx = FIELD_END_SHAPE
    run = lanes["running"]
    pos = lanes["ipos"] + lanes["t"][:, None] * lanes["idir"]
    base = torch.floor(pos - 0.5).to(torch.int64)[run]
    assert (base[:, 0] == nx - 1).sum() > 50 and (base[:, 0] == nx - 2).sum() > 50
    assert ((base == torch.tensor([nx - 1, ny - 1, nz - 1])).all(dim=1)).sum() > 5
    state, hit, _, _, events = trackleg.track_leg_sample_plain(*track_call(lanes, "sample"))
    taken = torch.where(run, trackleg.TRACKING_MAX_EVENTS - events, 0).to(torch.int64)
    assert hit.any() and (~hit & run).any()
    assert torch.equal(state, advance_words(lanes["state"], 2 * taken - hit.to(torch.int64)))
