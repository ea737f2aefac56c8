"""What the default legs' kernels (csrc/dda_leg.cu) rest on when they issue
majorant fetches ahead of the march, held on the plain legs
(render/ddaleg.py, render/pyrmarch.py) on the CPU.

The kernels keep the majorant fetches of a lane's next steps in flight
while they test the current one, and at a collision issue the next
segment's first fetches before its decode resolves. That is right only if

  * up to a lane's first collision, where the march goes (each step's t,
    mip, budget and fetch address) does not depend on the majorants it
    reads: only the collision test reads them;
  * after a collision the lane's next segment starts at the collision's t
    and max(mip - 2, 0), whatever the draws decide, unless the lane ends:
    after a null collision in the camera leg, and after a real or a null
    one in the shadow leg that roulette does not kill.

Both are held here at 16^3 to 64^3 volumes (tests/torch_lanes.py's
pyramid_lanes: a synthetic CT volume's field and stacked majorant pyramid),
bit for bit. The kernels themselves are held to the plain legs on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from tests.torch_lanes import LEG_ARGS, leg_call, pyramid_lanes
from volxel_tpu_torch.render import ddaleg, sampling
from volxel_tpu_torch.render.pyrmarch import KIND_COLL, pyr_march_plain

SIDES = [16, 40, 64]


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _visits(lanes, maj_alpha, cap):
    """One call of the plain march over `lanes` with the pyramid
    `maj_alpha`: each lane's steps (up to its first collision, exit or
    budget) and, per step of the lockstep loop, every lane's point and
    traced mip and the flat index of the majorant it fetches."""
    seen = []
    original = sampling.lookup_majorant_premul

    def lookup(grid, ipos, mip):
        bxc, byc, bzc = sampling._majorant_coords(grid, ipos)
        _, bz, by, bx = grid.maj_alpha.shape
        seen.append((ipos.clone(), mip.clone(), ((mip.to(torch.int64) * bz + bzc) * by + byc) * bx + bxc))
        return original(grid, ipos, mip)

    budget = torch.full(lanes["t"].shape, cap, dtype=torch.int32)
    sampling.lookup_majorant_premul = lookup
    try:
        out = pyr_march_plain(maj_alpha, lanes["extent"], lanes["ipos"], lanes["idir"], lanes["ri"], lanes["t"],
                              lanes["tau"], lanes["mip"], lanes["far"], budget, lanes["running"], cap)
    finally:
        sampling.lookup_majorant_premul = original
    return budget - out[-1], out[4], seen


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("other", ["scaled", "zero"])
def test_march_goes_where_it_goes_whatever_the_majorants(side, other):
    """Up to each lane's first collision the plain march visits the same
    points, traced mips and fetch addresses (so the same t, mip and budget
    at each step) with the volume's pyramid as with the same pyramid times
    0.37, or all zero (where nothing collides and each lane marches on to
    its exit or budget): the steps ahead of a collision are known before
    any of their majorants arrive, and a collision only cuts the sequence
    short."""
    lanes = pyramid_lanes(side, scale=0.1)
    cap = ddaleg.DDA_TRANSMITTANCE_MAX_STEPS
    alt = lanes["maj_alpha"] * 0.37 if other == "scaled" else torch.zeros_like(lanes["maj_alpha"])
    steps, kind, seen = _visits(lanes, lanes["maj_alpha"], cap)
    steps_alt, kind_alt, seen_alt = _visits(lanes, alt, cap)
    common = torch.minimum(steps, steps_alt)
    for k in range(int(common.max())):
        on = k < common
        for a, b in zip(seen[k], seen_alt[k]):
            assert torch.equal(_bits(a)[on], _bits(b)[on]), f"step {k}"
    run = lanes["running"]
    collided = run & (kind == KIND_COLL)
    assert collided.sum() > 100 and (steps[collided] > 1).sum() > 50
    if other == "zero":
        assert not (kind_alt == KIND_COLL).any()
        assert (steps_alt[collided] >= steps[collided]).all()
    else:
        assert (steps != steps_alt)[run].sum() > 20


def _rounds(leg, lanes):
    """The plain leg ("sample", "shadow" with the reference's quirk or
    "physical") over `lanes`, and per round the march's inputs and outputs
    (t, mip and who runs) and the collision round's Tr before and after."""
    rounds = []
    kind = "sample" if leg == "sample" else "shadow"
    march, collide = ddaleg.pyr_march_plain, getattr(ddaleg, f"dda_collide_{kind}_plain")

    def marching(maj_alpha, extent, ipos, idir, ri, t, tau, mip, far, budget, running, cap):
        out = march(maj_alpha, extent, ipos, idir, ri, t, tau, mip, far, budget, running, cap)
        rounds.append({"t_in": t.clone(), "mip_in": mip.clone(), "running": running.clone(), "t": out[0].clone(),
                       "mip": out[2].clone(), "collided": running & (out[4] == KIND_COLL)})
        return out

    def colliding(*args):  # the collision round updates its operands in place; Tr is args[13]
        tr = args[13].clone()
        collide(*args)
        rounds[-1]["tr_in"], rounds[-1]["tr"] = tr, args[13].clone()

    ddaleg.pyr_march_plain = marching
    setattr(ddaleg, f"dda_collide_{kind}_plain", colliding)
    try:
        fn = ddaleg.dda_leg_sample_plain if leg == "sample" else ddaleg.dda_leg_shadow_plain
        fn(*leg_call(lanes, leg))
    finally:
        ddaleg.pyr_march_plain = march
        setattr(ddaleg, f"dda_collide_{kind}_plain", collide)
    return rounds


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("leg", ["sample", "shadow", "physical"])
def test_next_segment_starts_at_the_collision(side, leg):
    """Every lane that marches on after a collision starts its next segment
    at the collision's t and max(mip - 2, 0), bit for bit: after a null
    collision in the camera leg (a real one ends the lane), after a real or
    a null one in the shadow leg (with physical shadows a real one keeps
    Tr > 0; the quirk's ratio 1 - vol_maj / maj is 0 under a premultiplied
    majorant, so there roulette ends the lane); so the kernels can issue
    that segment's first fetches before the decode resolves. The pyramid is
    scaled 3x, so that majorants exceed the decoded densities."""
    lanes = pyramid_lanes(side, n=2048, seed=90 + side, scale=3.0)
    rounds = _rounds(leg, lanes)
    assert len(rounds) > 3
    went_on = after_real = 0
    for before, after in zip(rounds, rounds[1:]):
        on = before["collided"] & after["running"]
        went_on += int(on.sum())
        assert torch.equal(_bits(after["t_in"])[on], _bits(before["t"])[on])
        assert torch.equal(_bits(after["mip_in"])[on], _bits(torch.clamp_min(before["mip"] - 2.0, 0.0))[on])
        after_real += int((on & (before["tr"] != before["tr_in"])).sum())
    assert went_on > 200
    if leg == "physical":
        assert after_real > 50


@pytest.mark.parametrize("side", SIDES)
def test_pyramid_lanes_reach_the_march(side):
    """tests/torch_lanes.py's pyramid_lanes give both legs work at each
    size: lanes that collide, lanes that leave the box and, in the camera
    leg, hits."""
    lanes = pyramid_lanes(side, scale=0.1)
    assert tuple(LEG_ARGS) == ("dense", "maj_alpha", "extent", "scalars", "lut", "ipos", "idir", "ri", "far", "t",
                               "tau", "mip", "state", "running")
    _, hit, _, _, budget = ddaleg.dda_leg_sample_plain(*leg_call(lanes, "sample"))
    run = lanes["running"]
    assert hit.sum() > 50 and (run & ~hit).sum() > 50
    assert (budget[run] < ddaleg.DDA_SAMPLE_MAX_STEPS - 2).sum() > 100
