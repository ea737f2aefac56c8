"""The no_dda mode's two legs, each one hand-written CUDA kernel on the card
beside its plain PyTorch version.

Counterpart of the event loops of volxel_tpu.render.modes.sample_volume_simple
and transmittance_simple after their setup (normal.glsl:8-55): tracking
against the global majorant, where every event decodes the density at the
lane's point (trilinear, then the transfer LUT) and draws.

  track_leg_sample: delta tracking, the camera leg. A real collision ends
    the lane (hit, the LUT colour); a null one draws the next free flight.
  track_leg_shadow: ratio tracking, the shadow leg. tr *= 1 - d / majorant
    at every event; russian roulette under 0.1 ends a lane with tr = 0
    before its free-flight draw.

A lane also ends when its free flight reaches `far`, or after
TRACKING_MAX_EVENTS events. The plain versions are the event loop over the
lanes still running (one host sync an event, to find them). The kernels
(csrc/track_leg.cu) are one thread per lane, in pixel order, that tracks
until its lane ends: one launch per leg and no host sync.

What bounds the kernels on an H100 is each lane's chain of events and the
instructions an event issues, not bytes and not, once the taps are issued
early enough, their latency (PERF.md section 6). So the design
spends few instructions an event and keeps taps in flight:

  * the cell of the eight taps is located with 32-bit casts that reject
    exactly the taps the plain version's 64-bit casts reject, and indexed
    from one 64-bit index of its first corner; each tap is one 2-byte load
    predicated on the tap being inside;
  * the camera leg keeps the taps of the next two events in flight while
    it decodes the current one: a null event takes exactly two draws and a
    real one ends the lane, so where the next event lies depends only on
    the lane's words and t, and a second copy of the words runs ahead to
    find it;
  * the shadow leg fetches each event's taps as it takes it: speculating
    past a roulette draw, and refilling the lanes of a persistent grid from
    a device counter, were measured slower (PERF.md section 6).

Why the two agree: the JAX loop caps all lanes with one global counter
(it < TRACKING_MAX_EVENTS), but every lane enters at event 0 and a lane
that stops never runs again, so at global event k every running lane has
had exactly k events and a per-lane cap is the same cap. Each lane's
words, t and tr are its own, so a lane that tracks alone until it ends
computes, bit for bit, what the loop computes for it, whichever thread
tracks it and whenever its taps are loaded
(tests/test_torch_trackleg.py holds the plain legs to that on the CPU,
with the draw counts the camera leg's look-ahead rests on, and
tests/test_torch_cuda.py the kernels to the plain legs on the card). Both
return each lane's events left of TRACKING_MAX_EVENTS beside the leg's
outputs.

Park forms (a vz row across nodes, parallel.migrate): over a SlabGrid
whose slabs on other nodes are absent, track_leg_*_park take each lane's
events left, and a lane parks at the first event whose taps lie in an
absent slab, before its decode and draws: it stops with its t, words,
events (and tr) as they are, which is all a lane's state, so the same
park form resumes it where the slab is readable. `park` names the slab
(-1 for a lane that ended). The camera kernel issues each event's taps
ahead, so its park test goes where an event is issued, and the lane
parks when it reaches that event. They count as track_leg_*_slabs_park.
"""

from __future__ import annotations

import torch

from volxel_tpu_torch import kernels
from volxel_tpu_torch.render.ddaleg import check_field, check_lanes
from volxel_tpu_torch.render.gather import lookup_transfer_plain
from volxel_tpu_torch.render.rng import rng, rng_where
from volxel_tpu_torch.render.sampling import SlabGrid, field_grid, parked_owner, trilinear_sum
from volxel_tpu_torch.render.tilemarch import (
    S_DEN_SCALE,
    S_INV_MAJ,
    S_RANGE_HI,
    S_RANGE_LO,
    S_VOL_MAJ,
    _check_lanes,
    slab_form,
)

TRACKING_MAX_EVENTS = 512  # no_dda events per leg, the JAX package's cap


def _decode(dense, extent, scalars, lut, ipos, idir, t):
    """The density at ipos + t * idir, normalised by the majorant, then the
    LUT's NEAREST row with range rejection (normal.glsl:10, :41)."""
    density = scalars[S_DEN_SCALE] * trilinear_sum(field_grid(dense, extent), ipos + t[:, None] * idir)
    return lookup_transfer_plain(lut, scalars[S_RANGE_LO:S_RANGE_HI + 1], density * scalars[S_INV_MAJ])


def track_leg_sample_plain(dense, extent, scalars, lut, ipos, idir, far, t, state, running):
    """Plain PyTorch camera leg, event by event over the running lanes; see
    `track_leg_sample`."""
    inv_maj, vol_maj = scalars[S_INV_MAJ], scalars[S_VOL_MAJ]
    n = t.shape[0]
    state, t = state.clone(), t.clone()
    hit = torch.zeros_like(running)
    rgb = torch.ones((n, 3), dtype=torch.float32, device=t.device)
    events = torch.full((n,), TRACKING_MAX_EVENTS, dtype=torch.int32, device=t.device)
    lanes = torch.nonzero(running).squeeze(1)
    for _ in range(TRACKING_MAX_EVENTS):
        if not lanes.numel():
            break
        t_l = t[lanes]
        rgba = _decode(dense, extent, scalars, lut, ipos[lanes], idir[lanes], t_l)
        p_real = vol_maj * rgba[:, 3] * inv_maj
        st, xi1 = rng(state[lanes])
        real = xi1 < p_real
        st, xi2 = rng_where(~real, st)
        t_l = torch.where(real, t_l, t_l - torch.log(1.0 - xi2) * inv_maj)
        state[lanes] = st
        t[lanes] = t_l
        events[lanes] -= 1
        rgb[lanes[real]] = rgba[real, :3]
        hit[lanes[real]] = True
        lanes = lanes[~real & (t_l < far[lanes])]
    return state, hit, t, rgb, events


def track_leg_shadow_plain(dense, extent, scalars, lut, ipos, idir, far, t, state, running, tr):
    """Plain PyTorch shadow leg, event by event over the running lanes; see
    `track_leg_shadow`."""
    inv_maj, vol_maj = scalars[S_INV_MAJ], scalars[S_VOL_MAJ]
    state, t, tr = state.clone(), t.clone(), tr.clone()
    events = torch.full(t.shape, TRACKING_MAX_EVENTS, dtype=torch.int32, device=t.device)
    lanes = torch.nonzero(running).squeeze(1)
    for _ in range(TRACKING_MAX_EVENTS):
        if not lanes.numel():
            break
        t_l = t[lanes]
        rgba = _decode(dense, extent, scalars, lut, ipos[lanes], idir[lanes], t_l)
        d = vol_maj * rgba[:, 3]
        tr_l = tr[lanes] * (1.0 - d * inv_maj)
        rr_active = tr_l < 0.1
        st, xi_rr = rng_where(rr_active, state[lanes])
        killed = rr_active & (xi_rr < (1.0 - tr_l))
        tr_l = torch.where(rr_active & ~killed, tr_l / torch.clamp_min(tr_l, 1e-20), tr_l)
        tr[lanes] = torch.where(killed, 0.0, tr_l)
        st, xi2 = rng_where(~killed, st)
        t_l = t_l - torch.log(1.0 - xi2) * inv_maj
        state[lanes] = st
        t[lanes] = t_l
        events[lanes] -= 1
        lanes = lanes[~killed & (t_l < far[lanes])]
    return state, tr, events


def _park_here(grid, ipos, idir, t, lanes, park):
    """The lanes of `lanes` whose next event reads an absent slab park:
    `park` names it; returns the others."""
    owner = parked_owner(grid, ipos[lanes, 2] + t[lanes] * idir[lanes, 2])
    held = owner >= 0
    park[lanes[held]] = owner[held]
    return lanes[~held]


def track_leg_sample_park_plain(grid, extent, scalars, lut, ipos, idir, far, t, events, state, running):
    """Plain PyTorch camera leg's park form, event by event over the
    running lanes; see `track_leg_sample_park`."""
    inv_maj, vol_maj = scalars[S_INV_MAJ], scalars[S_VOL_MAJ]
    n = t.shape[0]
    state, t, events = state.clone(), t.clone(), events.clone()
    hit = torch.zeros_like(running)
    rgb = torch.ones((n, 3), dtype=torch.float32, device=t.device)
    park = torch.full((n,), -1, dtype=torch.int64, device=t.device)
    lanes = torch.nonzero(running).squeeze(1)
    while lanes.numel():
        lanes = _park_here(grid, ipos, idir, t, lanes, park)
        t_l = t[lanes]
        rgba = _decode(grid, extent, scalars, lut, ipos[lanes], idir[lanes], t_l)
        p_real = vol_maj * rgba[:, 3] * inv_maj
        st, xi1 = rng(state[lanes])
        real = xi1 < p_real
        st, xi2 = rng_where(~real, st)
        t_l = torch.where(real, t_l, t_l - torch.log(1.0 - xi2) * inv_maj)
        state[lanes] = st
        t[lanes] = t_l
        events[lanes] -= 1
        rgb[lanes[real]] = rgba[real, :3]
        hit[lanes[real]] = True
        lanes = lanes[~real & (t_l < far[lanes]) & (events[lanes] > 0)]
    return state, hit, t, rgb, events, park.to(torch.int32)


def track_leg_shadow_park_plain(grid, extent, scalars, lut, ipos, idir, far, t, events, state, running, tr):
    """Plain PyTorch shadow leg's park form, event by event over the
    running lanes; see `track_leg_shadow_park`."""
    inv_maj, vol_maj = scalars[S_INV_MAJ], scalars[S_VOL_MAJ]
    t_in, state, t, tr, events = t, state.clone(), t.clone(), tr.clone(), events.clone()
    park = torch.full(t.shape, -1, dtype=torch.int64, device=t.device)
    lanes = torch.nonzero(running).squeeze(1)
    while lanes.numel():
        lanes = _park_here(grid, ipos, idir, t, lanes, park)
        t_l = t[lanes]
        rgba = _decode(grid, extent, scalars, lut, ipos[lanes], idir[lanes], t_l)
        d = vol_maj * rgba[:, 3]
        tr_l = tr[lanes] * (1.0 - d * inv_maj)
        rr_active = tr_l < 0.1
        st, xi_rr = rng_where(rr_active, state[lanes])
        killed = rr_active & (xi_rr < (1.0 - tr_l))
        tr_l = torch.where(rr_active & ~killed, tr_l / torch.clamp_min(tr_l, 1e-20), tr_l)
        tr[lanes] = torch.where(killed, 0.0, tr_l)
        st, xi2 = rng_where(~killed, st)
        t_l = t_l - torch.log(1.0 - xi2) * inv_maj
        state[lanes] = st
        t[lanes] = t_l
        events[lanes] -= 1
        lanes = lanes[~killed & (t_l < far[lanes]) & (events[lanes] > 0)]
    return state, tr, events, torch.where(park >= 0, t, t_in), park.to(torch.int32)


# K - 1 must be exact in f32 for the kernels' LUT row (floor(clamp(y, 0, K - 1)))
LUT_ROWS_LIMIT = 2**24


def _field_and_lanes(name, dense, extent, scalars, lut, ipos, idir, far, t, state, running, per_lane=()):
    """Check a leg's operands and return the C entry point's arguments up
    to `running`."""
    field, _ = check_field(name, dense, extent, scalars, lut, t.device)
    if lut.shape[0] > LUT_ROWS_LIMIT:
        raise ValueError(f"{name}: the kernel takes at most {LUT_ROWS_LIMIT} LUT rows, got {lut.shape[0]}")
    check_lanes(name, t.device, [("ipos", ipos), ("idir", idir)], [("far", far), ("t", t), *per_lane], state,
                running)
    return (*field, *(a.data_ptr() for a in (ipos, idir, far, t, state, running)))


def track_leg_sample_cuda(dense, extent, scalars, lut, ipos, idir, far, t, state, running):
    """The camera leg as one launch of csrc/track_leg.cu; see
    `track_leg_sample`."""
    args = _field_and_lanes("track_leg_sample", dense, extent, scalars, lut, ipos, idir, far, t, state, running)
    n = t.shape[0]
    state_o, hit, t_o = torch.empty_like(state), torch.empty_like(running), torch.empty_like(t)
    rgb, events = torch.empty((n, 3), dtype=torch.float32, device=t.device), torch.empty_like(t, dtype=torch.int32)
    name = slab_form("track_leg_sample", dense)
    kernels.launch(f"vx_{name}", t, *args, TRACKING_MAX_EVENTS,
                   *(a.data_ptr() for a in (state_o, hit, t_o, rgb, events)), n, counter=name)
    return state_o, hit, t_o, rgb, events


def track_leg_shadow_cuda(dense, extent, scalars, lut, ipos, idir, far, t, state, running, tr):
    """The shadow leg as one launch of csrc/track_leg.cu; see
    `track_leg_shadow`."""
    args = _field_and_lanes("track_leg_shadow", dense, extent, scalars, lut, ipos, idir, far, t, state, running,
                            (("tr", tr),))
    state_o, tr_o, events = torch.empty_like(state), torch.empty_like(tr), torch.empty_like(t, dtype=torch.int32)
    name = slab_form("track_leg_shadow", dense)
    kernels.launch(f"vx_{name}", t, *args, tr.data_ptr(), TRACKING_MAX_EVENTS,
                   *(a.data_ptr() for a in (state_o, tr_o, events)), t.shape[0], counter=name)
    return state_o, tr_o, events


def _check_park(name, grid, t, events):
    if not isinstance(grid, SlabGrid):
        raise ValueError(f"{name}: the park forms read a SlabGrid")
    kernels.require_cuda(name, events, dtype=torch.int32, device=t.device)
    _check_lanes(name, t.shape[0], (), [("events", events)])


def track_leg_sample_park_cuda(grid, extent, scalars, lut, ipos, idir, far, t, events, state, running):
    """The camera leg's park form as one launch of csrc/track_leg.cu; see
    `track_leg_sample_park`."""
    _check_park("track_leg_sample_park", grid, t, events)
    args = _field_and_lanes("track_leg_sample_park", grid, extent, scalars, lut, ipos, idir, far, t, state, running)
    n = t.shape[0]
    state_o, hit, t_o, rgb = torch.empty_like(state), torch.empty_like(running), torch.empty_like(t), torch.empty_like(ipos)
    events_o, park = torch.empty_like(events), torch.empty_like(events)
    kernels.launch("vx_track_leg_sample_slabs_park", t, *args, events.data_ptr(),
                   *(a.data_ptr() for a in (state_o, hit, t_o, rgb, events_o, park)), n,
                   counter="track_leg_sample_slabs_park")
    return state_o, hit, t_o, rgb, events_o, park


def track_leg_shadow_park_cuda(grid, extent, scalars, lut, ipos, idir, far, t, events, state, running, tr):
    """The shadow leg's park form as one launch of csrc/track_leg.cu; see
    `track_leg_shadow_park`."""
    _check_park("track_leg_shadow_park", grid, t, events)
    args = _field_and_lanes("track_leg_shadow_park", grid, extent, scalars, lut, ipos, idir, far, t, state, running,
                            (("tr", tr),))
    state_o, tr_o, t_o = torch.empty_like(state), torch.empty_like(tr), torch.empty_like(t)
    events_o, park = torch.empty_like(events), torch.empty_like(events)
    kernels.launch("vx_track_leg_shadow_slabs_park", t, *args, events.data_ptr(), tr.data_ptr(),
                   *(a.data_ptr() for a in (state_o, tr_o, events_o, t_o, park)), t.shape[0],
                   counter="track_leg_shadow_slabs_park")
    return state_o, tr_o, events_o, t_o, park


def track_leg_sample_park(grid, extent, scalars, lut, ipos, idir, far, t, events, state, running):
    """The camera leg over a SlabGrid whose absent slabs park lanes: the
    arguments of `track_leg_sample` and each lane's `events` (n,) int32
    left. Returns (state, hit, t, rgb, events, park): a parked lane's t,
    words and events are those before the event it parked at, and park
    (n,) int32 names the absent slab that event reads (-1 for every other
    lane, whose outputs are the slab form's). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    args = (grid, extent, scalars, lut, ipos, idir, far, t, events, state, running)
    if t.device.type == "cpu":
        return track_leg_sample_park_plain(*args)
    return track_leg_sample_park_cuda(*args)


def track_leg_shadow_park(grid, extent, scalars, lut, ipos, idir, far, t, events, state, running, tr):
    """The shadow leg's park form: the arguments of `track_leg_sample_park`
    and tr. Returns (state, tr, events, t, park), t a parked lane's (the
    input t elsewhere). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    args = (grid, extent, scalars, lut, ipos, idir, far, t, events, state, running, tr)
    if t.device.type == "cpu":
        return track_leg_shadow_park_plain(*args)
    return track_leg_shadow_park_cuda(*args)


def resident_warps(leg: str, device) -> int:
    """The warps that leg `leg`'s ("sample" or "shadow") kernel keeps
    resident on one SM of `device`."""
    return kernels.resident_warps("vx_track_leg_resident_warps", int(leg == "shadow"), device)


def track_leg_sample(
    dense,  # (Z, Y, X) bf16 decoded density, or a SlabGrid (its slabs, through their table)
    extent,  # (ex, ey, ez) ints: the volume's index extent
    scalars,  # (5,) f32 on the device: tilemarch.volume_scalars(params)
    lut,  # (K, 4) f32 transfer LUT
    ipos, idir,  # (n, 3) f32 index-space rays
    far, t,  # (n,) f32: box exit and the first free flight's t
    state,  # (n, 4) int64 xoshiro words
    running,  # (n,) bool
):
    """The camera leg (sample_volume_simple after its setup). Returns
    (state, hit, t, rgb, events): the words after the leg's draws, whether
    the lane hit, t at the hit (or where it stopped), the LUT colour of the
    hit (1 elsewhere) and the events left of TRACKING_MAX_EVENTS. The inputs
    are left as they are. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    args = (dense, extent, scalars, lut, ipos, idir, far, t, state, running)
    if t.device.type == "cpu":
        return track_leg_sample_plain(*args)
    return track_leg_sample_cuda(*args)


def track_leg_shadow(dense, extent, scalars, lut, ipos, idir, far, t, state, running, tr):
    """The shadow leg (transmittance_simple after its setup): `tr` (n,) f32
    is each lane's transmittance before it, the other arguments are those
    of `track_leg_sample`. Returns (state, tr, events), events the events
    left of TRACKING_MAX_EVENTS; the inputs are left as they are. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    args = (dense, extent, scalars, lut, ipos, idir, far, t, state, running, tr)
    if t.device.type == "cpu":
        return track_leg_shadow_plain(*args)
    return track_leg_shadow_cuda(*args)
