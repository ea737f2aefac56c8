"""The default mode's two legs, each one hand-written CUDA kernel on the card
beside its plain PyTorch version.

Counterpart of volxel_tpu.render.modes.sample_volume_dda_pyr and
transmittance_dda_pyr after their setup (dda.glsl:21-62 and :65-98): the
DDA march over the premultiplied majorant pyramid to each lane's next
collision candidate (render.pyrmarch), and at each candidate the density
decode and the draws (render.collide), until the lane ends.

  dda_leg_sample: the camera leg. A real collision ends the lane (hit, the
    LUT colour); a null one redraws tau, steps the mip down, and the lane
    marches on. Step budget DDA_SAMPLE_MAX_STEPS.
  dda_leg_shadow: the shadow leg. Ratio tracking with the reference's
    quirk or, with `physical`, the proper ratio; russian roulette under
    0.1 ends a lane with tr = 0. Step budget DDA_TRANSMITTANCE_MAX_STEPS.

A lane also ends when it escapes past `far` or spends its budget. The
plain versions are rounds over all lanes: pyr_march_plain, then one
collision round, while any lane runs. The kernels (csrc/dda_leg.cu) are
one thread per lane that marches and collides until its lane ends, one
march step an iteration (a lane that collides decodes in that iteration),
one launch per leg and no host sync. Each lane's budget, words and march
state are its own and a march round never cuts a lane short, so the two
agree bit for bit on the card. Both return each lane's budget left beside
the leg's outputs: cap - budget is the march steps the lane took. The
kernels index the pyramid in 32 bits and the field in 64. Over a SlabGrid
(render-time volume slabs) the same kernels read each collision's taps
from the slab of the owner of its base z, through the slabs' pointer
table, and count their launches as dda_leg_*_slabs.

Park forms (a vz row across nodes, parallel.migrate): over a SlabGrid
whose slabs on other nodes are absent, dda_leg_*_park take each lane's
budget, and a `resume` flag that starts a lane at the collision its t,
mip and majorant m describe. A lane whose collision's base z is owned by
an absent slab parks there, before the taps' fetch: it stops with its t,
mip, m, budget, words (and tr) as they are, and `park` names the slab
(-1 for a lane that ended). Resumed where the slab is readable, it goes
on bit for bit as the one-run slab form would have. Their kernels count
as dda_leg_*_slabs_park.
"""

from __future__ import annotations

import torch

from volxel_tpu_torch import kernels
from volxel_tpu_torch.render.collide import dda_collide_sample_plain, dda_collide_shadow_plain
from volxel_tpu_torch.render.pyrmarch import KIND_COLL, KIND_IDLE, pyr_march_plain
from volxel_tpu_torch.render.sampling import SlabGrid, parked_owner
from volxel_tpu_torch.render.tilemarch import S_RANGE_HI, _check_dense, _check_lanes, check_slabs, slab_form

# per-lane step budgets
DDA_SAMPLE_MAX_STEPS = 1024
DDA_TRANSMITTANCE_MAX_STEPS = 100  # dda.glsl:18


def _rounds(collide, cap, dense, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, state, running,
            outputs, *flags):
    """March and collide in rounds while any lane runs; `collide` updates
    state, tau, mip, running and `outputs` in place. Returns (state, t,
    budget); the inputs are left as they are."""
    state, tau, mip, running = state.clone(), tau.clone(), mip.clone(), running.clone()
    budget = torch.full(t.shape, cap, dtype=torch.int32, device=t.device)
    while bool(running.any()):
        t, tau, mip, maj, kind, budget = pyr_march_plain(maj_alpha, extent, ipos, idir, ri, t, tau, mip, far, budget,
                                                         running, cap)
        collide(dense, extent, scalars, lut, ipos, idir, t, maj, kind, state, tau, mip, running, *outputs, *flags)
    return state, t, budget


def dda_leg_sample_plain(dense, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, state, running):
    """Plain PyTorch camera leg in rounds; see `dda_leg_sample`."""
    hit = torch.zeros_like(running)
    rgb = torch.ones((t.shape[0], 3), dtype=torch.float32, device=t.device)
    state, t, budget = _rounds(dda_collide_sample_plain, DDA_SAMPLE_MAX_STEPS, dense, maj_alpha, extent, scalars, lut,
                               ipos, idir, ri, far, t, tau, mip, state, running, (hit, rgb))
    return state, hit, t, rgb, budget


def dda_leg_shadow_plain(dense, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, state, running,
                         tr, physical: bool = False):
    """Plain PyTorch shadow leg in rounds; see `dda_leg_shadow`."""
    tr = tr.clone()
    state, _, budget = _rounds(dda_collide_shadow_plain, DDA_TRANSMITTANCE_MAX_STEPS, dense, maj_alpha, extent,
                               scalars, lut, ipos, idir, ri, far, t, tau, mip, state, running, (tr,), physical)
    return state, tr, budget


def _rounds_park(collide, cap, grid, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, m, budget,
                 state, running, resume, outputs, *flags):
    """_rounds from each lane's own budget, a `resume` lane starting at its
    collision (t, mip and majorant m) with the decode; before each decode a
    lane whose taps lie in an absent slab parks. Returns (state, t, budget,
    mip, m, park): mip and m the parked lanes' (the input mip and 0
    elsewhere), park the slab each parked lane waits for (-1 elsewhere)."""
    state, t, tau, mip_in, running, budget = state.clone(), t.clone(), tau.clone(), mip, running.clone(), budget.clone()
    mip = mip.clone()
    at = running & resume
    kind = torch.where(at, KIND_COLL, KIND_IDLE).to(torch.int32)
    maj = torch.where(at, m, 0.0)
    march = running & ~resume
    park = torch.full(t.shape, -1, dtype=torch.int64, device=t.device)
    while bool(running.any()):
        if bool(march.any()):
            t, tau, mip, maj_m, kind_m, budget = pyr_march_plain(maj_alpha, extent, ipos, idir, ri, t, tau, mip, far,
                                                                 budget, march, cap)
            kind, maj = torch.where(march, kind_m, kind), torch.where(march, maj_m, maj)
        owner = parked_owner(grid, ipos[:, 2] + t * idir[:, 2])
        parked = running & (kind == KIND_COLL) & (owner >= 0)
        park = torch.where(parked, owner, park)
        running &= ~parked
        collide(grid, extent, scalars, lut, ipos, idir, t, maj, kind, state, tau, mip, running, *outputs, *flags)
        march = running.clone()
        kind = torch.full_like(kind, KIND_IDLE)
    held = park >= 0
    return (state, t, budget, torch.where(held, mip, mip_in), torch.where(held, maj, 0.0),
            park.to(torch.int32))


def dda_leg_sample_park_plain(grid, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, m, budget,
                              state, running, resume):
    """Plain PyTorch camera leg's park form in rounds; see
    `dda_leg_sample_park`."""
    hit = torch.zeros_like(running)
    rgb = torch.ones((t.shape[0], 3), dtype=torch.float32, device=t.device)
    state, t, budget, mip, m, park = _rounds_park(dda_collide_sample_plain, DDA_SAMPLE_MAX_STEPS, grid, maj_alpha,
                                                  extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, m, budget,
                                                  state, running, resume, (hit, rgb))
    return state, hit, t, rgb, budget, mip, m, park


def dda_leg_shadow_park_plain(grid, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, m, budget,
                              state, running, resume, tr, physical: bool = False):
    """Plain PyTorch shadow leg's park form in rounds; see
    `dda_leg_shadow_park`."""
    tr = tr.clone()
    state, t, budget, mip, m, park = _rounds_park(dda_collide_shadow_plain, DDA_TRANSMITTANCE_MAX_STEPS, grid,
                                                  maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip,
                                                  m, budget, state, running, resume, (tr,), physical)
    return state, tr, budget, t, mip, m, park


def check_field(name, dense, extent, scalars, lut, device):
    """Check the field, the LUT and the scalars that a leg kernel on
    `device` reads (device, type, shape, contiguity, alignment) and return
    their C arguments and the extent: (dense, ny, nx, ex, ey, ez, lut,
    lut_k, scalars) for a dense field, (slabs, slab, round_taps, ny, nx,
    ex, ey, ez, lut, lut_k, scalars) for a SlabGrid (tilemarch.check_slabs)."""
    if isinstance(dense, SlabGrid):
        table, slab, ny, nx, (ex, ey, ez) = check_slabs(name, dense, extent, device)
        head = (table, slab, int(dense.tap_dtype == "bfloat16"), ny, nx, ex, ey, ez)
    else:
        ex, ey, ez = _check_dense(name, dense, extent)
        kernels.require_cuda(name, dense, device=device)
        _, ny, nx = dense.shape
        head = (dense.data_ptr(), ny, nx, ex, ey, ez)
    kernels.require_cuda(name, scalars, lut, dtype=torch.float32, device=device)
    if lut.dim() != 2 or lut.shape[1] != 4 or lut.shape[0] < 1:
        raise ValueError(f"{name}: lut must be (K, 4), got {tuple(lut.shape)}")
    if lut.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads 16-byte LUT rows; lut is misaligned")
    if tuple(scalars.shape) != (S_RANGE_HI + 1,):
        raise ValueError(f"{name}: scalars must be ({S_RANGE_HI + 1},), got {tuple(scalars.shape)}")
    return (*head, lut.data_ptr(), lut.shape[0], scalars.data_ptr()), (ex, ey, ez)


def check_lanes(name, device, vectors, per_lane, state, running):
    """Check a leg's per-lane operands on `device`: the (n, 3) f32
    `vectors` and (n,) f32 `per_lane` (label, tensor) pairs, the (n, 4)
    int64 words and the (n,) bool `running`."""
    kernels.require_cuda(name, *(a for _, a in (*vectors, *per_lane)), dtype=torch.float32, device=device)
    kernels.require_cuda(name, running, dtype=torch.bool, device=device)
    kernels.require_cuda(name, state, dtype=torch.int64, device=device)
    n = running.shape[0]
    _check_lanes(name, n, vectors, [*per_lane, ("running", running)])
    if tuple(state.shape) != (n, 4):
        raise ValueError(f"{name}: state must be ({n}, 4), got {tuple(state.shape)}")


def _volume_and_lanes(name, dense, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, state,
                      running, per_lane=()):
    """Check a leg's operands (device, type, shape, contiguity, alignment)
    and return the C entry point's arguments up to `running`."""
    field, (ex, ey, ez) = check_field(name, dense, extent, scalars, lut, t.device)
    check_lanes(name, t.device, [("ipos", ipos), ("idir", idir), ("ri", ri)],
                [("far", far), ("t", t), ("tau", tau), ("mip", mip), *per_lane], state, running)
    kernels.require_cuda(name, maj_alpha, dtype=torch.float32, device=t.device)
    if maj_alpha.dim() != 4 or maj_alpha.shape[0] != 4:
        raise ValueError(f"{name}: expected a (4, bz, by, bx) pyramid, got {tuple(maj_alpha.shape)}")
    _, bz, by, bx = maj_alpha.shape
    if maj_alpha.numel() >= 2**31:
        raise ValueError(f"{name}: the kernel indexes the pyramid in 32 bits; {tuple(maj_alpha.shape)} is too large")
    if 8 * bx < ex or 8 * by < ey or 8 * bz < ez:
        raise ValueError(f"{name}: pyramid {tuple(maj_alpha.shape)} does not cover the extent {(ex, ey, ez)}")
    return (maj_alpha.data_ptr(), bz, by, bx, *field,
            *(a.data_ptr() for a in (ipos, idir, ri, far, t, tau, mip, state, running)))


def dda_leg_sample_cuda(dense, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, state, running):
    """The camera leg as one launch of csrc/dda_leg.cu; see
    `dda_leg_sample`."""
    args = _volume_and_lanes("dda_leg_sample", dense, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau,
                             mip, state, running)
    n = t.shape[0]
    state_o, hit, t_o = torch.empty_like(state), torch.empty_like(running), torch.empty_like(t)
    rgb, budget = torch.empty((n, 3), dtype=torch.float32, device=t.device), torch.empty_like(t, dtype=torch.int32)
    name = slab_form("dda_leg_sample", dense)
    kernels.launch(f"vx_{name}", t, *args, DDA_SAMPLE_MAX_STEPS,
                   *(a.data_ptr() for a in (state_o, hit, t_o, rgb, budget)), n, counter=name)
    return state_o, hit, t_o, rgb, budget


def dda_leg_shadow_cuda(dense, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, state, running,
                        tr, physical: bool = False):
    """The shadow leg as one launch of csrc/dda_leg.cu; see
    `dda_leg_shadow`."""
    args = _volume_and_lanes("dda_leg_shadow", dense, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau,
                             mip, state, running, (("tr", tr),))
    state_o, tr_o, budget = torch.empty_like(state), torch.empty_like(tr), torch.empty_like(t, dtype=torch.int32)
    name = slab_form("dda_leg_shadow", dense)
    kernels.launch(f"vx_{name}", t, *args, tr.data_ptr(), DDA_TRANSMITTANCE_MAX_STEPS, int(bool(physical)),
                   *(a.data_ptr() for a in (state_o, tr_o, budget)), t.shape[0], counter=name)
    return state_o, tr_o, budget


def _park_lanes(name, t, m, budget, resume):
    """Check a park form's per-lane inputs; their C arguments."""
    kernels.require_cuda(name, m, dtype=torch.float32, device=t.device)
    kernels.require_cuda(name, budget, dtype=torch.int32, device=t.device)
    kernels.require_cuda(name, resume, dtype=torch.bool, device=t.device)
    _check_lanes(name, t.shape[0], (), [("m", m), ("budget", budget), ("resume", resume)])
    return m.data_ptr(), budget.data_ptr(), resume.data_ptr()


def _park_outputs(t, mip):
    """A park form's outputs t, mip, m (f32) and park (int32)."""
    return torch.empty_like(t), torch.empty_like(mip), torch.empty_like(t), torch.empty_like(t, dtype=torch.int32)


def dda_leg_sample_park_cuda(grid, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, m, budget,
                             state, running, resume):
    """The camera leg's park form as one launch of csrc/dda_leg.cu; see
    `dda_leg_sample_park`."""
    if not isinstance(grid, SlabGrid):
        raise ValueError("dda_leg_sample_park: the park forms read a SlabGrid")
    args = _volume_and_lanes("dda_leg_sample_park", grid, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t,
                             tau, mip, state, running)
    parks = _park_lanes("dda_leg_sample_park", t, m, budget, resume)
    n = t.shape[0]
    state_o, hit, rgb = torch.empty_like(state), torch.empty_like(running), torch.empty_like(ipos)
    budget_o = torch.empty_like(budget)
    t_o, mip_o, m_o, park = _park_outputs(t, mip)
    kernels.launch("vx_dda_leg_sample_slabs_park", t, *args, *parks,
                   *(a.data_ptr() for a in (state_o, hit, t_o, rgb, budget_o, mip_o, m_o, park)), n,
                   counter="dda_leg_sample_slabs_park")
    return state_o, hit, t_o, rgb, budget_o, mip_o, m_o, park


def dda_leg_shadow_park_cuda(grid, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, m, budget,
                             state, running, resume, tr, physical: bool = False):
    """The shadow leg's park form as one launch of csrc/dda_leg.cu; see
    `dda_leg_shadow_park`."""
    if not isinstance(grid, SlabGrid):
        raise ValueError("dda_leg_shadow_park: the park forms read a SlabGrid")
    args = _volume_and_lanes("dda_leg_shadow_park", grid, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t,
                             tau, mip, state, running, (("tr", tr),))
    parks = _park_lanes("dda_leg_shadow_park", t, m, budget, resume)
    state_o, tr_o, budget_o = torch.empty_like(state), torch.empty_like(tr), torch.empty_like(budget)
    t_o, mip_o, m_o, park = _park_outputs(t, mip)
    kernels.launch("vx_dda_leg_shadow_slabs_park", t, *args, *parks, tr.data_ptr(), int(bool(physical)),
                   *(a.data_ptr() for a in (state_o, tr_o, budget_o, t_o, mip_o, m_o, park)), t.shape[0],
                   counter="dda_leg_shadow_slabs_park")
    return state_o, tr_o, budget_o, t_o, mip_o, m_o, park


def dda_leg_sample_park(grid, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, m, budget, state,
                        running, resume):
    """The camera leg over a SlabGrid whose absent slabs park lanes: the
    arguments of `dda_leg_sample`, and each lane's `m` (n,) f32 majorant
    and `resume` (n,) bool (resume at the collision at t, whose majorant is
    m, with the decode; tau is not read there) and its steps left `budget`
    (n,) int32. Returns (state, hit, t, rgb, budget, mip, m, park): a
    parked lane's t, mip, m, budget and words are its collision's, and
    park (n,) int32 names the absent slab its taps lie in (-1 for every
    other lane, whose outputs are the slab form's). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    args = (grid, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, m, budget, state, running,
            resume)
    if t.device.type == "cpu":
        return dda_leg_sample_park_plain(*args)
    return dda_leg_sample_park_cuda(*args)


def dda_leg_shadow_park(grid, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, m, budget, state,
                        running, resume, tr, physical: bool = False):
    """The shadow leg's park form: the arguments of
    `dda_leg_sample_park`, then tr and physical. Returns (state, tr,
    budget, t, mip, m, park); a parked lane's tr is its tr before the
    collision. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    args = (grid, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, m, budget, state, running,
            resume, tr, physical)
    if t.device.type == "cpu":
        return dda_leg_shadow_park_plain(*args)
    return dda_leg_shadow_park_cuda(*args)


def dda_leg_sample(
    dense,  # (Z, Y, X) bf16 decoded density, or a SlabGrid (its slabs, through their table)
    maj_alpha,  # (4, bz, by, bx) f32 premultiplied pyramid (modes.build_premul_majorant)
    extent,  # (ex, ey, ez) ints: the volume's index extent
    scalars,  # (5,) f32 on the device: tilemarch.volume_scalars(params)
    lut,  # (K, 4) f32 transfer LUT
    ipos, idir, ri,  # (n, 3) f32 index-space rays and the caller's 1/idir
    far, t, tau, mip,  # (n,) f32: box exit and march state
    state,  # (n, 4) int64 xoshiro words
    running,  # (n,) bool
):
    """The camera leg (sample_volume_dda after its setup). Returns (state,
    hit, t, rgb, budget): the words after the leg's draws, whether the lane
    hit, t at the hit (or where it stopped), the LUT colour of the hit (1
    elsewhere) and the steps left of DDA_SAMPLE_MAX_STEPS. The inputs are
    left as they are. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    args = (dense, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, state, running)
    if t.device.type == "cpu":
        return dda_leg_sample_plain(*args)
    return dda_leg_sample_cuda(*args)


def dda_leg_shadow(dense, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, state, running, tr,
                   physical: bool = False):
    """The shadow leg (transmittance_dda after its setup): `tr` (n,) f32 is
    each lane's transmittance before it, the other arguments are those of
    `dda_leg_sample`. Returns (state, tr, budget), budget the steps left of
    DDA_TRANSMITTANCE_MAX_STEPS; the inputs are left as they are. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    args = (dense, maj_alpha, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, state, running, tr, physical)
    if t.device.type == "cpu":
        return dda_leg_shadow_plain(*args)
    return dda_leg_shadow_cuda(*args)


def resident_warps(leg: str, device) -> int:
    """The warps that leg `leg`'s ("sample", "shadow" or "physical") kernel
    keeps resident on one SM of `device`."""
    return kernels.resident_warps("vx_dda_leg_resident_warps", ("sample", "shadow", "physical").index(leg), device)


def neg_log1m_cuda(xi: torch.Tensor) -> torch.Tensor:
    """-log(1 - xi) as the leg kernels compute it on the card (one launch of
    csrc/dda_leg.cu's check kernel, on no render path and counted nowhere),
    to hold against -torch.log(1.0 - xi)."""
    kernels.require_cuda("neg_log1m", xi, dtype=torch.float32)
    out = torch.empty_like(xi)
    kernels.launch("vx_neg_log1m", xi, xi.data_ptr(), out.data_ptr(), xi.numel())
    return out
