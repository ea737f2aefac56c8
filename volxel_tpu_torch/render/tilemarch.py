"""Tile-march: the raymarch mode's step loops (camera leg and shadow leg),
and nearest-tap density sums, as hand-written CUDA kernels on the card
beside their plain PyTorch versions.

Counterpart of volxel_tpu.render.tilemarch. There, Mosaic cannot gather
per lane, so each (tile, step) streams a block window of the dense field
into VMEM, each lane's tap is selected by one-hot matrix products, a lane
whose tap support leaves the window freezes and is resumed by an XLA loop
(modes._raymarch_resume). What the kernels compute per lane is the plain
form those are pinned bit-identical to:

  tile_march_sample: modes._raymarch_loop after the prologue. Up to STEPS
    steps at t = min(start + i * dt, far), each a stochastic tricubic tap
    (nine masked xoshiro128++ draws), the transfer LUT with range
    rejection and tau += alpha * vol_maj * dt; a lane stops at its first
    step with tau >= tau_target.
  tile_march_transmittance: modes.transmittance_raymarch's step loop (no
    TPU kernel there). The same steps with no hit test: every lane inside
    the box takes all STEPS steps and their draws, and returns its tau.
  tile_march_sums: serial_march_sums. The sum over `steps` of the nearest
    tap dense[floor(p - 0.5)], 0 outside the volume and on invalid lanes.

Here every thread gathers its own taps (csrc/tile_march.cu), so there is
no window, no freeze and no fallback, and the TPU sums kernel's `miss`
output (window misses) has no counterpart. Both step loops share one step
body in 32-bit forms (a 32-bit tap index where the field's extent holds at
most 2^31 elements, else a 64-bit one); the camera loop takes its steps
one at a time up to its hit, the shadow loop keeps the taps of its next two
steps in flight. The sums run on a grid of a few blocks an SM that walks
the lanes at its stride, each lane issuing the loads of 16 steps before it
adds them, so that the rays in flight are a strip of neighbouring pixels
whose taps share L2 lines. The kernels are built with --fmad=false and
follow the plain versions' op order, so on the card they agree bit for
bit on every output of every lane.

Park forms (a vz row across nodes, parallel.migrate): over a SlabGrid
whose slabs on other nodes are absent, tile_march_*_park take each lane's
step index and tau. A lane parks before a step whose base cell lies in an
absent slab, before that step's draws: it stops with its step index, tau
and words as they are, and `park` names the slab (-1 for a lane that
ended). The same park form resumes it from that step where the slab is
readable. The shadow kernel issues the taps of later steps ahead, so its
park test goes where a step's tap is issued; the steps before it are
still consumed. They count as tile_march_*_slabs_park.
"""

from __future__ import annotations

import torch

from volxel_tpu_torch import kernels
from volxel_tpu_torch.render.sampling import (
    SLAB_HALO,
    DeviceGrid,
    SlabGrid,
    VolumeParams,
    field_grid,
    lookup_density_brick_int,
    slab_owner,
    stochastic_tricubic_offsets,
)
from volxel_tpu_torch.render.gather import lookup_transfer_plain

STEPS = 64  # RAYMARCH_STEPS (raymarch.glsl:6)

# layout of the (5,) f32 scalars tensor, as the JAX kernel's S_* rows
S_INV_MAJ = 0
S_VOL_MAJ = 1
S_DEN_SCALE = 2
S_RANGE_LO = 3
S_RANGE_HI = 4

# the step loops stage the LUT in shared memory: at most 48 KiB of it
MAX_LUT_ROWS = 3072


def volume_scalars(params: VolumeParams):
    """The kernel's (5,) f32 scalars on the params' device: no host sync."""
    return torch.stack(
        [params.inv_maj, params.vol_maj, params.density_scale, params.sample_range[0], params.sample_range[1]]
    )


def tile_march_plain(dense, ipos, idir, start, dt, far, valid, tau_target, state, lut, scalars, extent):
    """Plain PyTorch step loop of both legs: every lane in lockstep under a
    mask, at most STEPS steps. With a `tau_target` each lane stops at its
    hit (`tile_march_sample`); with None every lane inside the box takes
    all STEPS steps (`tile_march_transmittance`). Returns (state, hit, t,
    rgb, tau, taken): `taken` is the steps each lane took (0 outside the
    box)."""
    grid = field_grid(dense, extent)
    inv_maj, vol_maj, density_scale = scalars[S_INV_MAJ], scalars[S_VOL_MAJ], scalars[S_DEN_SCALE]
    sample_range = scalars[S_RANGE_LO:S_RANGE_HI + 1]
    n = ipos.shape[0]
    marching = valid.clone()
    tau = torch.zeros((n,), dtype=torch.float32, device=ipos.device)
    hit = torch.zeros_like(valid)
    t_out = torch.zeros_like(tau)
    rgb_out = torch.ones((n, 3), dtype=torch.float32, device=ipos.device)
    taken = torch.zeros((n,), dtype=torch.int64, device=ipos.device)
    i = 0
    while i < STEPS and bool(marching.any()):
        t = torch.minimum(start + i * dt, far)
        state, tap = stochastic_tricubic_offsets(ipos + t[:, None] * idir, state, marching)
        d_raw = density_scale * lookup_density_brick_int(grid, tap)
        rgba = lookup_transfer_plain(lut, sample_range, d_raw * inv_maj)
        tau_new = tau + rgba[:, 3] * vol_maj * dt
        tau = torch.where(marching, tau_new, tau)
        taken = taken + marching.to(torch.int64)
        if tau_target is not None:
            new_hit = marching & (tau_new >= tau_target)
            hit = hit | new_hit
            t_out = torch.where(new_hit, t, t_out)
            rgb_out = torch.where(new_hit[:, None], rgba[:, :3], rgb_out)
            marching = marching & ~new_hit
        i += 1
    return state, hit, t_out, rgb_out, tau, taken


def tile_march_sample_plain(dense, ipos, idir, start, dt, far, valid, tau_target, state, lut, scalars, extent):
    """Plain PyTorch camera leg; see `tile_march_sample`."""
    return tile_march_plain(dense, ipos, idir, start, dt, far, valid, tau_target, state, lut, scalars, extent)[:4]


def tile_march_transmittance_plain(dense, ipos, idir, start, dt, far, valid, state, lut, scalars, extent):
    """Plain PyTorch shadow leg; see `tile_march_transmittance`."""
    state, _, _, _, tau, _ = tile_march_plain(dense, ipos, idir, start, dt, far, valid, None, state, lut, scalars,
                                              extent)
    return state, tau


def tile_march_park_plain(grid, ipos, idir, start, dt, far, valid, tau_target, state, lut, scalars, extent, step,
                          tau):
    """tile_march_plain over a SlabGrid from each lane's step index `step`
    (n,) int32 and its `tau`, each tap read from the slab of its pick's base
    cell (whose halo holds it, as the kernels read it); a lane whose next
    step's base cell lies in an absent slab parks before that step's draws.
    Returns (state, hit, t, rgb, tau, step, park): step the parked lanes'
    (the input step elsewhere), park their absent slab (-1 elsewhere)."""
    inv_maj, vol_maj, density_scale = scalars[S_INV_MAJ], scalars[S_VOL_MAJ], scalars[S_DEN_SCALE]
    sample_range = scalars[S_RANGE_LO:S_RANGE_HI + 1]
    n = ipos.shape[0]
    step_in, step, tau, state = step, step.clone(), tau.clone(), state.clone()
    marching = valid & (step < STEPS)
    hit = torch.zeros_like(valid)
    t_out = torch.zeros((n,), dtype=torch.float32, device=ipos.device)
    rgb_out = torch.ones((n, 3), dtype=torch.float32, device=ipos.device)
    park = torch.full((n,), -1, dtype=torch.int64, device=ipos.device)
    absent = grid.absent(ipos.device)
    while bool(marching.any()):
        t = torch.minimum(start + step.to(torch.float32) * dt, far)
        pos = ipos + t[:, None] * idir
        owner = slab_owner(grid, pos[:, 2])
        parked = marching & absent[owner]
        park = torch.where(parked, owner, park)
        marching = marching & ~parked
        state, tap = stochastic_tricubic_offsets(pos, state, marching)
        lanes = torch.nonzero(marching).squeeze(1)
        raw = torch.zeros((n,), dtype=torch.float32, device=ipos.device)
        raw[lanes] = lookup_density_brick_int(grid, tap[lanes], owner[lanes])
        rgba = lookup_transfer_plain(lut, sample_range, density_scale * raw * inv_maj)
        tau_new = tau + rgba[:, 3] * vol_maj * dt
        tau = torch.where(marching, tau_new, tau)
        step = torch.where(marching, step + 1, step)
        if tau_target is not None:
            new_hit = marching & (tau_new >= tau_target)
            hit = hit | new_hit
            t_out = torch.where(new_hit, t, t_out)
            rgb_out = torch.where(new_hit[:, None], rgba[:, :3], rgb_out)
            marching = marching & ~new_hit
        marching = marching & (step < STEPS)
    held = park >= 0
    return state, hit, t_out, rgb_out, tau, torch.where(held, step, step_in), park.to(torch.int32)


def tile_march_sample_park_plain(grid, ipos, idir, start, dt, far, valid, tau_target, state, lut, scalars, extent,
                                 step, tau):
    """Plain PyTorch camera leg's park form; see `tile_march_sample_park`."""
    state, hit, t, rgb, tau, step, park = tile_march_park_plain(grid, ipos, idir, start, dt, far, valid, tau_target,
                                                                state, lut, scalars, extent, step, tau)
    return state, hit, t, rgb, step, tau, park


def tile_march_transmittance_park_plain(grid, ipos, idir, start, dt, far, valid, state, lut, scalars, extent, step,
                                        tau):
    """Plain PyTorch shadow leg's park form; see
    `tile_march_transmittance_park`."""
    state, _, _, _, tau, step, park = tile_march_park_plain(grid, ipos, idir, start, dt, far, valid, None, state, lut,
                                                            scalars, extent, step, tau)
    return state, tau, step, park


def _check_lanes(name, n, vectors, scalars_per_lane):
    for label, a in vectors:
        if tuple(a.shape) != (n, 3):
            raise ValueError(f"{name}: {label} must be ({n}, 3), got {tuple(a.shape)}")
    for label, a in scalars_per_lane:
        if tuple(a.shape) != (n,):
            raise ValueError(f"{name}: {label} must be ({n},), got {tuple(a.shape)}")


def _check_dense(name, dense, extent):
    kernels.require_cuda(name, dense, dtype=torch.bfloat16)
    if dense.dim() != 3:
        raise ValueError(f"{name}: expected a (Z, Y, X) dense field, got {tuple(dense.shape)}")
    ex, ey, ez = (int(v) for v in extent)
    nz, ny, nx = dense.shape
    if not (0 < ex <= nx and 0 < ey <= ny and 0 < ez <= nz):
        raise ValueError(f"{name}: extent {(ex, ey, ez)} outside the dense field {tuple(dense.shape)}")
    return ex, ey, ez


def slab_form(name: str, field) -> str:
    """The entry point (without its vx_ prefix) and the launch counter of
    kernel `name` for what it reads: `name` for a dense field, `name`_slabs
    for a SlabGrid."""
    return name + "_slabs" if isinstance(field, SlabGrid) else name


def check_slabs(name, grid: SlabGrid, extent, device):
    """Check a SlabGrid that a launch on `device` reads through its
    table (kernels.enable_peer_access for each slab's card when the table
    is made): each slab a contiguous (slab + 2 * SLAB_HALO, Y, X) bf16
    CUDA tensor, or absent (another node's) where `name` is a park form,
    the table one int64 pointer a slab on `device`, the extent inside the
    slabs' field. Returns the C arguments slabs, slab,
    ny, nx and the extent."""
    held = [s for s in grid.slabs if s is not None]
    if not held:
        raise ValueError(f"{name}: a SlabGrid without slabs")
    if len(held) < len(grid.slabs) and not name.endswith("_park"):
        raise ValueError(f"{name}: a slab lies on another node; only a park form (`{name}_park`, driven by "
                         "parallel.migrate) reads such a grid")
    first = held[0]
    for s in held:
        kernels.require_cuda(name, s, dtype=torch.bfloat16, device=s.device)
        if s.dim() != 3 or tuple(s.shape) != (grid.slab + 2 * SLAB_HALO, *first.shape[1:]):
            raise ValueError(f"{name}: slab of shape {tuple(s.shape)}, expected "
                             f"{(grid.slab + 2 * SLAB_HALO, *first.shape[1:])}")
    table = grid.table(device)
    if table.device != torch.device(device) or table.dtype != torch.int64 or tuple(table.shape) != (len(grid.slabs),):
        raise ValueError(f"{name}: slab table {table.dtype} {tuple(table.shape)} on {table.device}, expected int64 "
                         f"({len(grid.slabs)},) on {device}")
    ex, ey, ez = (int(v) for v in extent)
    _, ny, nx = first.shape
    if not (0 < ex <= nx and 0 < ey <= ny and 0 < ez <= grid.slab * len(grid.slabs)):
        raise ValueError(f"{name}: extent {(ex, ey, ez)} outside the slabs' field "
                         f"{(grid.slab * len(grid.slabs), ny, nx)}")
    return table.data_ptr(), grid.slab, ny, nx, (ex, ey, ez)


def _check_field(name, dense, extent, device):
    """The C arguments of what a step loop on `device` reads, up to the
    extent (dense, ny, nx, or slabs, slab, ny, nx), and the extent."""
    if isinstance(dense, SlabGrid):
        *head, ext = check_slabs(name, dense, extent, device)
        return tuple(head), ext
    ext = _check_dense(name, dense, extent)
    kernels.require_cuda(name, dense, device=device)
    return (dense.data_ptr(), *dense.shape[1:]), ext


def _check_march(name, dense, ipos, idir, start, dt, far, valid, state, lut, scalars, extent, per_lane=()):
    """Device, type, shape and contiguity of a step loop's operands;
    returns the C arguments of its field up to the extent, the extent and
    the lane count."""
    field, ext = _check_field(name, dense, extent, ipos.device)
    dev = ipos.device
    kernels.require_cuda(name, ipos, idir, start, dt, far, lut, scalars, *(a for _, a in per_lane),
                         dtype=torch.float32, device=dev)
    kernels.require_cuda(name, valid, dtype=torch.bool, device=dev)
    kernels.require_cuda(name, state, dtype=torch.int64, device=dev)
    n = ipos.shape[0]
    _check_lanes(name, n, (("ipos", ipos), ("idir", idir)),
                 (("start", start), ("dt", dt), ("far", far), ("valid", valid), *per_lane))
    if tuple(state.shape) != (n, 4):
        raise ValueError(f"{name}: state must be ({n}, 4), got {tuple(state.shape)}")
    if lut.dim() != 2 or lut.shape[1] != 4 or not 0 < lut.shape[0] <= MAX_LUT_ROWS:
        raise ValueError(f"{name}: lut must be (K, 4) with K <= {MAX_LUT_ROWS}, got {tuple(lut.shape)}")
    if tuple(scalars.shape) != (S_RANGE_HI + 1,):
        raise ValueError(f"{name}: scalars must be ({S_RANGE_HI + 1},), got {tuple(scalars.shape)}")
    return field, ext, n


def tile_march_sample_cuda(dense, ipos, idir, start, dt, far, valid, tau_target, state, lut, scalars, extent):
    """The step loop as one launch of csrc/tile_march.cu (a 32-bit tap
    index where the extent, or one slab, holds at most 2^31 elements); see
    `tile_march_sample`."""
    field, (ex, ey, ez), n = _check_march("tile_march_sample", dense, ipos, idir, start, dt, far, valid, state, lut,
                                          scalars, extent, (("tau_target", tau_target),))
    state_o = torch.empty_like(state)
    hit = torch.empty_like(valid)
    t_o = torch.empty_like(start)
    rgb = torch.empty_like(ipos)
    name = slab_form("tile_march_sample", dense)
    kernels.launch(
        f"vx_{name}", ipos, *field, ex, ey, ez,
        ipos.data_ptr(), idir.data_ptr(), start.data_ptr(), dt.data_ptr(), far.data_ptr(),
        valid.data_ptr(), tau_target.data_ptr(), state.data_ptr(), lut.data_ptr(), lut.shape[0],
        scalars.data_ptr(), state_o.data_ptr(), hit.data_ptr(), t_o.data_ptr(), rgb.data_ptr(), n, STEPS,
        counter=name,
    )
    return state_o, hit, t_o, rgb


def tile_march_sample(
    dense,  # (Z, Y, X) bf16 decoded density, or a SlabGrid (its slabs, through their table)
    ipos, idir,  # (n, 3) f32 index-space rays
    start, dt, far,  # (n,) f32: jittered first t, step, box exit
    valid,  # (n,) bool: active and inside the box
    tau_target,  # (n,) f32: -log(1 - xi), drawn in the prologue
    state,  # (n, 4) int64 xoshiro words after the prologue's draws
    lut,  # (K, 4) f32 transfer LUT
    scalars,  # (5,) f32 on the device: volume_scalars(params)
    extent,  # (ex, ey, ez) ints: the volume's index extent
):
    """Raymarch the camera leg after its prologue (raymarch.glsl:42-55).
    Returns (state, hit, t, rgb) per lane: the words after each lane's
    draws, whether it reached its tau target, the t of that step (0
    elsewhere) and the LUT colour there (1 elsewhere). A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    args = (dense, ipos, idir, start, dt, far, valid, tau_target, state, lut, scalars, extent)
    if ipos.device.type == "cpu":
        return tile_march_sample_plain(*args)
    return tile_march_sample_cuda(*args)


def resident_warps(leg: str, lut_k: int, device) -> int:
    """The warps that a step-loop or sums kernel keeps resident on one SM
    of `device`, with a LUT of `lut_k` rows staged in a step loop's shared
    memory: `leg` is "sample", "shadow" or "sums" for the kernel with a
    32-bit tap index, and with "_wide" for the one with a 64-bit index."""
    kernel = ("sample", "sample_wide", "shadow", "shadow_wide", "sums", "sums_wide").index(leg)
    return kernels.resident_warps("vx_tile_march_resident_warps", kernel, device, lut_k)


def tile_march_transmittance_cuda(dense, ipos, idir, start, dt, far, valid, state, lut, scalars, extent):
    """The step loop as one launch of csrc/tile_march.cu, the taps of each
    lane's next two steps in flight (a 32-bit tap index where the extent
    holds at most 2^31 elements, or one slab does); see
    `tile_march_transmittance`."""
    field, (ex, ey, ez), n = _check_march("tile_march_transmittance", dense, ipos, idir, start, dt, far, valid,
                                          state, lut, scalars, extent)
    state_o = torch.empty_like(state)
    tau = torch.empty_like(start)
    name = slab_form("tile_march_transmittance", dense)
    kernels.launch(
        f"vx_{name}", ipos, *field, ex, ey, ez,
        ipos.data_ptr(), idir.data_ptr(), start.data_ptr(), dt.data_ptr(), far.data_ptr(),
        valid.data_ptr(), state.data_ptr(), lut.data_ptr(), lut.shape[0], scalars.data_ptr(),
        state_o.data_ptr(), tau.data_ptr(), n, STEPS, counter=name,
    )
    return state_o, tau


def tile_march_transmittance(dense, ipos, idir, start, dt, far, valid, state, lut, scalars, extent):
    """The raymarch shadow leg after its box test and start jitter
    (raymarch.glsl:18-22): every lane inside the box takes all STEPS steps
    and their nine draws each, tau += alpha * vol_maj * dt. Arguments as
    in `tile_march_sample` (no tau target). Returns (state, tau): the words
    after each lane's draws and tau (0 outside the box). A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    args = (dense, ipos, idir, start, dt, far, valid, state, lut, scalars, extent)
    if ipos.device.type == "cpu":
        return tile_march_transmittance_plain(*args)
    return tile_march_transmittance_cuda(*args)


def _check_park(name, grid, ipos, step, tau):
    """Check a park form's grid and per-lane step and tau; their C
    arguments."""
    if not isinstance(grid, SlabGrid):
        raise ValueError(f"{name}: the park forms read a SlabGrid")
    kernels.require_cuda(name, step, dtype=torch.int32, device=ipos.device)
    kernels.require_cuda(name, tau, dtype=torch.float32, device=ipos.device)
    _check_lanes(name, ipos.shape[0], (), (("step", step), ("tau", tau)))
    return step.data_ptr(), tau.data_ptr()


def tile_march_sample_park_cuda(grid, ipos, idir, start, dt, far, valid, tau_target, state, lut, scalars, extent, step,
                                tau):
    """The camera leg's park form as one launch of csrc/tile_march.cu; see
    `tile_march_sample_park`."""
    parks = _check_park("tile_march_sample_park", grid, ipos, step, tau)
    field, (ex, ey, ez), n = _check_march("tile_march_sample_park", grid, ipos, idir, start, dt, far, valid, state,
                                          lut, scalars, extent, (("tau_target", tau_target),))
    state_o, hit, t_o, rgb = torch.empty_like(state), torch.empty_like(valid), torch.empty_like(start), \
        torch.empty_like(ipos)
    tau_o, step_o, park = torch.empty_like(tau), torch.empty_like(step), torch.empty_like(step)
    kernels.launch(
        "vx_tile_march_sample_slabs_park", ipos, *field, ex, ey, ez,
        *(a.data_ptr() for a in (ipos, idir, start, dt, far, valid, tau_target, state, lut)), lut.shape[0],
        scalars.data_ptr(), *parks, *(a.data_ptr() for a in (state_o, hit, t_o, rgb, tau_o, step_o, park)), n, STEPS,
        counter="tile_march_sample_slabs_park",
    )
    return state_o, hit, t_o, rgb, step_o, tau_o, park


def tile_march_transmittance_park_cuda(grid, ipos, idir, start, dt, far, valid, state, lut, scalars, extent, step,
                                       tau):
    """The shadow leg's park form as one launch of csrc/tile_march.cu; see
    `tile_march_transmittance_park`."""
    parks = _check_park("tile_march_transmittance_park", grid, ipos, step, tau)
    field, (ex, ey, ez), n = _check_march("tile_march_transmittance_park", grid, ipos, idir, start, dt, far, valid,
                                          state, lut, scalars, extent)
    state_o, tau_o, step_o, park = torch.empty_like(state), torch.empty_like(tau), torch.empty_like(step), \
        torch.empty_like(step)
    kernels.launch(
        "vx_tile_march_transmittance_slabs_park", ipos, *field, ex, ey, ez,
        *(a.data_ptr() for a in (ipos, idir, start, dt, far, valid, state, lut)), lut.shape[0], scalars.data_ptr(),
        *parks, *(a.data_ptr() for a in (state_o, tau_o, step_o, park)), n, STEPS,
        counter="tile_march_transmittance_slabs_park",
    )
    return state_o, tau_o, step_o, park


def tile_march_sample_park(grid, ipos, idir, start, dt, far, valid, tau_target, state, lut, scalars, extent, step,
                           tau):
    """The camera leg over a SlabGrid whose absent slabs park lanes: the
    arguments of `tile_march_sample`, and each lane's next `step` (n,)
    int32 and its `tau` (n,) f32 so far. Returns (state, hit, t, rgb, step,
    tau, park): a parked lane's words, step and tau are those before the
    step it parked at, park (n,) int32 names that step's absent slab (-1
    for every other lane, whose outputs are the slab form's). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    args = (grid, ipos, idir, start, dt, far, valid, tau_target, state, lut, scalars, extent, step, tau)
    if ipos.device.type == "cpu":
        return tile_march_sample_park_plain(*args)
    return tile_march_sample_park_cuda(*args)


def tile_march_transmittance_park(grid, ipos, idir, start, dt, far, valid, state, lut, scalars, extent, step, tau):
    """The shadow leg's park form: the arguments of
    `tile_march_transmittance`, then step and tau as in
    `tile_march_sample_park`. Returns (state, tau, step, park). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    args = (grid, ipos, idir, start, dt, far, valid, state, lut, scalars, extent, step, tau)
    if ipos.device.type == "cpu":
        return tile_march_transmittance_park_plain(*args)
    return tile_march_transmittance_park_cuda(*args)


def tile_march_sums_plain(dense, ipos, idir, start, dt, far, valid, extent, steps: int = STEPS):
    """Plain PyTorch sums (the JAX package's serial_march_sums); see
    `tile_march_sums`."""
    grid = DeviceGrid(dense=dense, maj_mips=None, extent=tuple(extent))
    acc = torch.zeros_like(start)
    for s in range(steps):
        t = torch.minimum(start + s * dt, far)
        tap = torch.floor(ipos + t[:, None] * idir - 0.5).to(torch.int32)
        acc = acc + torch.where(valid, lookup_density_brick_int(grid, tap), 0.0)
    return acc


def tile_march_sums_cuda(dense, ipos, idir, start, dt, far, valid, extent, steps: int = STEPS):
    """The sums as one launch of csrc/tile_march.cu (a 32-bit tap index
    where the extent holds at most 2^31 elements); see `tile_march_sums`."""
    ex, ey, ez = _check_dense("tile_march_sums", dense, extent)
    dev = dense.device
    kernels.require_cuda("tile_march_sums", ipos, idir, start, dt, far, dtype=torch.float32, device=dev)
    kernels.require_cuda("tile_march_sums", valid, dtype=torch.bool, device=dev)
    n = ipos.shape[0]
    _check_lanes("tile_march_sums", n, (("ipos", ipos), ("idir", idir)),
                 (("start", start), ("dt", dt), ("far", far), ("valid", valid)))
    _, ny, nx = dense.shape
    sums = torch.empty_like(start)
    kernels.launch(
        "vx_tile_march_sums", ipos, dense.data_ptr(), ny, nx, ex, ey, ez,
        ipos.data_ptr(), idir.data_ptr(), start.data_ptr(), dt.data_ptr(), far.data_ptr(),
        valid.data_ptr(), sums.data_ptr(), n, int(steps), counter="tile_march_sums",
    )
    return sums


def tile_march_sums(dense, ipos, idir, start, dt, far, valid, extent, steps: int = STEPS):
    """Per-lane sum over `steps` of the nearest-tap density
    dense[floor(ipos + min(start + s * dt, far) * idir - 0.5)] -> (n,) f32;
    taps outside `extent` and invalid lanes give 0. Arguments as in
    `tile_march_sample`. The JAX kernel's second output, `miss`, counted
    taps outside its VMEM window; without a window there is none. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    args = (dense, ipos, idir, start, dt, far, valid, extent, steps)
    if ipos.device.type == "cpu":
        return tile_march_sums_plain(*args)
    return tile_march_sums_cuda(*args)
