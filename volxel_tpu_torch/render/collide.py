"""DDA collision step: the default mode's decode and draws at the lanes the
march parked, as one hand-written CUDA kernel per round on the card beside
its plain PyTorch version.

Counterpart of the loop bodies of volxel_tpu.render.modes.
sample_volume_dda_pyr and transmittance_dda_pyr after their pyr_march call
(dda.glsl:36-61 and :81-96). At each lane that render.pyrmarch.pyr_march
parked at a collision candidate (`kind == KIND_COLL`) of a running lane:
the position ipos + t * idir, the trilinear density decode of the bf16
dense field times inv_maj, the transfer LUT's NEAREST row with range
rejection (the JAX package's mxu_gather_f32 LUT site), d = vol_maj *
alpha and the real/null draw, then the leg's updates:

  dda_collide_sample: a real collision ends the lane (hit, the LUT colour);
    a null one redraws tau and steps the mip down.
  dda_collide_shadow: the ratio at a real collision (the reference's quirk
    1 - vol_maj / maj, or 1 - d / maj with `physical`), russian roulette
    under 0.1 (a killed lane stops with tr = 0), then the tau redraw and
    the mip step-down.

A running lane whose march is done (`kind == KIND_DONE`) stops running.
Every other lane is left as it is. Both entry points update state, tau,
mip, running and the leg's outputs (hit and rgb, or tr) IN PLACE, so a
round allocates nothing, and return them.

The kernel (csrc/dda_collide.cu) is one thread per lane over all lanes:
no nonzero, gather or scatter. Its f32 operations are the plain
version's, one rounding each, so on the card the two agree bit for bit.
"""

from __future__ import annotations

import torch

from volxel_tpu_torch import kernels
from volxel_tpu_torch.render.gather import lookup_transfer_plain
from volxel_tpu_torch.render.pyrmarch import KIND_COLL, KIND_DONE
from volxel_tpu_torch.render.rng import rng, rng_where
from volxel_tpu_torch.render.sampling import DeviceGrid, trilinear_sum
from volxel_tpu_torch.render.tilemarch import (
    S_DEN_SCALE,
    S_INV_MAJ,
    S_RANGE_HI,
    S_RANGE_LO,
    S_VOL_MAJ,
    _check_dense,
    _check_lanes,
)

MIP_SPEED_DOWN = 2.0  # dda.glsl:8


def _parked(dense, extent, scalars, lut, ipos, idir, t, kind, running):
    """The parked lanes' indices and their decoded rgba; lanes whose march
    is done stop running."""
    running &= kind != KIND_DONE
    lanes = torch.nonzero(running & (kind == KIND_COLL)).squeeze(1)
    grid = DeviceGrid(dense=dense, maj_mips=None, extent=torch.tensor(extent, dtype=torch.int32, device=t.device))
    pos = ipos[lanes] + t[lanes, None] * idir[lanes]
    density = scalars[S_DEN_SCALE] * trilinear_sum(grid, pos)
    rgba = lookup_transfer_plain(lut, scalars[S_RANGE_LO:S_RANGE_HI + 1], density * scalars[S_INV_MAJ])
    return lanes, rgba


def dda_collide_sample_plain(dense, extent, scalars, lut, ipos, idir, t, maj, kind, state, tau, mip, running,
                             hit, rgb):
    """Plain PyTorch round over the parked lanes only; see
    `dda_collide_sample`."""
    lanes, rgba = _parked(dense, extent, scalars, lut, ipos, idir, t, kind, running)
    d = scalars[S_VOL_MAJ] * rgba[:, 3]
    st, xi1 = rng(state[lanes])
    real = xi1 * maj[lanes] < d
    st, xi2 = rng_where(~real, st)
    state[lanes] = st
    tau[lanes] = torch.where(real, tau[lanes], -torch.log(1.0 - xi2))
    mip[lanes] = torch.where(real, mip[lanes], torch.clamp_min(mip[lanes] - MIP_SPEED_DOWN, 0.0))
    hit_lanes = lanes[real]
    rgb[hit_lanes] = rgba[real, :3]
    hit[hit_lanes] = True
    running[hit_lanes] = False
    return state, tau, mip, running, hit, rgb


def dda_collide_shadow_plain(dense, extent, scalars, lut, ipos, idir, t, maj, kind, state, tau, mip, running, tr,
                             physical: bool = False):
    """Plain PyTorch round over the parked lanes only; see
    `dda_collide_shadow`."""
    lanes, rgba = _parked(dense, extent, scalars, lut, ipos, idir, t, kind, running)
    vol_maj = scalars[S_VOL_MAJ]
    d = vol_maj * rgba[:, 3]
    maj_l = maj[lanes]
    st, xi1 = rng(state[lanes])
    real = xi1 * maj_l < d
    if physical:
        ratio = torch.clamp_min(1.0 - d / torch.clamp_min(maj_l, 1e-20), 0.0)
    else:
        ratio = torch.clamp_min(1.0 - vol_maj / torch.clamp_min(maj_l, 1e-20), 0.0)
    tr_l = tr[lanes]
    tr_new = torch.where(real, tr_l * ratio, tr_l)
    # russian roulette only when a real collision dropped Tr below the
    # threshold (dda.glsl:50-54); a killed lane returns before the tau redraw
    rr_active = real & (tr_new < 0.1)
    st, xi_rr = rng_where(rr_active, st)
    killed = rr_active & (xi_rr < (1.0 - tr_new))
    tr_new = torch.where(rr_active & ~killed, tr_new / torch.clamp_min(tr_new, 1e-20), tr_new)
    tr[lanes] = torch.where(killed, 0.0, tr_new)
    st, xi2 = rng_where(~killed, st)
    state[lanes] = st
    tau[lanes] = -torch.log(1.0 - xi2)
    mip[lanes] = torch.clamp_min(mip[lanes] - MIP_SPEED_DOWN, 0.0)
    running[lanes[killed]] = False
    return state, tau, mip, running, tr


def _launch(name, dense, extent, scalars, lut, ipos, idir, t, maj, kind, state, tau, mip, running, outputs,
            *flags):
    """Check a round's operands (device, type, shape, contiguity) and launch
    csrc/dda_collide.cu's vx_<name>; `outputs` are the leg's in-place
    outputs (hit and rgb, or tr) and `flags` its int arguments."""
    ex, ey, ez = _check_dense(name, dense, extent)
    dev = dense.device
    f32 = [a for a in (scalars, lut, ipos, idir, t, maj, tau, mip, *outputs) if a.dtype != torch.bool]
    kernels.require_cuda(name, *f32, dtype=torch.float32, device=dev)
    kernels.require_cuda(name, running, *(a for a in outputs if a.dtype == torch.bool), dtype=torch.bool, device=dev)
    kernels.require_cuda(name, kind, dtype=torch.int32, device=dev)
    kernels.require_cuda(name, state, dtype=torch.int64, device=dev)
    n = t.shape[0]
    _check_lanes(name, n, [("ipos", ipos), ("idir", idir)] + [("rgb", a) for a in outputs if a.dim() == 2],
                 [("t", t), ("maj", maj), ("kind", kind), ("tau", tau), ("mip", mip), ("running", running)]
                 + [("output", a) for a in outputs if a.dim() == 1])
    if tuple(state.shape) != (n, 4):
        raise ValueError(f"{name}: state must be ({n}, 4), got {tuple(state.shape)}")
    if lut.dim() != 2 or lut.shape[1] != 4 or lut.shape[0] < 1:
        raise ValueError(f"{name}: lut must be (K, 4), got {tuple(lut.shape)}")
    if lut.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads 16-byte LUT rows; lut is misaligned")
    if tuple(scalars.shape) != (S_RANGE_HI + 1,):
        raise ValueError(f"{name}: scalars must be ({S_RANGE_HI + 1},), got {tuple(scalars.shape)}")
    _, ny, nx = dense.shape
    pointers = [a.data_ptr() for a in (ipos, idir, t, maj, kind, state, tau, mip, running, *outputs)]
    code = getattr(kernels.lib(), f"vx_{name}")(
        dense.data_ptr(), ny, nx, ex, ey, ez, lut.data_ptr(), lut.shape[0], scalars.data_ptr(), *pointers, *flags,
        n, kernels.stream_of(t),
    )
    kernels.check(f"vx_{name}", code)
    kernels.LAUNCHES[name] += 1


def dda_collide_sample_cuda(dense, extent, scalars, lut, ipos, idir, t, maj, kind, state, tau, mip, running, hit,
                            rgb):
    """The round as one launch of csrc/dda_collide.cu; see
    `dda_collide_sample`."""
    _launch("dda_collide_sample", dense, extent, scalars, lut, ipos, idir, t, maj, kind, state, tau, mip, running,
            (hit, rgb))
    return state, tau, mip, running, hit, rgb


def dda_collide_shadow_cuda(dense, extent, scalars, lut, ipos, idir, t, maj, kind, state, tau, mip, running, tr,
                            physical: bool = False):
    """The round as one launch of csrc/dda_collide.cu; see
    `dda_collide_shadow`."""
    _launch("dda_collide_shadow", dense, extent, scalars, lut, ipos, idir, t, maj, kind, state, tau, mip, running,
            (tr,), int(bool(physical)))
    return state, tau, mip, running, tr


def dda_collide_sample(
    dense,  # (Z, Y, X) bf16 decoded density
    extent,  # (ex, ey, ez) ints: the volume's index extent
    scalars,  # (5,) f32 on the device: tilemarch.volume_scalars(params)
    lut,  # (K, 4) f32 transfer LUT
    ipos, idir,  # (n, 3) f32 index-space rays
    t, maj, kind,  # (n,) pyr_march's t, majorant at the collision step and KIND_*
    state,  # (n, 4) int64 xoshiro words, updated in place
    tau, mip,  # (n,) f32 march state, updated in place
    running, hit,  # (n,) bool, updated in place
    rgb,  # (n, 3) f32, updated in place
):
    """One collision round of the camera leg (sample_volume_dda). Returns
    (state, tau, mip, running, hit, rgb), the tensors it was given. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    args = (dense, extent, scalars, lut, ipos, idir, t, maj, kind, state, tau, mip, running, hit, rgb)
    if t.device.type == "cpu":
        return dda_collide_sample_plain(*args)
    return dda_collide_sample_cuda(*args)


def dda_collide_shadow(dense, extent, scalars, lut, ipos, idir, t, maj, kind, state, tau, mip, running, tr,
                       physical: bool = False):
    """One collision round of the shadow leg (transmittance_dda); `tr`
    (n,) f32 is updated in place, the other arguments are those of
    `dda_collide_sample`. Returns (state, tau, mip, running, tr). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    args = (dense, extent, scalars, lut, ipos, idir, t, maj, kind, state, tau, mip, running, tr, physical)
    if t.device.type == "cpu":
        return dda_collide_shadow_plain(*args)
    return dda_collide_shadow_cuda(*args)


def neg_log1m_cuda(xi: torch.Tensor) -> torch.Tensor:
    """-log(1 - xi) as the collision kernels compute it on the card (one
    launch of csrc/dda_collide.cu's check kernel, on no render path and
    counted nowhere), to hold against -torch.log(1.0 - xi)."""
    kernels.require_cuda("neg_log1m", xi, dtype=torch.float32)
    out = torch.empty_like(xi)
    code = kernels.lib().vx_neg_log1m(xi.data_ptr(), out.data_ptr(), xi.numel(), kernels.stream_of(xi))
    kernels.check("vx_neg_log1m", code)
    return out
