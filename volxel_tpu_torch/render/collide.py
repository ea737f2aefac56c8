"""DDA collision step: the default mode's decode and draws at the lanes the
march parked, one round over all lanes, in plain PyTorch.

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
Every other lane is left as it is. Both rounds update state, tau, mip,
running and the leg's outputs (hit and rgb, or tr) IN PLACE and return
them. Rounds of pyr_march_plain and these are the plain version of the
default legs (render.ddaleg), whose kernel (csrc/dda_leg.cu) runs the
march and the collision in one thread per lane until the lane ends.

Arguments: dense (Z, Y, X) bf16 decoded density, or a SlabGrid whose
slabs hold it (sampling.field_grid); extent the volume's
(ex, ey, ez) index extent; scalars (5,) f32, tilemarch.volume_scalars;
lut (K, 4) f32; ipos, idir (n, 3) f32 index-space rays; t, maj, kind
(n,) pyr_march_plain's t, majorant at the collision step and KIND_*;
state (n, 4) int64 xoshiro words; tau, mip (n,) f32; running, hit (n,)
bool; rgb (n, 3) f32; tr (n,) f32.
"""

from __future__ import annotations

import torch

from volxel_tpu_torch.render.gather import lookup_transfer_plain
from volxel_tpu_torch.render.pyrmarch import KIND_COLL, KIND_DONE
from volxel_tpu_torch.render.rng import rng, rng_where
from volxel_tpu_torch.render.sampling import field_grid, trilinear_sum
from volxel_tpu_torch.render.tilemarch import S_DEN_SCALE, S_INV_MAJ, S_RANGE_HI, S_RANGE_LO, S_VOL_MAJ

MIP_SPEED_DOWN = 2.0  # dda.glsl:8


def _parked(dense, extent, scalars, lut, ipos, idir, t, kind, running):
    """The parked lanes' indices and their decoded rgba; lanes whose march
    is done stop running."""
    running &= kind != KIND_DONE
    lanes = torch.nonzero(running & (kind == KIND_COLL)).squeeze(1)
    grid = field_grid(dense, extent)
    pos = ipos[lanes] + t[lanes, None] * idir[lanes]
    density = scalars[S_DEN_SCALE] * trilinear_sum(grid, pos)
    rgba = lookup_transfer_plain(lut, scalars[S_RANGE_LO:S_RANGE_HI + 1], density * scalars[S_INV_MAJ])
    return lanes, rgba


def dda_collide_sample_plain(dense, extent, scalars, lut, ipos, idir, t, maj, kind, state, tau, mip, running,
                             hit, rgb):
    """One collision round of the camera leg over the parked lanes only: a
    real collision ends the lane (hit, the LUT colour), a null one redraws
    tau and steps the mip down. Returns (state, tau, mip, running, hit,
    rgb), the tensors it was given."""
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
    """One collision round of the shadow leg over the parked lanes only:
    the ratio at a real collision, russian roulette under 0.1, the tau
    redraw and the mip step-down. Returns (state, tau, mip, running, tr),
    the tensors it was given."""
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
