"""Pyramid march: the default mode's DDA null-collision march, in plain
PyTorch.

Counterpart of volxel_tpu.render.pyrmarch.pyr_march (dda.glsl:65-98 /
modes._sample_compact_loop's march arm). Each running lane marches from
(t, tau, mip) over the premultiplied 4-level majorant pyramid: one
majorant fetch per step, the DDA step to the next brick boundary at the
traced mip, tau -= majorant * dt and mip += 0.25. It stops at its first
collision candidate (tau exhausted), at escape past `far`, or when its
per-lane step budget runs out, and PARKS there; render.collide then
decodes and draws at the parked lanes. Rounds of the two are the plain
version of the default legs (render.ddaleg), whose kernel
(csrc/dda_leg.cu) runs the march and the collision in one thread per lane,
reading the stacked f32 pyramid directly: the JAX package's int8 byte
planes exist only for the TPU's matrix unit.
"""

from __future__ import annotations

import torch

KIND_IDLE = 0  # lane wasn't running
KIND_COLL = 1  # parked at a live collision: decode + draws next
KIND_DONE = 2  # escaped at collision / left the box / budget out

MIP_SPEED_UP = 0.25


def _round_mip(mip):
    return torch.clamp(torch.floor(mip + 0.5).to(torch.int32), 0, 3)


def _step_dda(pos, inv_dir, mip_i):
    """Axis-aligned brick DDA step at a mip level (dda.glsl:10-16)."""
    dim = (8 << mip_i).to(torch.float32)[..., None]
    offs = torch.where(inv_dir >= 0.0, dim + 0.5, -0.5)
    tmax = (torch.floor(pos / dim) * dim + offs - pos) * inv_dir
    return tmax.amin(dim=-1)


def pyr_march_plain(maj_alpha, extent, ipos, idir, ri, t, tau, mip, far, budget, running, steps_cap: int):
    """March every running lane to its next collision candidate (or
    escape / budget exhaustion), all lanes in lockstep under a mask.

    maj_alpha (4, bz, by, bx) f32 is the premultiplied pyramid
    (modes.build_premul_majorant), extent the volume's (ex, ey, ez) index
    extent, ipos / idir / ri (n, 3) f32 the index-space rays and the
    caller's 1/idir, t / tau / mip (n,) f32 the march state, far (n,) f32
    the box exit, budget (n,) int32 each lane's steps left, running (n,)
    bool. Returns (t, tau, mip, majorant, kind, budget) per lane:
    `majorant` is the fetch at the collision step (0 elsewhere), `kind`
    one of KIND_*. The inputs are left as they are."""
    from volxel_tpu_torch.render.sampling import DeviceGrid, lookup_majorant_premul

    grid = DeviceGrid(dense=None, maj_mips=None, maj_alpha=maj_alpha, extent=tuple(extent))
    t, tau, mip, budget = t.clone(), tau.clone(), mip.clone(), budget.clone()
    maj_out = torch.zeros_like(t)
    kind = torch.where(running & (budget <= 0), KIND_DONE, KIND_IDLE).to(torch.int32)
    march = running & (budget > 0)
    k = 0
    while k < steps_cap + 2 and bool(march.any()):
        mip_i = _round_mip(mip)
        curr = ipos + t[:, None] * idir
        maj = lookup_majorant_premul(grid, curr, mip_i)
        dt = _step_dda(curr, ri, mip_i)
        t_new = t + dt
        tau_new = tau - maj * dt
        collided = tau_new <= 0.0
        t_coll = t_new + tau_new / torch.clamp_min(maj, 1e-20)
        escaped = t_coll >= far
        out_far = ~collided & (t_new >= far)

        coll_live = march & collided & ~escaped
        done = march & ((collided & escaped) | out_far)
        cont = march & ~collided & ~out_far

        t = torch.where(march & collided, t_coll, torch.where(march, t_new, t))
        tau = torch.where(march & ~collided, tau_new, tau)
        mip = torch.where(march & ~collided, torch.clamp_max(mip + MIP_SPEED_UP, 3.0), mip)
        budget = torch.where(march, budget - 1, budget)
        maj_out = torch.where(coll_live, maj, maj_out)
        capped = cont & (budget <= 0)
        kind = torch.where(coll_live, KIND_COLL, torch.where(done | capped, KIND_DONE, kind)).to(torch.int32)
        march = cont & (budget > 0)
        k += 1
    return t, tau, mip, maj_out, kind, budget
