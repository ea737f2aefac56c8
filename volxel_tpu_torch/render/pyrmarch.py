"""Pyramid march: the default mode's DDA null-collision march, as one
hand-written CUDA kernel on the card beside its plain PyTorch version.

Counterpart of volxel_tpu.render.pyrmarch.pyr_march (dda.glsl:65-98 /
modes._sample_compact_loop's march arm). Each running lane marches from
(t, tau, mip) over the premultiplied 4-level majorant pyramid: one
majorant fetch per step, the DDA step to the next brick boundary at the
traced mip, tau -= majorant * dt and mip += 0.25. It stops at its first
collision candidate (tau exhausted), at escape past `far`, or when its
per-lane step budget runs out, and PARKS there. The caller
(modes.sample_volume_dda / transmittance_dda) decodes the density and
draws the random numbers for parked lanes in PyTorch and re-enters the
march, so every draw stays where the GLSL makes it.

The kernel (csrc/pyr_march.cu) is one thread per ray and reads the
stacked f32 pyramid (4 MiB at 512^3) directly; the JAX package's int8
byte planes exist only for the TPU's matrix unit. Its f32 operations are
those of `pyr_march_plain`, one rounding each (built with --fmad=false),
so on the card the two agree bit for bit on every output.
"""

from __future__ import annotations

import torch

from volxel_tpu_torch import kernels

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
    """Plain PyTorch march over all lanes in lockstep under a mask; see
    `pyr_march` for the arguments."""
    from volxel_tpu_torch.render.sampling import DeviceGrid, lookup_majorant_premul

    grid = DeviceGrid(
        dense=None, maj_mips=None, maj_alpha=maj_alpha,
        extent=torch.tensor(extent, dtype=torch.int32, device=t.device),
    )
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


def pyr_march_cuda(maj_alpha, extent, ipos, idir, ri, t, tau, mip, far, budget, running, steps_cap: int):
    """The march as one launch of csrc/pyr_march.cu; see `pyr_march`."""
    f32 = (maj_alpha, ipos, idir, ri, t, tau, mip, far)
    kernels.require_cuda("pyr_march", *f32, dtype=torch.float32)
    kernels.require_cuda("pyr_march", budget, dtype=torch.int32, device=t.device)
    kernels.require_cuda("pyr_march", running, dtype=torch.bool, device=t.device)
    n = t.shape[0]
    if maj_alpha.dim() != 4 or maj_alpha.shape[0] != 4:
        raise ValueError(f"pyr_march: expected a (4, bz, by, bx) pyramid, got {tuple(maj_alpha.shape)}")
    for name, a in (("ipos", ipos), ("idir", idir), ("ri", ri)):
        if tuple(a.shape) != (n, 3):
            raise ValueError(f"pyr_march: {name} must be ({n}, 3), got {tuple(a.shape)}")
    for name, a in (("tau", tau), ("mip", mip), ("far", far), ("budget", budget), ("running", running)):
        if tuple(a.shape) != (n,):
            raise ValueError(f"pyr_march: {name} must be ({n},), got {tuple(a.shape)}")
    _, bz, by, bx = maj_alpha.shape
    ex, ey, ez = (int(v) for v in extent)
    out = [torch.empty_like(t) for _ in range(4)] + [torch.empty_like(budget), torch.empty_like(budget)]
    t_o, tau_o, mip_o, maj_o, kind_o, budget_o = out
    code = kernels.lib().vx_pyr_march(
        maj_alpha.data_ptr(), bz, by, bx, ex, ey, ez,
        ipos.data_ptr(), idir.data_ptr(), ri.data_ptr(),
        t.data_ptr(), tau.data_ptr(), mip.data_ptr(), far.data_ptr(),
        budget.data_ptr(), running.data_ptr(),
        t_o.data_ptr(), tau_o.data_ptr(), mip_o.data_ptr(), maj_o.data_ptr(),
        kind_o.data_ptr(), budget_o.data_ptr(),
        n, int(steps_cap) + 2, kernels.stream_of(t),
    )
    kernels.check("vx_pyr_march", code)
    kernels.LAUNCHES["pyr_march"] += 1
    return t_o, tau_o, mip_o, maj_o, kind_o, budget_o


def pyr_march(
    maj_alpha,  # (4, bz, by, bx) f32 — modes.build_premul_majorant
    extent,  # (ex, ey, ez) ints: the volume's index extent
    ipos, idir, ri,  # (n, 3) f32 index-space rays + the caller's 1/idir
    t, tau, mip,  # (n,) f32 march state
    far,  # (n,) f32
    budget,  # (n,) int32 remaining per-lane steps
    running,  # (n,) bool
    steps_cap: int,
):
    """March every running lane to its next collision candidate (or
    escape / budget exhaustion). Returns (t, tau, mip, majorant, kind,
    budget) per lane; `majorant` is the fetch at the collision step (0
    elsewhere), `kind` one of KIND_*. The caller's 1/idir comes in as
    `ri`, so kernel and PyTorch share the quotient bits."""
    if t.device.type == "cpu":
        return pyr_march_plain(maj_alpha, extent, ipos, idir, ri, t, tau, mip, far, budget, running, steps_cap)
    return pyr_march_cuda(maj_alpha, extent, ipos, idir, ri, t, tau, mip, far, budget, running, steps_cap)
