"""Volume traversal for the default render mode: DDA null-collision
tracking over the majorant pyramid (shaders/sampling/dda.glsl).

PyTorch counterpart of the default-mode functions of
volxel_tpu.render.modes, with the structure of its sample_volume_dda_pyr /
transmittance_dda_pyr: the march runs in render.pyrmarch.pyr_march (a CUDA
kernel on the card), which parks every lane at its next collision
candidate; the density decode and every random draw run here, on the
parked lanes only, and the loop re-enters the march while any lane runs.
Each lane has its own step budget (dda.glsl's per-pixel loop cap).

Function contracts:
  sample_volume(grid, params, lut, origin, direction, state, active)
    -> (state, hit, t, rgb, Le_add)
  transmittance(grid, params, lut, origin, direction, state, active)
    -> (state, Tr)
with origin/direction in world space and state the per-ray RNG state.
Draw consumption is reference-exact per lane: inactive or box-missing lanes
consume nothing, the real/null draw happens only at live collisions, the
tau redraw only where the GLSL makes it, RR only under its threshold.
"""

from __future__ import annotations

import functools

import torch

from volxel_tpu_torch.render.pyrmarch import KIND_COLL, KIND_DONE, _round_mip, _step_dda, pyr_march  # noqa: F401
from volxel_tpu_torch.render.rays import Rays, ray_box_intersection
from volxel_tpu_torch.render.rng import rng, rng_where
from volxel_tpu_torch.render.sampling import (
    VolumeParams,
    lookup_density_trilinear,
    lookup_transfer,
    world_to_index_dir,
    world_to_index_point,
)

# per-lane step caps
DDA_SAMPLE_MAX_STEPS = 1024
DDA_TRANSMITTANCE_MAX_STEPS = 100  # dda.glsl:18

# adaptive mip schedule (dda.glsl:6-8)
MIP_START = 3.0
MIP_SPEED_UP = 0.25
MIP_SPEED_DOWN = 2.0


def _to_index_space(params: VolumeParams, origin, direction):
    ipos = world_to_index_point(params, origin)
    idir = world_to_index_dir(params, direction)  # non-normalized, like the GL
    return ipos, idir


def _majorant_alpha(lut, sample_range, norm_density, envelope: bool):
    """Alpha factor for the brick majorant.

    envelope=False: the reference's rule — transfer(max_density).alpha
    (dda.glsl:36), which can underestimate the bound for a non-monotone
    transfer alpha. envelope=True (physical_majorant): prefix-max of the
    range-masked LUT alpha, a true upper bound of alpha(d) for every
    d <= max_density.
    """
    if not envelope:
        return lookup_transfer(lut, sample_range, norm_density)[..., 3]
    k = lut.shape[0]
    edges = torch.arange(k, dtype=torch.float32, device=lut.device) / k
    overlap = (edges + 1.0 / k > sample_range[0]) & (edges <= sample_range[1])
    env = torch.cummax(torch.where(overlap, lut[:, 3], 0.0), dim=0).values
    idx = torch.clamp(torch.floor(norm_density * k).to(torch.int64), 0, k - 1)
    return torch.where(norm_density < sample_range[0], 0.0, env[idx])


def build_premul_majorant(maj_mips, params, lut, majorant_envelope: bool = False):
    """The fully-scaled DDA step majorant over the whole stacked pyramid:
    vol_maj * transfer_alpha(density_scale * maj_mips * inv_maj). The march
    then reads its per-step majorant with one fetch. Rebuilt per render
    (~1M elementwise ops at 512^3)."""
    maj_density = params.density_scale * maj_mips
    return params.vol_maj * _majorant_alpha(
        lut, params.sample_range, maj_density * params.inv_maj, majorant_envelope
    )


def _decode_rgba(grid, params, lut, pos):
    """Collision-point density decode: trilinear + transfer LUT
    (dda.glsl:81-83)."""
    return lookup_transfer(
        lut, params.sample_range, lookup_density_trilinear(grid, params, pos) * params.inv_maj
    )


def _march_setup(grid, params, origin, direction, state, active):
    """Box test, index-space rays, the first tau draw (dda.glsl:23-31,
    :76-77): box-missing or inactive lanes consume nothing."""
    hit_box, near, far = ray_box_intersection(Rays(origin, direction), params.aabb_lo, params.aabb_hi)
    ipos, idir = _to_index_space(params, origin, direction)
    ri = 1.0 / idir
    state, xi = rng_where(active & hit_box, state)
    t = near + 1e-6
    tau = -torch.log(1.0 - xi)
    running = active & hit_box & (t < far)
    mip = torch.full_like(t, MIP_START)
    extent = tuple(int(v) for v in grid.extent.tolist())
    return state, ipos, idir, ri, far, t, tau, mip, running, extent


def sample_volume_dda(grid, params, lut, origin, direction, state, active):
    """DDA distance sampling (dda.glsl:65-98) over grid.maj_alpha, the
    premultiplied pyramid (build_premul_majorant)."""
    state, ipos, idir, ri, far, t, tau, mip, running, extent = _march_setup(
        grid, params, origin, direction, state, active
    )
    n = origin.shape[0]
    hit = torch.zeros_like(running)
    rgb = torch.ones((n, 3), dtype=torch.float32, device=origin.device)
    budget = torch.full((n,), DDA_SAMPLE_MAX_STEPS, dtype=torch.int32, device=origin.device)
    while bool(running.any()):
        t, tau, mip, maj, kind, budget = pyr_march(
            grid.maj_alpha, extent, ipos, idir, ri, t, tau, mip, far, budget, running,
            DDA_SAMPLE_MAX_STEPS,
        )
        done = running & (kind == KIND_DONE)
        lanes = torch.nonzero(running & (kind == KIND_COLL)).squeeze(1)
        if lanes.numel():
            # decode + draws on the parked lanes only (dda.glsl:81-96): the
            # real/null draw at every live collision, the tau redraw only at
            # a null one (a real collision returns before it)
            pos = ipos[lanes] + t[lanes, None] * idir[lanes]
            rgba = _decode_rgba(grid, params, lut, pos)
            d = params.vol_maj * rgba[:, 3]
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
        running = running & ~done
    le_add = torch.zeros((n, 3), dtype=torch.float32, device=origin.device)  # emission stub
    return state, hit, t, rgb, le_add


def transmittance_dda(grid, params, lut, origin, direction, state, active, physical: bool = False):
    """Ratio-tracking shadow transmittance (dda.glsl:21-62 draw protocol:
    real collisions keep marching with a redrawn tau; RR under 0.1).

    physical=False keeps the reference quirk Tr *= max(0, 1 - global/local)
    (dda.glsl:48), which makes real collisions opaque; physical=True is
    proper ratio tracking, Tr *= 1 - density/local."""
    state, ipos, idir, ri, far, t, tau, mip, running, extent = _march_setup(
        grid, params, origin, direction, state, active
    )
    n = origin.shape[0]
    tr = torch.ones((n,), dtype=torch.float32, device=origin.device)
    budget = torch.full((n,), DDA_TRANSMITTANCE_MAX_STEPS, dtype=torch.int32, device=origin.device)
    while bool(running.any()):
        t, tau, mip, maj, kind, budget = pyr_march(
            grid.maj_alpha, extent, ipos, idir, ri, t, tau, mip, far, budget, running,
            DDA_TRANSMITTANCE_MAX_STEPS,
        )
        done = running & (kind == KIND_DONE)
        lanes = torch.nonzero(running & (kind == KIND_COLL)).squeeze(1)
        if lanes.numel():
            pos = ipos[lanes] + t[lanes, None] * idir[lanes]
            rgba = _decode_rgba(grid, params, lut, pos)
            d = params.vol_maj * rgba[:, 3]
            maj_l = maj[lanes]
            st, xi1 = rng(state[lanes])
            real = xi1 * maj_l < d
            if physical:
                ratio = torch.clamp_min(1.0 - d / torch.clamp_min(maj_l, 1e-20), 0.0)
            else:
                ratio = torch.clamp_min(1.0 - params.vol_maj / torch.clamp_min(maj_l, 1e-20), 0.0)
            tr_l = tr[lanes]
            tr_new = torch.where(real, tr_l * ratio, tr_l)
            # russian roulette only when a real collision dropped Tr below
            # the threshold (dda.glsl:50-54); a killed lane returns before
            # the tau redraw
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
        running = running & ~done
    return state, tr


def get_mode_functions(mode: str, physical_shadows: bool = False):
    """(sample_volume, transmittance) for a render mode. physical_shadows
    selects proper ratio tracking for the shadow transmittance. The other
    default-mode option, physical_majorant, lives in the premultiplied
    pyramid the march reads (build_premul_majorant's envelope)."""
    if mode in ("no_dda", "raymarch"):
        raise NotImplementedError(
            f"render mode {mode!r} is not ported yet (ROADMAP.md, queue 1: other modes)"
        )
    if mode != "default":
        raise ValueError(f"unknown render mode: {mode!r}")
    if physical_shadows:
        return sample_volume_dda, functools.partial(transmittance_dda, physical=True)
    return sample_volume_dda, transmittance_dda
