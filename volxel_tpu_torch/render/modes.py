"""Volume traversal for the three render modes (shaders/sampling/).

PyTorch counterpart of volxel_tpu.render.modes:

  default (dda.glsl): DDA null-collision tracking over the majorant
    pyramid, with the structure of the JAX package's sample_volume_dda_pyr
    / transmittance_dda_pyr. After the setup here, each leg is one call of
    render.ddaleg (one CUDA kernel on the card): every lane marches to its
    next collision candidate, decodes and draws there, and marches on until
    it ends. Each lane has its own step budget (dda.glsl's per-pixel loop
    cap).
  no_dda (normal.glsl): delta tracking and ratio tracking against the
    global majorant. After the box test and the first free flight here,
    each leg is one call of render.trackleg (one CUDA kernel on the card):
    every lane decodes and draws at each event until it ends.
  raymarch (raymarch.glsl): 64 fixed steps with the stochastic tricubic
    filter. The camera leg's step loop runs in
    render.tilemarch.tile_march_sample (a CUDA kernel on the card) after a
    PyTorch prologue, the shadow leg's in tile_march_transmittance (another).

The legs read `grid.field`: the dense field of a DeviceGrid or the slabs
of a SlabGrid (render-time volume slabs, parallel.volshard), whose kernels
read each tap from the slab that owns it. On a 'vz' row across nodes, where
the SlabGrid's slabs on other nodes are absent, each leg goes through the
grid's `row` (parallel.migrate.Row): its park form, with the lanes that
park moved to the processes that own their slabs. The JAX package's compaction
ladders and compacted decodes are TPU workarounds and are not ported. The camera and shadow legs of the default
and no_dda modes take `with_stats` (utils.stepstats): it appends each
lane's march steps or events, which the legs already return as the budget
or events left of their cap.

Function contracts:
  sample_volume(grid, params, lut, origin, direction, state, active)
    -> (state, hit, t, rgb, Le_add)   [+ steps with with_stats]
  transmittance(grid, params, lut, origin, direction, state, active)
    -> (state, Tr)                    [+ steps with with_stats]
with origin/direction in world space and state the per-ray RNG state.
Draw consumption is reference-exact per lane: inactive or box-missing lanes
consume nothing, and every other draw happens only where the GLSL makes it.
"""

from __future__ import annotations

import functools

import torch

from volxel_tpu_torch.render.ddaleg import (
    DDA_SAMPLE_MAX_STEPS,
    DDA_TRANSMITTANCE_MAX_STEPS,
    dda_leg_sample,
    dda_leg_shadow,
)
from volxel_tpu_torch.render.rays import Rays, ray_box_intersection
from volxel_tpu_torch.render.rng import rng_where
from volxel_tpu_torch.render.sampling import (
    VolumeParams,
    lookup_transfer,
    world_to_index_dir,
    world_to_index_point,
)
from volxel_tpu_torch.render.tilemarch import STEPS as RAYMARCH_STEPS
from volxel_tpu_torch.render.tilemarch import (
    slab_form,
    tile_march_sample,
    tile_march_transmittance,
    volume_scalars,
)
from volxel_tpu_torch.render.trackleg import TRACKING_MAX_EVENTS, track_leg_sample, track_leg_shadow
from volxel_tpu_torch.utils.profiling import count, span

# adaptive mip schedule (dda.glsl:6-8)
MIP_START = 3.0
MIP_SPEED_UP = 0.25


# the legs whose outputs hold each lane's work left of a cap: (its index
# in the outputs, the cap); the raymarch legs return no per-lane count
_LEFT = {"dda_leg_sample": (4, DDA_SAMPLE_MAX_STEPS), "dda_leg_shadow": (2, DDA_TRANSMITTANCE_MAX_STEPS),
         "track_leg_sample": (4, TRACKING_MAX_EVENTS), "track_leg_shadow": (2, TRACKING_MAX_EVENTS)}


def _leg(name: str, leg, field, *args):
    """`leg` (the function this module calls leg `name` by) on `field` and
    its other arguments; on a SlabGrid of a 'vz' row across nodes, whose
    slabs on other nodes are absent, through the row the grid carries
    (parallel.migrate.Row.leg_call), which runs the leg's park form and
    moves the lanes that park to the slabs' owners.

    The call is the span vx::leg. While spans are on, the DDA and tracking
    legs' budget or events left is counted (utils.profiling.count) under
    the leg's launch counter: `name`, `name`_slabs or `name`_slabs_park;
    the raymarch legs' calls are not counted."""
    row = getattr(field, "row", None)
    with span("vx::leg", leg=name):
        out = leg(field, *args) if row is None else row.leg_call(name, field, *args)
    left = _LEFT.get(name)
    if left is not None:
        count(slab_form(name, field) if row is None else name + "_slabs_park", out[left[0]], left[1])
    return out


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
    return state, ipos, idir, ri, far, t, tau, mip, running


def sample_volume_dda(grid, params, lut, origin, direction, state, active, with_stats: bool = False):
    """DDA distance sampling (dda.glsl:65-98) over grid.maj_alpha, the
    premultiplied pyramid (build_premul_majorant): the setup, then the leg
    (ddaleg.dda_leg_sample). with_stats adds each lane's march steps."""
    state, ipos, idir, ri, far, t, tau, mip, running = _march_setup(grid, params, origin, direction, state, active)
    state, hit, t, rgb, budget = _leg("dda_leg_sample", dda_leg_sample, grid.field, grid.maj_alpha, grid.extent,
                                      volume_scalars(params), lut, ipos, idir, ri, far, t, tau, mip, state, running)
    le_add = torch.zeros((origin.shape[0], 3), dtype=torch.float32, device=origin.device)  # emission stub
    if with_stats:
        return state, hit, t, rgb, le_add, DDA_SAMPLE_MAX_STEPS - budget
    return state, hit, t, rgb, le_add


def transmittance_dda(grid, params, lut, origin, direction, state, active, physical: bool = False,
                      with_stats: bool = False):
    """Ratio-tracking shadow transmittance (dda.glsl:21-62 draw protocol:
    real collisions keep marching with a redrawn tau; RR under 0.1): the
    setup, then the leg (ddaleg.dda_leg_shadow).

    physical=False keeps the reference quirk Tr *= max(0, 1 - global/local)
    (dda.glsl:48), which makes real collisions opaque; physical=True is
    proper ratio tracking, Tr *= 1 - density/local. with_stats adds each
    lane's march steps."""
    state, ipos, idir, ri, far, t, tau, mip, running = _march_setup(grid, params, origin, direction, state, active)
    tr = torch.ones((origin.shape[0],), dtype=torch.float32, device=origin.device)
    state, tr, budget = _leg("dda_leg_shadow", dda_leg_shadow, grid.field, grid.maj_alpha, grid.extent,
                             volume_scalars(params), lut, ipos, idir, ri, far, t, tau, mip, state, running, tr, physical)
    if with_stats:
        return state, tr, DDA_TRANSMITTANCE_MAX_STEPS - budget
    return state, tr


# ---------------------------------------------------------------------------
# Delta / ratio tracking (no_dda mode): normal.glsl
# ---------------------------------------------------------------------------


def _tracking_setup(params, origin, direction, state, active):
    """Box test, index-space rays and the first free flight (normal.glsl:14,
    :40): box-missing or inactive lanes consume nothing."""
    hit_box, near, far = ray_box_intersection(Rays(origin, direction), params.aabb_lo, params.aabb_hi)
    ipos, idir = _to_index_space(params, origin, direction)
    state, xi = rng_where(active & hit_box, state)
    t = near - torch.log(1.0 - xi) * params.inv_maj
    running = active & hit_box & (t < far)
    return state, ipos, idir, far, t, running


def sample_volume_simple(grid, params, lut, origin, direction, state, active, with_stats: bool = False):
    """Delta tracking (normal.glsl:36-55) against the global majorant: the
    setup, then the leg (trackleg.track_leg_sample). Each event decodes the
    lane's point (trilinear density, LUT) and draws the real/null test, and
    at a null collision the next free flight; a real one ends the lane. At
    most trackleg.TRACKING_MAX_EVENTS events a lane. with_stats adds each
    lane's events."""
    state, ipos, idir, far, t, running = _tracking_setup(params, origin, direction, state, active)
    state, hit, t, rgb, left = _leg("track_leg_sample", track_leg_sample, grid.field, grid.extent,
                                    volume_scalars(params), lut, ipos, idir, far, t, state, running)
    le_add = torch.zeros((origin.shape[0], 3), dtype=torch.float32, device=origin.device)  # emission stub
    if with_stats:
        return state, hit, t, rgb, le_add, TRACKING_MAX_EVENTS - left
    return state, hit, t, rgb, le_add


def transmittance_simple(grid, params, lut, origin, direction, state, active, with_stats: bool = False):
    """Ratio tracking (normal.glsl:8-33): the setup, then the leg
    (trackleg.track_leg_shadow). Tr *= 1 - density / majorant at every
    event; russian roulette below 0.1, whose killed lanes end before the
    free-flight draw. with_stats adds each lane's events."""
    state, ipos, idir, far, t, running = _tracking_setup(params, origin, direction, state, active)
    tr = torch.ones((origin.shape[0],), dtype=torch.float32, device=origin.device)
    state, tr, left = _leg("track_leg_shadow", track_leg_shadow, grid.field, grid.extent, volume_scalars(params), lut,
                           ipos, idir, far, t, state, running, tr)
    if with_stats:
        return state, tr, TRACKING_MAX_EVENTS - left
    return state, tr


# ---------------------------------------------------------------------------
# Fixed-step ray marching (raymarch mode): raymarch.glsl
# ---------------------------------------------------------------------------


def _raymarch_setup(params, origin, direction, active):
    hit_box, near, far = ray_box_intersection(Rays(origin, direction), params.aabb_lo, params.aabb_hi)
    ipos, idir = _to_index_space(params, origin, direction)
    return ipos, idir, near, far, (far - near) / RAYMARCH_STEPS, active & hit_box


def raymarch_prologue(grid, params, lut, origin, direction, state, active):
    """The camera leg before its step loop (raymarch.glsl:30-40): the box
    test, then the tau target and the start jitter, drawn on the lanes
    inside the box only. Returns tilemarch.tile_march_sample's arguments."""
    ipos, idir, near, far, dt, valid = _raymarch_setup(params, origin, direction, active)
    state, xi_tau = rng_where(valid, state)
    tau_target = -torch.log(1.0 - xi_tau)
    state, xi_j = rng_where(valid, state)
    start = near + xi_j * dt
    return (grid.field, ipos, idir, start, dt, far, valid, tau_target, state, lut, volume_scalars(params),
            grid.extent)


def sample_volume_raymarch(grid, params, lut, origin, direction, state, active):
    """Stochastic-filter fixed-step raymarch (raymarch.glsl:30-56): the
    prologue in PyTorch, then the step loop in tilemarch.tile_march_sample,
    a kernel on the card at every bounce."""
    state, hit, t, rgb = _leg("tile_march_sample", tile_march_sample,
                              *raymarch_prologue(grid, params, lut, origin, direction, state, active))
    le_add = torch.zeros((origin.shape[0], 3), dtype=torch.float32, device=origin.device)  # emission stub
    return state, hit, t, rgb, le_add


def transmittance_raymarch(grid, params, lut, origin, direction, state, active):
    """Raymarched shadow transmittance (raymarch.glsl:8-23): the box test
    and the start jitter here, then every lane inside the box takes all
    RAYMARCH_STEPS steps and their draws (no early out) in
    tilemarch.tile_march_transmittance, a kernel on the card; Tr =
    exp(-tau), 1 outside the box."""
    ipos, idir, near, far, dt, valid = _raymarch_setup(params, origin, direction, active)
    state, xi_j = rng_where(valid, state)  # raymarch.glsl:17
    start = near + xi_j * dt
    state, tau = _leg("tile_march_transmittance", tile_march_transmittance, grid.field, ipos, idir, start, dt, far,
                      valid, state, lut, volume_scalars(params), grid.extent)
    return state, torch.exp(-tau)


def get_mode_functions(mode: str, physical_shadows: bool = False):
    """(sample_volume, transmittance) for a render mode. physical_shadows
    selects proper ratio tracking for the default mode's shadow
    transmittance; the other default-mode option, physical_majorant, lives
    in the premultiplied pyramid the march reads (build_premul_majorant's
    envelope). Both are default-mode only, as in the JAX package: the other
    modes use the global majorant."""
    if mode == "no_dda":
        return sample_volume_simple, transmittance_simple
    if mode == "raymarch":
        return sample_volume_raymarch, transmittance_raymarch
    if mode != "default":
        raise ValueError(f"unknown render mode: {mode!r}")
    if physical_shadows:
        return sample_volume_dda, functools.partial(transmittance_dda, physical=True)
    return sample_volume_dda, transmittance_dda
