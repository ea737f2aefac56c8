"""Wavefront volumetric path tracer (shaders/fragment.frag in PyTorch).

Counterpart of volxel_tpu.render.pathtrace for the three render modes.
One call renders one progressive sample for every pixel: seeds per-ray RNG
from (pixel, frame) exactly like the reference (fragment.frag:143-144),
builds jittered camera rays, and runs trace_path (fragment.frag:79-124) —
NEE with the MIS power heuristic, Henyey-Greenstein scattering, russian
roulette — over the whole ray wavefront with masked lockstep bounces.

Seeds are keyed by the global pixel index, so any subset or order of
pixels renders the same per-pixel values: the JAX package's chunking and
tile permutations (which bound TPU program size) are not needed here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from volxel_tpu_torch.render.modes import build_premul_majorant, get_mode_functions
from volxel_tpu_torch.render.pallas_ops import tonemap_plain
from volxel_tpu_torch.render.rays import (
    Rays,
    camera_rays,
    luma,
    phase_henyey_greenstein,
    power_heuristic,
    ray_box_intersection,
    sample_phase_henyey_greenstein,
    sanitize,
)
from volxel_tpu_torch.render.rng import rng2, rng2_where, rng_where, seed_rays
from volxel_tpu_torch.render.sampling import DeviceGrid, VolumeParams
from volxel_tpu_torch.render.shading import trace_shaded
from volxel_tpu_torch.scene.environment import (
    EnvState,
    background_color,
    lookup_environment_light,
    lookup_environment_pdf,
    pdf_environment,
    sample_environment,
    sample_environment_light,
)
from volxel_tpu_torch.utils.profiling import bounce_span, span


class RenderConfig(NamedTuple):
    """Render configuration (resolution, mode, bounces, lighting options)."""

    width: int
    height: int
    mode: str = "default"  # "default", "no_dda" or "raymarch"
    bounces: int = 3
    show_environment: bool = True
    use_env: bool = True
    debug_hits: bool = False
    hide_envmap: bool = False  # debug hits' background: a checker in place of the map
    gradient_shading: bool = False  # first-hit Blinn-Phong (render.shading)
    # extension: unbiased ratio-tracking shadow transmittance instead of
    # the reference's binary-shadow quirk (modes.transmittance_dda)
    physical_shadows: bool = False
    # extension: true equirect solid-angle env pdf on both MIS sides
    # instead of the reference's 1/(4*pi) texel mass (scene.environment)
    physical_pdf: bool = False
    # extension: prefix-max alpha envelope for the DDA brick majorant
    # (modes._majorant_alpha)
    physical_majorant: bool = False


def trace_path(
    config: RenderConfig,
    grid: DeviceGrid,
    params: VolumeParams,
    lut,
    env: EnvState,
    light_dir,
    origin,
    direction,
    state,
):
    """fragment.frag:79-124 vectorized over the ray wavefront."""
    sample_volume, transmittance = get_mode_functions(config.mode, config.physical_shadows)
    n = origin.shape[0]
    dev = origin.device

    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    n_paths = torch.zeros((n,), dtype=torch.int32, device=dev)
    f_p = torch.zeros((n,), dtype=torch.float32, device=dev)

    for bounce in range(config.bounces):
        # bounces after the first: their own span, and the lanes alive at their start
        with bounce_span(bounce, active):
            with span("vx::sample_leg", bounce=bounce):
                state, hit, t, rgb, le_add = sample_volume(grid, params, lut, origin, direction, state, active)
            hit = hit & active
            miss = active & ~hit
            radiance = radiance + le_add

            # escaped rays: environment contribution with MIS (fragment.frag:117-121)
            if config.show_environment:
                with span("vx::escape"):
                    if config.use_env:
                        le, pdf_esc = lookup_environment_pdf(env, direction, config.physical_pdf)
                    else:
                        le = lookup_environment_light(env, direction, light_dir)
                        pdf_esc = pdf_environment(env, direction, config.physical_pdf)
                    mis = torch.where(n_paths > 0, power_heuristic(f_p, pdf_esc), 1.0)
                    radiance = radiance + torch.where(miss[..., None], throughput * mis[..., None] * le, 0.0)
            active = hit

            # advance to the collision and absorb (fragment.frag:81-84 + mode rgb)
            origin = torch.where(hit[..., None], origin + t[..., None] * direction, origin)
            throughput = torch.where(hit[..., None], throughput * params.albedo * rgb, throughput)

            # next-event estimation toward the environment (fragment.frag:86-98);
            # draws only on lanes that hit, as the GLSL does
            with span("vx::nee"):
                state, xi2 = rng2_where(active, state)
                if config.use_env:
                    le_nee, pdf_nee, w_i = sample_environment(env, xi2, config.physical_pdf)
                else:
                    le_nee, pdf_nee, w_i = sample_environment_light(env, xi2, light_dir)
                valid_nee = active & (pdf_nee > 0.0)
                f_p_nee = phase_henyey_greenstein((-direction * w_i).sum(dim=-1), params.phase_g)
                if config.show_environment:
                    mis_nee = power_heuristic(pdf_nee, f_p_nee)
                else:
                    mis_nee = torch.ones((n,), dtype=torch.float32, device=dev)
                with span("vx::shadow_leg", bounce=bounce):
                    state, tr = transmittance(grid, params, lut, origin, w_i, state, valid_nee)
                radiance = radiance + torch.where(
                    valid_nee[..., None],
                    throughput * (mis_nee * f_p_nee * tr / torch.clamp_min(pdf_nee, 1e-20))[..., None] * le_nee,
                    0.0,
                )
            n_paths = n_paths + active.to(torch.int32)

            # bounce cap (fragment.frag:101)
            active = active & (n_paths < config.bounces)

            with span("vx::scatter"):
                # russian roulette: the draw happens only when rr_val < 0.1 on a
                # live lane (fragment.frag:102-107)
                rr_val = luma(throughput)
                low = active & (rr_val < 0.1)
                state, xi_rr = rng_where(low, state)
                killed = low & (xi_rr < 1.0 - rr_val)
                throughput = torch.where(
                    (low & ~killed)[..., None], throughput / torch.clamp_min(rr_val, 1e-20)[..., None], throughput
                )
                active = active & ~killed

                # scatter draw only for surviving lanes (fragment.frag:110-113)
                state, xi_ph = rng2_where(active, state)
                new_dir = sample_phase_henyey_greenstein(direction, params.phase_g, xi_ph)
                f_p = torch.where(
                    active, phase_henyey_greenstein((-direction * new_dir).sum(dim=-1), params.phase_g), f_p
                )
                direction = torch.where(active[..., None], new_dir, direction)

    return state, radiance


def _debug_hits(config, params, env, light_dir, origin, direction):
    """u_debugHits mode (fragment.frag:147-153): the box entry point's
    position inside the box as a colour, the background elsewhere."""
    hit, near, far = ray_box_intersection(Rays(origin, direction), params.aabb_lo, params.aabb_hi)
    hit_min = torch.where((near < 0.0)[..., None], origin, origin + near[..., None] * direction)
    rgb_hit = (hit_min - params.aabb_lo) / (params.aabb_hi - params.aabb_lo)
    bg = background_color(env, direction, config.hide_envmap, light_dir)
    return torch.where(hit[..., None], rgb_hit, bg)


def render_pixels(
    config: RenderConfig,
    grid: DeviceGrid,
    params: VolumeParams,
    lut,
    env: EnvState,
    inv_view,
    inv_proj,
    light_dir,
    pixel_index,
    frame_index: int,
):
    """Render one sample for an explicit pixel-index subset -> (n, 3).

    pixel_index is any int64 subset of [0, width*height); RNG seeding
    depends only on the global pixel index + frame, so a subset renders
    the same per-pixel values as the whole frame.
    """
    state, rays = camera_wavefront(config, inv_view, inv_proj, pixel_index, frame_index)
    return render_rays(config, grid, params, lut, env, light_dir, state, rays)


def render_rays(config: RenderConfig, grid: DeviceGrid, params: VolumeParams, lut, env: EnvState, light_dir, state,
                rays: Rays):
    """The radiance of a wavefront of seeded camera rays -> (n, 3).

    debug_hits colours each pixel by where its ray enters the box and runs
    no leg; gradient_shading shades each ray's first hit
    (shading.trace_shaded) with the mode's two legs. The default mode
    builds the premultiplied pyramid here unless `grid` carries one.
    """
    if config.mode == "default" and grid.maj_alpha is None and not config.debug_hits:
        grid = with_premul_majorant(config, grid, params, lut)
    if config.debug_hits:
        return _debug_hits(config, params, env, light_dir, rays.origin, rays.direction)
    if config.gradient_shading:
        return trace_shaded(config, grid, params, lut, env, light_dir, rays.origin, rays.direction, state)[1]
    with span("vx::trace_path"):
        state, radiance = trace_path(config, grid, params, lut, env, light_dir, rays.origin, rays.direction, state)
        return sanitize(radiance)


def with_premul_majorant(config: RenderConfig, grid: DeviceGrid, params: VolumeParams, lut) -> DeviceGrid:
    """The grid with the march's premultiplied pyramid for this transfer
    and these settings (modes.build_premul_majorant)."""
    with span("vx::premul_majorant"):
        maj_alpha = build_premul_majorant(grid.maj_mips, params, lut, config.physical_majorant)
        return grid._replace(maj_alpha=maj_alpha.contiguous())


def camera_ndc(config: RenderConfig, pixel_index, frame_index):
    """Seeded RNG states and jittered screen positions for a pixel subset
    (fragment.frag:57-65, :143-147) -> (state, ndc). frame_index is an int
    or a tensor of one frame per pixel (rng.seed_rays)."""
    with span("vx::camera"):
        state = seed_rays(pixel_index, frame_index)
        state, j1 = rng2(state)
        state, j2 = rng2(state)
        px = (pixel_index % config.width).to(torch.float32)
        py = (pixel_index // config.width).to(torch.float32)
        tex = torch.stack([(px + 0.5) / config.width, (py + 0.5) / config.height], dim=-1)
        jitter = (j1 + j2) / 2.0
        size = torch.tensor([config.width, config.height], dtype=torch.float32, device=tex.device)
        return state, tex + (jitter * 2.0 - 1.0) / size


def camera_wavefront(config: RenderConfig, inv_view, inv_proj, pixel_index, frame_index: int):
    """Seeded RNG states and jittered camera rays for a pixel subset
    (fragment.frag:57-65, :143-147) -> (state, Rays)."""
    with span("vx::camera"):
        state, ndc = camera_ndc(config, pixel_index, frame_index)
        return state, camera_rays(inv_view, inv_proj, ndc)


def render_sample(
    config: RenderConfig,
    grid: DeviceGrid,
    params: VolumeParams,
    lut,
    env: EnvState,
    inv_view,
    inv_proj,
    light_dir,
    frame_index: int,
):
    """Render one progressive sample -> (height*width, 3) float32 radiance.

    Pixel order is row-major with row 0 at the image bottom (GL fragment
    convention); hosts reshape to (height, width, 3) and flip for display.
    """
    n = config.width * config.height
    with span("vx::operands"):
        pixel_index = torch.arange(n, dtype=torch.int64, device=inv_view.device)
    return render_pixels(config, grid, params, lut, env, inv_view, inv_proj, light_dir, pixel_index, frame_index)


WARMUP_SAMPLES = 5  # lowResolutionDuration (viewer.ts:132)


def accumulate_progressive(previous, sample, frame_index: int):
    """Fold one sample into the accumulator with the reference's warm-up
    weighting (viewer.ts:1356): frames < WARMUP get weight 0 (overwrite),
    later frames form a running average."""
    with span("vx::accumulate"):
        f = torch.tensor(float(frame_index), dtype=torch.float32)
        if frame_index < WARMUP_SAMPLES:
            w = torch.tensor(0.0, dtype=torch.float32)
        else:
            w = (f - WARMUP_SAMPLES) / (f - WARMUP_SAMPLES + 1.0)
        w = w.to(previous.device)
        return w * previous + (1.0 - w) * sample


# Hable/Uncharted2 filmic tonemap + gamma (blit.frag:17-35): the plain
# PyTorch version of the display kernel, under the JAX package's name
tonemap = tonemap_plain
