"""Traversal step-count statistics, the loop-cap variance study: the
PyTorch counterpart of volxel_tpu.utils.stepstats.

The legs cap each lane's work (ddaleg.DDA_SAMPLE_MAX_STEPS and
DDA_TRANSMITTANCE_MAX_STEPS, trackleg.TRACKING_MAX_EVENTS) where the GL
originals are unbounded (except transmittanceDDA's 100-step cap,
dda.glsl:18). This module measures the actual per-ray step distributions
on a scene so the caps are evidence-backed: a capped lane silently
truncates the estimator (biasing dense scenes), so the percentiles and
max must stay well under the caps. The counts come from the legs
themselves (their budget or events left, through the mode functions'
`with_stats`), so on the card they are the kernels' own; on volume slabs
the legs read the first position's SlabGrid, across nodes through
parallel.migrate, whose lanes carry their budgets and events with them.
"""

from __future__ import annotations

import numpy as np
import torch

from volxel_tpu_torch.render import modes
from volxel_tpu_torch.render.ddaleg import DDA_SAMPLE_MAX_STEPS, DDA_TRANSMITTANCE_MAX_STEPS
from volxel_tpu_torch.render.rays import camera_rays, norm3
from volxel_tpu_torch.render.rng import rng2, seed_rays
from volxel_tpu_torch.render.trackleg import TRACKING_MAX_EVENTS

MAX_RAYS = 1 << 16  # 64k uniformly strided pixels give the percentiles to well under 1%


def step_statistics(renderer, mode: str | None = None, sample_index: int = 0) -> dict:
    """Per-ray step counts for one primary-visibility wavefront plus the
    shadow-ray transmittance wavefront from the hit points toward the
    light, in one pass of each leg.

    At most MAX_RAYS pixels are measured, strided uniformly across the
    image; their camera rays take one rng2 jitter draw. The default
    mode's premultiplied pyramid is built with no majorant envelope,
    whatever physical_majorant says, as the JAX package's pass reads the
    renderer's device grid as it is. Returns
    {"sample": stats, "transmittance": stats, "mode": ...} where stats =
    {p50, p90, p99, max, cap, frac_at_cap}.
    """
    r = renderer
    mode = mode or r.settings.render_mode
    if mode == "raymarch":
        # fixed-step: 64 iterations always, no caps to study
        fixed = {"p50": 64, "p90": 64, "p99": 64, "max": 64, "cap": modes.RAYMARCH_STEPS, "frac_at_cap": 0.0}
        return {"sample": fixed, "transmittance": fixed, "mode": mode}

    w, h = r.width, r.height
    config = r._config()._replace(width=w, height=h, mode=mode)
    grid, params, lut = _grid(r), r.volume_params(), r._lut
    inv_view, inv_proj, light = r._camera_operands(config)
    if mode == "default":
        grid = grid._replace(maj_alpha=modes.build_premul_majorant(grid.maj_mips, params, lut).contiguous())
    total = w * h
    stride = max(1, -(-total // MAX_RAYS))
    pixel_index = torch.arange(0, total, stride, dtype=torch.int64, device=r.device)
    sample_volume, transmittance = modes.get_mode_functions(mode)

    state = seed_rays(pixel_index, sample_index)
    state, jit2 = rng2(state)
    px = (pixel_index % w).to(torch.float32)
    py = (pixel_index // w).to(torch.float32)
    tex = torch.stack([(px + 0.5) / w, (py + 0.5) / h], dim=-1)
    ndc = tex + (jit2 * 2.0 - 1.0) / torch.tensor([w, h], dtype=torch.float32, device=r.device)
    rays = camera_rays(inv_view, inv_proj, ndc)
    active = torch.ones(pixel_index.shape, dtype=torch.bool, device=r.device)
    state, hit, t, _rgb, _le, s_steps = sample_volume(grid, params, lut, rays.origin, rays.direction, state, active,
                                                      with_stats=True)
    # shadow rays from the hit points toward the light (the NEE wavefront)
    origin = rays.origin + t[..., None] * rays.direction
    direction = (-light / norm3(light)).expand_as(origin).contiguous()
    state, _tr, t_steps = transmittance(grid, params, lut, origin, direction, state, hit, with_stats=True)

    s_steps, hit, t_steps = (x.cpu().numpy() for x in (s_steps, hit, t_steps))
    s_cap = DDA_SAMPLE_MAX_STEPS if mode == "default" else TRACKING_MAX_EVENTS
    t_cap = DDA_TRANSMITTANCE_MAX_STEPS if mode == "default" else TRACKING_MAX_EVENTS
    return {"mode": mode, "sample": _stats(s_steps, s_cap), "transmittance": _stats(t_steps[hit], t_cap)}


def _grid(r):
    """What the legs read: the renderer's device grid or, on a
    DistributedRenderer with volume slabs, its first position's SlabGrid
    (whose legs, on a 'vz' row across nodes, go through parallel.migrate:
    every process of the row calls step_statistics together)."""
    if getattr(r, "vz", 1) > 1:
        return r._render_grid().local_grid()
    return r._device_grid


def _stats(steps: np.ndarray, cap: int) -> dict:
    if steps.size == 0:
        return {"p50": 0, "p90": 0, "p99": 0, "max": 0, "cap": cap, "frac_at_cap": 0.0}
    return {
        "p50": int(np.percentile(steps, 50)),
        "p90": int(np.percentile(steps, 90)),
        "p99": int(np.percentile(steps, 99)),
        "max": int(steps.max()),
        "cap": cap,
        "frac_at_cap": float((steps >= cap).mean()),
    }
