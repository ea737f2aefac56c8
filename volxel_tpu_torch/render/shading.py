"""Gradient-shaded surface rendering: the PyTorch counterpart of
volxel_tpu.render.shading (beyond the reference).

First-hit rendering with central-difference density gradients and
Blinn-Phong shading: the classic "CT surface" look. The hit and the shadow
come from the render mode's two legs (modes.get_mode_functions: on the card
the CUDA leg kernels of dda_leg.cu, track_leg.cu or tile_march.cu); the
normal comes from six trilinear taps around the hit point, in PyTorch (the
JAX function is no Pallas kernel either).
"""

from __future__ import annotations

import torch

from volxel_tpu_torch.render.modes import get_mode_functions
from volxel_tpu_torch.render.rays import sanitize
from volxel_tpu_torch.render.sampling import lookup_density_trilinear, world_to_index_point
from volxel_tpu_torch.scene.environment import lookup_environment, lookup_environment_light
from volxel_tpu_torch.utils.profiling import span

# Blinn-Phong material constants
K_AMBIENT = 0.15
K_DIFFUSE = 0.75
K_SPECULAR = 0.25
SHININESS = 32.0


def density_gradient(grid, params, ipos):
    """Central-difference gradient in index space: 6 trilinear taps. On a
    SlabGrid of a 'vz' row across nodes the taps whose slab lies on another
    node are answered by its owner through the row the grid carries
    (parallel.migrate.Row), one exchange a lookup, which every process of
    the row makes together."""
    row = getattr(grid, "row", None)
    lookup = lookup_density_trilinear if row is None else row.lookup_density_trilinear
    grads = []
    for axis in range(3):
        offset = torch.zeros(3, dtype=torch.float32, device=ipos.device)
        offset[axis] = 1.0
        hi = lookup(grid, params, ipos + offset)
        lo = lookup(grid, params, ipos - offset)
        grads.append((hi - lo) * 0.5)
    return torch.stack(grads, dim=-1)


def trace_shaded(config, grid, params, lut, env, light_dir, origin, direction, state):
    """One-hit gradient Blinn-Phong shading with a traced shadow ray: the
    camera leg finds each ray's hit, the shadow leg runs from the hit
    points toward the light on the lanes that hit."""
    with span("vx::shade"):
        sample_volume, transmittance = get_mode_functions(config.mode, config.physical_shadows)
        n = origin.shape[0]
        active = torch.ones((n,), dtype=torch.bool, device=origin.device)

        with span("vx::sample_leg", bounce=0):
            state, hit, t, rgb, _ = sample_volume(grid, params, lut, origin, direction, state, active)

        hit_pos = origin + t[..., None] * direction
        ipos = world_to_index_point(params, hit_pos)
        grad = density_gradient(grid, params, ipos)
        grad_len = torch.linalg.norm(grad, dim=-1, keepdim=True)
        normal = -grad / torch.clamp_min(grad_len, 1e-8)
        # flip toward the viewer so backside hits still shade
        facing = (normal * (-direction)).sum(dim=-1, keepdim=True)
        normal = torch.where(facing < 0, -normal, normal)

        light = -light_dir.expand(n, 3)
        with span("vx::shadow_leg", bounce=0):
            state, shadow = transmittance(grid, params, lut, hit_pos, light, state, hit)

        n_dot_l = torch.clamp_min((normal * light).sum(dim=-1), 0.0)
        half = light - direction
        half = half / torch.clamp_min(torch.linalg.norm(half, dim=-1, keepdim=True), 1e-8)
        n_dot_h = torch.clamp_min((normal * half).sum(dim=-1), 0.0)
        spec = torch.pow(n_dot_h, SHININESS)

        shaded = rgb * (K_AMBIENT + K_DIFFUSE * (n_dot_l * shadow)[..., None]) + K_SPECULAR * (spec * shadow)[..., None]

        if config.use_env:
            bg = lookup_environment(env, direction)
        else:
            bg = lookup_environment_light(env, direction, light_dir)
        if not config.show_environment:
            bg = torch.zeros_like(bg)

        return state, sanitize(torch.where(hit[..., None], shaded, bg))
