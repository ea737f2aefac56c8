"""Gradient-shaded surface rendering: the PyTorch counterpart of
volxel_tpu.render.shading (beyond the reference).

First-hit rendering with central-difference density gradients and
Blinn-Phong shading: the classic "CT surface" look. The hit and the shadow
come from the render mode's two legs (modes.get_mode_functions: on the card
the CUDA leg kernels of dda_leg.cu, track_leg.cu or tile_march.cu); the
rest of a lane's work, the normal from six trilinear taps around the hit
point and the shading (`shade_hits`), is one launch of csrc/shade.cu on the
card and the plain PyTorch version `shade_hits_plain` on the CPU (the JAX
function is no Pallas kernel either).
"""

from __future__ import annotations

import torch

from volxel_tpu_torch import kernels
from volxel_tpu_torch.render.modes import get_mode_functions
from volxel_tpu_torch.render.rays import sanitize
from volxel_tpu_torch.render.sampling import SlabGrid, lookup_density_trilinear, world_to_index_point
from volxel_tpu_torch.render.tilemarch import _check_dense, _check_lanes, check_slabs
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


def shade_hits_plain(grid, params, light_dir, origin, direction, t, hit, rgb, shadow, bg):
    """Each lane's radiance (n, 3) after the legs: the hit point origin + t
    * direction, the normal from its density gradient (flipped toward the
    viewer), Blinn-Phong lit through `shadow` (the shadow leg's
    transmittance) on the hit's LUT colour `rgb`, the background `bg`
    (n, 3) where the lane did not `hit` (None: black), and sanitize."""
    n = origin.shape[0]
    hit_pos = origin + t[..., None] * direction
    ipos = world_to_index_point(params, hit_pos)
    grad = density_gradient(grid, params, ipos)
    grad_len = torch.linalg.norm(grad, dim=-1, keepdim=True)
    normal = -grad / torch.clamp_min(grad_len, 1e-8)
    # flip toward the viewer so backside hits still shade
    facing = (normal * (-direction)).sum(dim=-1, keepdim=True)
    normal = torch.where(facing < 0, -normal, normal)

    light = -light_dir.expand(n, 3)
    n_dot_l = torch.clamp_min((normal * light).sum(dim=-1), 0.0)
    half = light - direction
    half = half / torch.clamp_min(torch.linalg.norm(half, dim=-1, keepdim=True), 1e-8)
    n_dot_h = torch.clamp_min((normal * half).sum(dim=-1), 0.0)
    spec = torch.pow(n_dot_h, SHININESS)

    shaded = rgb * (K_AMBIENT + K_DIFFUSE * (n_dot_l * shadow)[..., None]) + K_SPECULAR * (spec * shadow)[..., None]
    if bg is None:
        bg = torch.zeros_like(shaded)
    return sanitize(torch.where(hit[..., None], shaded, bg))


def _field_args(grid, device):
    """vx_shade's field arguments (dense, slabs, slab, round_taps, ny, nx,
    ex, ey, ez) for a DeviceGrid's dense field or a SlabGrid's slabs."""
    if isinstance(grid, SlabGrid):
        table, slab, ny, nx, (ex, ey, ez) = check_slabs("shade", grid, grid.extent, device)
        return (None, table, slab, int(grid.tap_dtype == "bfloat16"), ny, nx, ex, ey, ez)
    ex, ey, ez = _check_dense("shade", grid.dense, grid.extent)
    kernels.require_cuda("shade", grid.dense, device=device)
    _, ny, nx = grid.dense.shape
    return (grid.dense.data_ptr(), None, 0, 0, ny, nx, ex, ey, ez)


def shade_hits_cuda(grid, params, light_dir, origin, direction, t, hit, rgb, shadow, bg):
    """`shade_hits_plain` as one launch of csrc/shade.cu; an origin
    expanded from one point (camera rays) is read as that point."""
    device, n = t.device, t.shape[0]
    field = _field_args(grid, device)
    if origin.dim() == 2 and origin.stride() == (0, 1):  # one point expanded over the lanes
        point, origin_step = origin[:1], 0
    else:
        point = origin = origin.contiguous()
        origin_step = 3
    direction, t, hit, rgb, shadow = (a.contiguous() for a in (direction, t, hit, rgb, shadow))
    bg = None if bg is None else bg.contiguous()
    transform_inv = params.transform_inv.contiguous()
    lanes = [point, direction, t, rgb, shadow, *(() if bg is None else (bg,))]
    kernels.require_cuda("shade", *lanes, transform_inv, params.density_scale, light_dir, dtype=torch.float32,
                         device=device)
    kernels.require_cuda("shade", hit, dtype=torch.bool, device=device)
    vectors = [("origin", origin), ("direction", direction), ("rgb", rgb), *(() if bg is None else (("bg", bg),))]
    _check_lanes("shade", n, vectors, [("t", t), ("hit", hit), ("shadow", shadow)])
    if tuple(transform_inv.shape) != (4, 4) or params.density_scale.numel() != 1 or light_dir.numel() != 3:
        raise ValueError("shade: expected a (4, 4) transform_inv, one density_scale and a 3-vector light_dir")
    out = torch.empty((n, 3), dtype=torch.float32, device=device)
    if n:
        kernels.launch("vx_shade", t, *field, transform_inv.data_ptr(), params.density_scale.data_ptr(),
                       light_dir.data_ptr(), SHININESS, origin.data_ptr(), origin_step,
                       *(a.data_ptr() for a in (direction, t, hit, rgb, shadow)),
                       None if bg is None else bg.data_ptr(), out.data_ptr(), n, counter="shade")
    return out


def shade_hits(grid, params, light_dir, origin, direction, t, hit, rgb, shadow, bg):
    """`shade_hits_plain`: one launch of csrc/shade.cu for CUDA tensors, the
    plain version for CPU tensors and for a SlabGrid of a row across nodes
    (`grid.row`), whose taps on other nodes are answered by their owners."""
    args = (grid, params, light_dir, origin, direction, t, hit, rgb, shadow, bg)
    if t.device.type == "cpu" or getattr(grid, "row", None) is not None:
        return shade_hits_plain(*args)
    return shade_hits_cuda(*args)


def trace_shaded(config, grid, params, lut, env, light_dir, origin, direction, state):
    """One-hit gradient Blinn-Phong shading with a traced shadow ray: the
    camera leg finds each ray's hit, the shadow leg runs from the hit
    points toward the light on the lanes that hit, and `shade_hits` shades
    them."""
    with span("vx::shade"):
        sample_volume, transmittance = get_mode_functions(config.mode, config.physical_shadows)
        n = origin.shape[0]
        active = torch.ones((n,), dtype=torch.bool, device=origin.device)

        with span("vx::sample_leg", bounce=0):
            state, hit, t, rgb, _ = sample_volume(grid, params, lut, origin, direction, state, active)

        hit_pos = origin + t[..., None] * direction
        light = -light_dir.expand(n, 3)
        with span("vx::shadow_leg", bounce=0):
            state, shadow = transmittance(grid, params, lut, hit_pos, light, state, hit)

        if config.use_env:
            bg = lookup_environment(env, direction)
        else:
            bg = lookup_environment_light(env, direction, light_dir)
        bg = bg if config.show_environment else None
        return state, shade_hits(grid, params, light_dir, origin, direction, t, hit, rgb, shadow, bg)
