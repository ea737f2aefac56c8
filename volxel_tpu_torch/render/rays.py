"""Ray setup and intersection utilities (shaders/utils.glsl in PyTorch).

Counterpart of volxel_tpu.render.rays. Camera rays come from inverse
view/projection matrices exactly as cameraWorldPos/cameraWorldDir
(utils.glsl:23-40), with the reference's sub-pixel anti-aliasing jitter
(fragment.frag:57-65).

The small matrix products are written out elementwise instead of as
`@`: BLAS would pick its own summation order and, on the card, possibly
TF32, while eager elementwise ops round the same way on every device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from volxel_tpu_torch.utils.mathutil import LUMA_WEIGHTS

_LUMA = tuple(float(w) for w in LUMA_WEIGHTS)


class Rays(NamedTuple):
    origin: torch.Tensor  # (..., 3)
    direction: torch.Tensor  # (..., 3)


def _affine(m, v):
    """Rows of `m` (k, 4) applied to homogeneous points v (..., 4) -> (..., k)."""
    return torch.stack(
        [v[..., 0] * r[0] + v[..., 1] * r[1] + v[..., 2] * r[2] + v[..., 3] * r[3] for r in m],
        dim=-1,
    )


def norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def camera_world_pos(inv_view):
    h = inv_view[:, 3]  # inv_view @ (0, 0, 0, 1)
    return h[:3] / h[3]


def camera_rays(inv_view, inv_proj, ndc_xy):
    """World-space rays through NDC positions (utils.glsl:28-40).

    ndc_xy: (..., 2) in [0,1]^2 screen space.
    """
    cam_pos = camera_world_pos(inv_view)
    ones = torch.ones_like(ndc_xy[..., :1])
    clip = torch.cat([ndc_xy * 2.0 - 1.0, torch.zeros_like(ones), ones], dim=-1)
    view_h = _affine(inv_proj, clip)
    view = view_h[..., :3] / view_h[..., 3:4]
    world_h = _affine(inv_view, torch.cat([view, ones], dim=-1))
    world = world_h[..., :3] / world_h[..., 3:4]
    direction = world - cam_pos
    direction = direction / norm3(direction)[..., None]
    return Rays(cam_pos.expand_as(direction), direction)


def pixel_ndc(width: int, height: int, jitter):
    """Per-pixel screen positions with AA jitter (fragment.frag:57-65).

    jitter: (height*width, 2) uniforms in [0,1). Returns (height*width, 2)
    screen coords in row-major pixel order, row 0 at the bottom (GL
    fragment convention).
    """
    dev = jitter.device
    ys, xs = torch.meshgrid(
        (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height,
        (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width,
        indexing="ij",
    )
    tex = torch.stack([xs, ys], dim=-1).reshape(-1, 2)
    size = torch.tensor([width, height], dtype=torch.float32, device=dev)
    return tex + (jitter * 2.0 - 1.0) / size


def ray_box_intersection(rays: Rays, aabb_lo, aabb_hi):
    """Slab test (utils.glsl:61-69). Returns (hit, near, far)."""
    inv_dir = 1.0 / rays.direction
    lo = (aabb_lo - rays.origin) * inv_dir
    hi = (aabb_hi - rays.origin) * inv_dir
    tmin = torch.minimum(lo, hi)
    tmax = torch.maximum(lo, hi)
    near = torch.clamp_min(tmin.amax(dim=-1), 0.0)
    far = tmax.amin(dim=-1)
    return near <= far, near, far


def luma(rgb):
    return rgb[..., 0] * _LUMA[0] + rgb[..., 1] * _LUMA[1] + rgb[..., 2] * _LUMA[2]


def power_heuristic(a, b):
    return (a * a) / (a * a + b * b)


def sanitize(x):
    """Replace NaN/Inf with 0 (utils.glsl:96-98)."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


# -- phase functions (utils.glsl:119-139) ---------------------------------------


def phase_henyey_greenstein(cos_t, g):
    denom = 1.0 + g * g + 2.0 * g * cos_t
    return (1.0 / (4.0 * math.pi)) * (1.0 - g * g) / (denom * torch.sqrt(torch.clamp_min(denom, 1e-12)))


def _cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def align_to(n, v):
    """Build a tangent frame around n and express v in it (utils.glsl:106-113)."""
    use_x = torch.abs(n[..., 0]) > torch.abs(n[..., 1])
    inv_len_xz = 1.0 / torch.sqrt(n[..., 0] ** 2 + n[..., 2] ** 2 + 1e-20)
    inv_len_yz = 1.0 / torch.sqrt(n[..., 1] ** 2 + n[..., 2] ** 2 + 1e-20)
    zero = torch.zeros_like(n[..., 0])
    t_x = torch.where(
        use_x[..., None],
        torch.stack([-n[..., 2], zero, n[..., 0]], -1) * inv_len_xz[..., None],
        torch.stack([zero, n[..., 2], -n[..., 1]], -1) * inv_len_yz[..., None],
    )
    b = _cross(n, t_x)
    out = v[..., 0:1] * t_x + v[..., 1:2] * b + v[..., 2:3] * n
    return out / norm3(out)[..., None]


def sample_phase_henyey_greenstein(direction, g, rnd2):
    """HG importance sample around `direction` (utils.glsl:131-139)."""
    u, v = rnd2[..., 0], rnd2[..., 1]
    iso_cos = 1.0 - 2.0 * u
    sqr_g = g * g
    frac = (1.0 - sqr_g) / (1.0 - g + 2.0 * g * u + 1e-20)
    hg_cos = (1.0 + sqr_g - frac * frac) / (2.0 * g + 1e-20)
    cos_t = torch.where(torch.abs(g) < 1e-4, iso_cos, hg_cos)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * math.pi * v
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
    return align_to(direction, local)
