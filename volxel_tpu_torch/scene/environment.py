"""Environment lighting: equirect map, importance pyramid, warp sampling.

PyTorch counterpart of volxel_tpu.scene.environment
(representation/environment.ts + shaders/environment.glsl): the importance
map is the envmap's luma resized to 512^2 and mean-pooled down to 1^2
(render.pallas_ops.build_importance_pyramid, a CUDA kernel on the card),
and the per-sample hierarchical warp (environment.glsl:38-68) is a
statically unrolled descent over the pyramid, vectorized over all rays.

Conventions: the stored envmap is in texture space — row j corresponds to
texture v=(j+0.5)/H, where v = 1 - acos(y)/pi. Decoded images (row 0 = image
top) are flipped on construction (environment.ts:31).

Faithfully replicated reference quirks (kept for parity): the pdf uses
1/(4*pi) instead of the equirect solid-angle Jacobian, and scales luma by
env_strength while the importance map is built unscaled
(environment.glsl:80-86). `physical=True` reports the warp's true density
over solid angle instead (settings.physical_pdf).

The JAX package's precomputed warp tables, MXU packings and quad-packed
envmap work around serialized TPU gathers; the warp here is the inline
form, which those tables are pinned bit-identical to. In the plain
version the bilinear taps and the importance-texel fetches go through
render.gather.gather_f32, as the JAX package sends them through
mxu_gather_f32.

On the card the per-lane work is csrc/env.cu, one launch a call:
`vx_env_sample` is the warp with its radiance, pdf and direction, and
`vx_env_lookup` the lookup, the pdf, or both from one read of each
direction (lookup_environment_pdf, the escaped rays' MIS). Each is
bit-equal to the plain version at every lane, for either `physical` and
any map size. CPU tensors take the plain version: the path is chosen by
the tensors' device, as for every kernel of the port, and the plain
versions (`*_plain`) run on any device. The light fallback
(lookup_environment_light, sample_environment_light) stays plain.

Every entry point that builds state takes its device from the caller;
none defaults to one.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from volxel_tpu_torch import kernels
from volxel_tpu_torch.render import gather
from volxel_tpu_torch.render.rays import luma
from volxel_tpu_torch.utils.profiling import spanned

# importance map resolution (power of two; environment.ts:9)
IMP_DIM = 512
IMP_BASE_MIP = 9  # log2(IMP_DIM)


class EnvState(NamedTuple):
    """Device-side environment."""

    envmap: torch.Tensor  # (H, W, 3) float32, texture space (row 0 = v~0)
    imp_mips: tuple  # mips[0]=(512,512) ... mips[9]=(1,1) float32
    strength: torch.Tensor  # scalar float32


def _linear_resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of an antialiased linear (triangle) resize,
    the rule of jax.image.resize(..., "linear"): sample positions
    (i + 0.5) * n_in / n_out - 0.5, a triangle kernel widened by the
    downscale factor when shrinking, columns normalized to sum 1, and
    zero columns for samples outside the input. Built in float64."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float64, device=device)[:, None]
    w = torch.clamp_min(1.0 - torch.abs(sample[None, :] - src) / kernel_scale, 0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps), w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_linear(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(H, W) f32 -> (height, width) f32, separable linear resize (the
    jax.image.resize "linear" rule). Computed in float64 so the result does
    not depend on the card's TF32 matmul setting; axes whose size already
    matches are left alone, as jax does."""
    out = image.to(torch.float64)
    h, w = image.shape
    if h != height:
        out = _linear_resize_weights(h, height, image.device).T @ out
    if w != width:
        out = out @ _linear_resize_weights(w, width, image.device)
    return out.to(torch.float32)


def build_env_state(envmap_texture, strength: float = 1.0, *, device) -> EnvState:
    """Build the importance pyramid from a texture-space (H, W, 3) envmap,
    on `device` (no default: the caller says where)."""
    from volxel_tpu_torch.render.pallas_ops import build_importance_pyramid

    env = torch.as_tensor(np.ascontiguousarray(np.asarray(envmap_texture)[..., :3], dtype=np.float32))
    env = env.to(device)
    base = resize_linear(luma(env), IMP_DIM, IMP_DIM).contiguous()
    mips = (base,) + tuple(build_importance_pyramid(base))
    return EnvState(
        envmap=env,
        imp_mips=mips,
        strength=torch.tensor(float(strength), dtype=torch.float32, device=device),
    )


class Environment:
    """Host-side environment holder (reference Environment class)."""

    def __init__(self, image_top_down: np.ndarray, strength: float = 1.0, *, device):
        # decoded images have row 0 at the top; flip to texture space
        tex = np.ascontiguousarray(image_top_down[::-1, :, :3], dtype=np.float32)
        self.texture = tex
        self.strength = float(strength)
        self.state = build_env_state(tex, strength, device=device)

    def with_strength(self, strength: float) -> "Environment":
        self.strength = float(strength)
        self.state = self.state._replace(
            strength=torch.tensor(self.strength, dtype=torch.float32, device=self.state.envmap.device)
        )
        return self


def default_environment_image() -> np.ndarray:
    """8x6 checkerboard with a bright top third (environment.ts:94-120),
    image row 0 at the top."""
    width, height = 8, 6
    data = np.zeros((height, width, 3), np.float32)
    for y in range(height):
        top = y < height // 3
        for x in range(width):
            light = ((x + y) & 1) == 0
            val = (3.0 if light else 0.9) if top else (0.1 if light else 0.0)
            data[y, x, :] = val
    return data


def default_environment(device) -> Environment:
    return Environment(default_environment_image(), device=device)


# -- device-side sampling ------------------------------------------------------


def _bilinear_wrap_clamp(tex: torch.Tensor, u, v):
    """Bilinear sample of (H, W, C) with wrap in u, clamp in v (GL REPEAT/CLAMP)."""
    h, w = tex.shape[0], tex.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    # int32 flat indices, as gather_f32 takes them (a map holds far fewer
    # than 2^31 words)
    x0i = torch.remainder(x0.to(torch.int32), w)
    x1i = torch.remainder(x0i + 1, w)
    # GL CLAMP_TO_EDGE clamps each tap independently: for y0 = -1 the two
    # rows are clamp(-1)=0 and clamp(0)=0 — NOT rows 0 and 1
    y0i = torch.clamp(y0.to(torch.int32), 0, h - 1)
    y1i = torch.clamp(y0.to(torch.int32) + 1, 0, h - 1)
    # the 4 taps x C channels in one fetch (the JAX package's packed form)
    c = tex.shape[2]
    base = torch.stack([y0i * w + x0i, y0i * w + x1i, y1i * w + x0i, y1i * w + x1i])
    taps = gather.gather_f32(tex, base[..., None] * c + torch.arange(c, dtype=torch.int32, device=tex.device))
    t00, t10, t01, t11 = taps[0], taps[1], taps[2], taps[3]
    return t00 * (1 - fx) * (1 - fy) + t10 * fx * (1 - fy) + t01 * (1 - fx) * fy + t11 * fx * fy


def _dir_to_uv(direction):
    u = torch.atan2(direction[..., 2], direction[..., 0]) / (2.0 * math.pi) + 0.5
    v = 1.0 - torch.acos(torch.clamp(direction[..., 1], -1.0, 1.0)) / math.pi
    return u, v


def lookup_environment_plain(env: EnvState, direction):
    """lookup_environment in plain PyTorch, on any device."""
    u, v = _dir_to_uv(direction)
    return env.strength * _bilinear_wrap_clamp(env.envmap, u, v)


def sample_environment_plain(env: EnvState, rnd2, physical: bool = False):
    """sample_environment in plain PyTorch, on any device."""
    shape = rnd2.shape[:-1]
    pos_x = torch.zeros(shape, dtype=torch.int32, device=rnd2.device)
    pos_y = torch.zeros(shape, dtype=torch.int32, device=rnd2.device)
    px = rnd2[..., 0]
    py = rnd2[..., 1]

    for mip in range(IMP_BASE_MIP - 1, -1, -1):
        imp = env.imp_mips[mip]  # (512>>mip, 512>>mip)
        dim = imp.shape[1]
        flat = imp.reshape(-1)
        row0 = (pos_y * 2) * dim + pos_x * 2
        w00 = flat[row0]
        w10 = flat[row0 + 1]
        w01 = flat[row0 + dim]
        w11 = flat[row0 + dim + 1]
        q0 = w00 + w01  # left column
        q1 = w10 + w11  # right column
        d = q0 / torch.clamp_min(q0 + q1, 1e-8)
        go_right = px >= d
        w_sel_bottom = torch.where(go_right, w10, w00)
        q_sel = torch.where(go_right, q1, q0)
        e = w_sel_bottom / torch.clamp_min(q_sel, 1e-8)
        px = torch.where(go_right, (px - d) / torch.clamp_min(1.0 - d, 1e-8), px / torch.clamp_min(d, 1e-8))
        pos_x = pos_x * 2 + go_right.to(torch.int32)
        go_up = py >= e
        py = torch.where(go_up, (py - e) / torch.clamp_min(1.0 - e, 1e-8), py / torch.clamp_min(e, 1e-8))
        pos_y = pos_y * 2 + go_up.to(torch.int32)

    inv_dim = 1.0 / IMP_DIM
    uv_x = (pos_x.to(torch.float32) + px) * inv_dim
    uv_y = (pos_y.to(torch.float32) + py) * inv_dim
    theta = torch.clamp(1.0 - uv_y, 0.0, 1.0) * math.pi
    phi = (torch.clamp(uv_x, 0.0, 1.0) * 2.0 - 1.0) * math.pi
    sin_t = torch.sin(theta)
    w_i = torch.stack([sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi)], dim=-1)

    le = env.strength * _bilinear_wrap_clamp(env.envmap, uv_x, uv_y)
    avg_w = env.imp_mips[IMP_BASE_MIP][0, 0]
    texel_ratio = gather.gather_f32(env.imp_mips[0], pos_y * IMP_DIM + pos_x) / avg_w
    if physical:
        # texel mass / (avg * N) over uv-area 1/N, through the equirect
        # Jacobian d(omega) = 2*pi^2*sin(theta) d(uv)
        pdf = texel_ratio / (2.0 * math.pi * math.pi * torch.clamp_min(sin_t, 1e-6))
    else:
        pdf = texel_ratio * (1.0 / (4.0 * math.pi))
    return le, pdf, w_i


def _reference_pdf(env: EnvState, le):
    """The reference's escape pdf of radiance `le`: strength-scaled luma over
    the mean importance, over 4 pi."""
    return luma(le) / env.imp_mips[IMP_BASE_MIP][0, 0] * (1.0 / (4.0 * math.pi))


def pdf_environment_plain(env: EnvState, direction, physical: bool = False):
    """pdf_environment in plain PyTorch, on any device."""
    if physical:
        avg_w = env.imp_mips[IMP_BASE_MIP][0, 0]
        u, v = _dir_to_uv(direction)
        px = torch.clamp((u * IMP_DIM).to(torch.int32), 0, IMP_DIM - 1)
        py = torch.clamp((v * IMP_DIM).to(torch.int32), 0, IMP_DIM - 1)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - torch.clamp(direction[..., 1], -1.0, 1.0) ** 2, 0.0))
        texel = gather.gather_f32(env.imp_mips[0], py * IMP_DIM + px)
        return texel / avg_w / (2.0 * math.pi * math.pi * torch.clamp_min(sin_t, 1e-6))
    return _reference_pdf(env, lookup_environment_plain(env, direction))


def lookup_environment_pdf_plain(env: EnvState, direction, physical: bool = False):
    """(lookup, pdf) of the directions in plain PyTorch, on any device."""
    le = lookup_environment_plain(env, direction)
    return le, (pdf_environment_plain(env, direction, True) if physical else _reference_pdf(env, le))


# -- the same on the card: csrc/env.cu -----------------------------------------

_PDF_NONE, _PDF_REFERENCE, _PDF_PHYSICAL = 0, 1, 2  # vx_env_lookup's `pdf`


def _env_operands(name: str, env: EnvState, lanes: torch.Tensor, width: int) -> tuple:
    """Check the environment and the (..., width) f32 lanes a kernel takes,
    raising before any launch; return the lanes, contiguous, and the C
    entry points' environment arguments (map, h, w, mips, strength)."""
    if lanes.dtype != torch.float32 or lanes.shape[-1:] != (width,):
        raise ValueError(f"{name}: expected (..., {width}) float32 lanes, got {tuple(lanes.shape)} {lanes.dtype}")
    envmap, mips, strength = env.envmap, env.imp_mips, env.strength
    if envmap.dim() != 3 or envmap.shape[2] != 3 or envmap.shape[0] < 1 or envmap.shape[1] < 1:
        raise ValueError(f"{name}: expected an (H, W, 3) map, got {tuple(envmap.shape)}")
    if len(mips) != IMP_BASE_MIP + 1 or any(m.shape != (IMP_DIM >> k,) * 2 for k, m in enumerate(mips)):
        raise ValueError(f"{name}: expected {IMP_BASE_MIP + 1} importance levels of 512^2 ... 1^2, got "
                         f"{[tuple(m.shape) for m in mips]}")
    if strength.numel() != 1:
        raise ValueError(f"{name}: expected one strength, got {tuple(strength.shape)}")
    lanes = lanes.contiguous()
    kernels.require_cuda(name, envmap, *mips, strength, dtype=torch.float32, device=lanes.device)
    kernels.require_cuda(name, lanes)
    ptrs = (ctypes.c_void_p * len(mips))(*(m.data_ptr() for m in mips))
    return lanes, (envmap.data_ptr(), envmap.shape[0], envmap.shape[1], ptrs, strength.data_ptr())


def sample_environment_cuda(env: EnvState, rnd2, physical: bool = False):
    """sample_environment on the card, one launch of csrc/env.cu over the
    (..., 2) f32 uniforms, bit-equal to the plain version at every lane."""
    rnd2, operands = _env_operands("env_sample", env, rnd2, 2)
    lanes = rnd2.shape[:-1]
    le = torch.empty((*lanes, 3), dtype=torch.float32, device=rnd2.device)
    pdf = torch.empty(lanes, dtype=torch.float32, device=rnd2.device)
    w_i = torch.empty((*lanes, 3), dtype=torch.float32, device=rnd2.device)
    if pdf.numel():
        kernels.launch("vx_env_sample", rnd2, *operands, rnd2.data_ptr(), int(bool(physical)), le.data_ptr(),
                       pdf.data_ptr(), w_i.data_ptr(), pdf.numel(), counter="env_sample")
    return le, pdf, w_i


def _lookup_cuda(env: EnvState, direction, radiance: bool, pdf: int):
    """One launch of vx_env_lookup over the (..., 3) f32 directions: the
    radiance (where `radiance`) and the pdf `pdf` -> (le or None, pdf or None)."""
    direction, operands = _env_operands("env_lookup", env, direction, 3)
    lanes = direction.shape[:-1]
    le = torch.empty((*lanes, 3), dtype=torch.float32, device=direction.device) if radiance else None
    out = torch.empty(lanes, dtype=torch.float32, device=direction.device) if pdf != _PDF_NONE else None
    n = direction.numel() // 3
    if n:
        kernels.launch("vx_env_lookup", direction, *operands, direction.data_ptr(), pdf,
                       None if le is None else le.data_ptr(), None if out is None else out.data_ptr(), n,
                       counter="env_lookup")
    return le, out


def lookup_environment_cuda(env: EnvState, direction):
    """lookup_environment on the card, one launch, bit-equal to the plain version."""
    return _lookup_cuda(env, direction, True, _PDF_NONE)[0]


def pdf_environment_cuda(env: EnvState, direction, physical: bool = False):
    """pdf_environment on the card, one launch, bit-equal to the plain version."""
    return _lookup_cuda(env, direction, False, _PDF_PHYSICAL if physical else _PDF_REFERENCE)[1]


def lookup_environment_pdf_cuda(env: EnvState, direction, physical: bool = False):
    """lookup_environment_pdf on the card, one launch for both, bit-equal to
    the plain version."""
    return _lookup_cuda(env, direction, True, _PDF_PHYSICAL if physical else _PDF_REFERENCE)


# -- the entry points: the plain version for CPU tensors, the kernels for CUDA ones


@spanned("vx::env")
def lookup_environment(env: EnvState, direction):
    """Equirect radiance lookup (environment.glsl:19-27)."""
    if direction.device.type == "cpu":
        return lookup_environment_plain(env, direction)
    return lookup_environment_cuda(env, direction)


@spanned("vx::env")
def lookup_environment_light(env: EnvState, direction, light_dir):
    """Procedural directional-light fallback (environment.glsl:20-22)."""
    d = (direction * (-light_dir)).sum(dim=-1)
    glow = torch.clamp(torch.pow(torch.clamp_min(d, 0.0), 300.0), 0.0, 1.0) * 4.0 + 0.01
    return env.strength * glow[..., None] * torch.ones(3, dtype=torch.float32, device=direction.device)


@spanned("vx::env")
def sample_environment(env: EnvState, rnd2, physical: bool = False):
    """Hierarchical warp sample (environment.glsl:36-80).

    rnd2: (..., 2) uniforms. Returns (Le (...,3), pdf (...), w_i (...,3)).
    physical=True reports the warp's true solid-angle density instead of
    the reference's 1/(4*pi)-scaled texel mass.
    """
    if rnd2.device.type == "cpu":
        return sample_environment_plain(env, rnd2, physical)
    return sample_environment_cuda(env, rnd2, physical)


@spanned("vx::env")
def sample_environment_light(env: EnvState, rnd2, light_dir):
    """Directional-light sampling branch (environment.glsl:30-33)."""
    shape = rnd2.shape[:-1]
    w_i = (-light_dir).expand(shape + (3,))
    le = (env.strength * 4.01).expand(shape)
    ones = torch.ones(3, dtype=torch.float32, device=rnd2.device)
    return le[..., None] * ones, torch.ones(shape, dtype=torch.float32, device=rnd2.device), w_i


@spanned("vx::env")
def pdf_environment(env: EnvState, direction, physical: bool = False):
    """environment.glsl:82-86 — strength-scaled luma over mean importance.

    physical=True returns the density sample_environment(physical=True)
    draws this direction with.
    """
    if direction.device.type == "cpu":
        return pdf_environment_plain(env, direction, physical)
    return pdf_environment_cuda(env, direction, physical)


@spanned("vx::env")
def lookup_environment_pdf(env: EnvState, direction, physical: bool = False):
    """(lookup_environment, pdf_environment) of the same directions: the
    escaped rays' radiance and MIS pdf, one launch on the card."""
    if direction.device.type == "cpu":
        return lookup_environment_pdf_plain(env, direction, physical)
    return lookup_environment_pdf_cuda(env, direction, physical)


@spanned("vx::env")
def background_color(env: EnvState, direction, hide_envmap: bool, light_dir=None):
    """get_background_color (environment.glsl:89-96) for debug-hits mode:
    the environment, or with hide_envmap a faint checker."""
    if not hide_envmap:
        return lookup_environment(env, direction)
    d = direction
    xz = torch.tensor([1.0, 0.0, 1.0], dtype=torch.float32, device=d.device)
    horiz = d / torch.clamp_min(torch.linalg.norm(d * xz, dim=-1, keepdim=True), 1e-8)
    horiz = horiz * xz
    angle_h = (torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=d.device) * horiz).sum(dim=-1) * 0.5 + 0.5
    angle_h = torch.where(torch.round(angle_h * 8.0).to(torch.int32) % 2 == 0, 1.0, 0.0)
    dn = d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-8)
    angle_v = (dn * horiz).sum(dim=-1)
    angle_v = torch.where(torch.round(angle_v * 8.0).to(torch.int32) % 2 == 0, 0.0, 1.0)
    return (torch.abs(angle_h - angle_v) * 0.05)[..., None] * torch.ones(3, dtype=torch.float32, device=d.device)
