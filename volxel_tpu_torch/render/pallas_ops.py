"""The environment importance pyramid and the display tonemap, each a
hand-written CUDA kernel on the card beside its plain PyTorch version.

Counterparts of the two Pallas kernels of volxel_tpu.render.pallas_ops:

  * build_importance_pyramid — 9 levels of 2x2 mean pooling of the 512^2
    environment luma (256^2 ... 1^2); csrc/importance_pyramid.cu.
  * tonemap_display — the Hable filmic tonemap + exposure + gamma over the
    flat (N, 3) framebuffer (blit.frag:17-35); csrc/tonemap.cu.

Dispatch is on the tensor's device: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel (or raises). There is no fallback.
"""

from __future__ import annotations

import torch

from volxel_tpu_torch import kernels
from volxel_tpu_torch.scene.environment import IMP_BASE_MIP, IMP_DIM

# Hable / Uncharted2 curve constants (blit.frag:17-25)
_A, _B, _C, _D, _E, _F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
HABLE_WHITE = 11.2


# -- importance pyramid --------------------------------------------------------


def build_importance_pyramid_plain(base: torch.Tensor) -> tuple:
    """Successive 2x2 mean pools: (512, 512) -> (256^2, ..., 1^2). Each
    texel is ((top-left + top-right) + (bottom-left + bottom-right)) * 0.25,
    the kernel's order of summation, so that the two agree bit for bit."""
    levels = []
    level = base
    for _ in range(IMP_BASE_MIP):
        level = ((level[0::2, 0::2] + level[0::2, 1::2]) + (level[1::2, 0::2] + level[1::2, 1::2])) * 0.25
        levels.append(level)
    return tuple(levels)


def build_importance_pyramid_cuda(base: torch.Tensor) -> tuple:
    """The same pools as one launch of csrc/importance_pyramid.cu; the nine
    levels are views into one buffer, each contiguous."""
    kernels.require_cuda("build_importance_pyramid", base, dtype=torch.float32)
    if tuple(base.shape) != (IMP_DIM, IMP_DIM):
        raise ValueError(f"build_importance_pyramid: expected ({IMP_DIM}, {IMP_DIM}), got {tuple(base.shape)}")
    if base.data_ptr() % 16:
        raise ValueError("build_importance_pyramid: the kernel reads 16-byte words; base is misaligned")
    dims = [IMP_DIM >> (k + 1) for k in range(IMP_BASE_MIP)]
    out = torch.empty(sum(d * d for d in dims), dtype=torch.float32, device=base.device)
    kernels.launch("vx_importance_pyramid", base, base.data_ptr(), out.data_ptr(), counter="importance_pyramid")
    levels, at = [], 0
    for d in dims:
        levels.append(out[at:at + d * d].view(d, d))
        at += d * d
    return tuple(levels)


def build_importance_pyramid(base: torch.Tensor) -> tuple:
    """(512, 512) luma -> tuple of 9 pooled levels (256^2 ... 1^2)."""
    if base.device.type == "cpu":
        return build_importance_pyramid_plain(base)
    return build_importance_pyramid_cuda(base)


# -- display tonemap -----------------------------------------------------------


def _hable(rgb):
    return ((rgb * (_A * rgb + _C * _B) + _D * _E) / (rgb * (_A * rgb + _B) + _D * _F)) - _E / _F


def tonemap_plain(image: torch.Tensor, exposure: float, gamma: float) -> torch.Tensor:
    """Hable/Uncharted2 filmic tonemap + gamma (blit.frag:17-35)."""
    white = _hable(torch.tensor(HABLE_WHITE, dtype=torch.float32, device=image.device))
    mapped = _hable(exposure * image) / white
    return torch.pow(torch.clamp_min(mapped, 0.0), 1.0 / torch.tensor(gamma, dtype=torch.float32))


def tonemap_cuda(image: torch.Tensor, exposure: float, gamma: float) -> torch.Tensor:
    """The same map, bit for bit, as one launch of csrc/tonemap.cu over the
    3N floats in 16-byte words (two launches where a tail of N * 3 % 4
    floats, or a misaligned buffer, takes its scalar path)."""
    kernels.require_cuda("tonemap_display", image, dtype=torch.float32)
    out = torch.empty_like(image)
    inv_gamma = (1.0 / torch.tensor(gamma, dtype=torch.float32)).item()
    kernels.launch("vx_tonemap", image, image.data_ptr(), out.data_ptr(), image.numel(), float(exposure), inv_gamma,
                   counter="tonemap")
    return out


def tonemap_display(framebuffer: torch.Tensor, exposure: float, gamma: float) -> torch.Tensor:
    """Tonemap a flat (N, 3) framebuffer for display."""
    if framebuffer.device.type == "cpu":
        return tonemap_plain(framebuffer, exposure, gamma)
    return tonemap_cuda(framebuffer, exposure, gamma)
