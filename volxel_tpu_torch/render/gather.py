"""Exact f32 table fetches: a hand-written CUDA kernel on the card beside
its plain PyTorch version.

Counterpart of volxel_tpu.render.mxu_gather (mxu_gather_f32). The TPU
cannot gather per lane, so the JAX package splits a table into byte
planes and selects each word with a one-hot matrix product
(pack_gather_table, the probe); on Hopper a thread loads the word, so none
of that is carried over. Two entry points, both in csrc/gather.cu:

  * gather_f32(table, idx): table.reshape(-1)[idx], bit for bit, for any
    index shape (NaN payloads and denormals included). The indices are
    int32, as the TPU kernel's are (8 bytes moved per word, not 12). The
    plain environment's bilinear taps and importance-texel fetches go
    through it; on the card the environment's kernels (csrc/env.cu) load
    them themselves, so no render path launches it.
  * lookup_transfer_fetch(lut, sample_range, density): the transfer LUT's
    NEAREST sample with range rejection (common.glsl:78-83) as one fused
    pass; sampling.lookup_transfer is this function. `sample_range` stays
    a device tensor, so nothing waits for the card.

Dispatch is on the tensor's device: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel (or raises). There is no fallback.
"""

from __future__ import annotations

import torch

from volxel_tpu_torch import kernels

# -- gather_f32 ----------------------------------------------------------------


def gather_f32_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table.reshape(-1)[idx] (idx int32 or int64)."""
    return table.reshape(-1)[idx]


def gather_f32_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The same fetch as one launch of csrc/gather.cu, four int32 indices
    per thread step; indices outside [-numel, numel) give a zero word (the
    plain version raises there). Refuses any index type but int32."""
    kernels.require_cuda("gather_f32", table, dtype=torch.float32)
    kernels.require_cuda("gather_f32", idx, dtype=torch.int32, device=table.device)
    out = torch.empty(idx.shape, dtype=torch.float32, device=table.device)
    kernels.launch("vx_gather_f32", table, table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
                   table.numel(), counter="gather_f32")
    return out


def gather_f32(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """f32 values of `table` at flat element indices `idx` (int32, any
    shape) -> f32 of idx's shape, bit-equal to table.reshape(-1)[idx]."""
    if table.device.type == "cpu":
        return gather_f32_plain(table, idx)
    return gather_f32_cuda(table.contiguous(), idx.contiguous())


# -- the transfer LUT fetch ----------------------------------------------------


def lookup_transfer_plain(lut: torch.Tensor, sample_range, density) -> torch.Tensor:
    """NEAREST LUT sample with range rejection (common.glsl:78-83)."""
    k = lut.shape[0]
    rejected = (density < sample_range[0]) | (density > sample_range[1])
    idx = torch.clamp(torch.floor(density * k).to(torch.int64), 0, k - 1)
    return torch.where(rejected[..., None], 0.0, lut[idx])


def lookup_transfer_cuda(lut: torch.Tensor, sample_range: torch.Tensor, density: torch.Tensor) -> torch.Tensor:
    """The same sample as one launch of csrc/gather.cu, one thread per
    density value."""
    kernels.require_cuda("lookup_transfer", lut, sample_range, density, dtype=torch.float32)
    if lut.dim() != 2 or lut.shape[1] != 4 or lut.shape[0] < 1:
        raise ValueError(f"lookup_transfer: lut must be (K, 4), got {tuple(lut.shape)}")
    if lut.data_ptr() % 16:
        raise ValueError("lookup_transfer: the kernel reads 16-byte LUT rows; lut is misaligned")
    if sample_range.numel() != 2:
        raise ValueError(f"lookup_transfer: sample_range must hold 2 values, got {sample_range.numel()}")
    out = torch.empty(density.shape + (4,), dtype=torch.float32, device=lut.device)
    kernels.launch("vx_lookup_transfer", lut, lut.data_ptr(), lut.shape[0], sample_range.data_ptr(),
                   density.data_ptr(), out.data_ptr(), density.numel(), counter="lookup_transfer")
    return out


def lookup_transfer_fetch(lut: torch.Tensor, sample_range, density) -> torch.Tensor:
    """lut: (K, 4); sample_range: (2,) tensor; density: (...,) normalized by
    the majorant. Returns (..., 4): lut[clamp(floor(density * K), 0, K-1)],
    or 0 where density lies outside the sample range."""
    if density.device.type == "cpu":
        return lookup_transfer_plain(lut, sample_range, density)
    return lookup_transfer_cuda(lut.contiguous(), sample_range.contiguous(), density.contiguous())
