"""Counter-based per-ray RNG: TEA seeding + xoshiro128++ streams.

PyTorch counterpart of volxel_tpu.render.rng (the reference's
shaders/random.glsl:41-94): each ray derives a 32-bit seed with the tiny
encryption algorithm from (pixel index, frame index), expands it to a
128-bit xoshiro128++ state with Wang hashes, and draws 24-bit-mantissa
floats in [0, 1).

PyTorch has no shifts or additions for uint32 on every backend, so words
are carried as int64 tensors holding values in [0, 2^32): every sum and
product is masked back to 32 bits, and right shifts of non-negative int64
are logical. The words are bit-equal to the uint32 words of the JAX
package (pinned by tests/test_torch_rng.py). State is explicit: functions
take and return `(state, value)`; a state is an (..., 4) int64 tensor.

On the card the same words are seeded and drawn by csrc/rng.cu: one launch
a seeding and one a draw call, each lane's four words in registers from
load to store, bit-equal to the plain int64 version at every lane, masked
lanes included. CPU tensors take the plain version: the path is chosen
by the tensor's device, as for every kernel of the port. The CUDA
wrappers allocate their outputs and never write into the state they are
given.
"""

from __future__ import annotations

import torch

from volxel_tpu_torch import kernels
from volxel_tpu_torch.utils.profiling import span

M32 = 0xFFFFFFFF
_INV_2_24 = 1.0 / 16777216.0


def _u32(x, device=None) -> torch.Tensor:
    """Any integer tensor/array/int -> int64 tensor of 32-bit words."""
    return torch.as_tensor(x, device=device).to(torch.int64) & M32


def _rotl(x, k: int):
    return ((x << k) | (x >> (32 - k))) & M32


def tea(val0, val1, rounds: int = 32):
    """TEA hash of two 32-bit word streams (random.glsl:41-51)."""
    v0 = _u32(val0)
    v1 = _u32(val1, v0.device)
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & M32
        v0 = (
            v0
            + ((((v1 << 4) + 0xA341316C) & M32) ^ ((v1 + s0) & M32) ^ ((v1 >> 5) + 0xC8013EA4))
        ) & M32
        v1 = (
            v1
            + ((((v0 << 4) + 0xAD90777D) & M32) ^ ((v0 + s0) & M32) ^ ((v0 >> 5) + 0x7E95761E))
        ) & M32
    return v0


def wang_hash(x):
    """Thomas Wang integer hash (random.glsl:59-67)."""
    x = _u32(x)
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & M32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & M32
    x = x ^ (x >> 15)
    return x


def seed_xoshiro(seed):
    """Expand 32-bit seeds (...,) to xoshiro states (..., 4) (random.glsl:69-76)."""
    seed = _u32(seed)
    return torch.stack([wang_hash((seed + i) & M32) for i in range(4)], dim=-1)


def next_u32(state):
    """xoshiro128++ step (random.glsl:80-94): (state) -> (state', word)."""
    s0, s1, s2, s3 = state[..., 0], state[..., 1], state[..., 2], state[..., 3]
    result = (_rotl((s0 + s2) & M32, 7) + s0) & M32
    t = (s1 << 9) & M32
    s2 = s2 ^ s0
    s3 = s3 ^ s1
    s1 = s1 ^ s2
    s0 = s0 ^ s3
    s2 = s2 ^ t
    s3 = _rotl(s3, 11)
    return torch.stack([s0, s1, s2, s3], dim=-1), result


def _rng(state):
    state, r = next_u32(state)
    return state, (r >> 8).to(torch.float32) * _INV_2_24


def _rng2(state):
    state, a = _rng(state)
    state, b = _rng(state)
    return state, torch.stack([a, b], dim=-1)


def _rng3(state):
    state, a = _rng(state)
    state, b = _rng(state)
    state, c = _rng(state)
    return state, torch.stack([a, b, c], dim=-1)


def draw_plain(state, k: int, mask=None):
    """k in 1..3 draws a lane in plain PyTorch, on any device; with `mask`
    the lanes where it is False keep their words (draw_cuda)."""
    state2, x = (_rng, _rng2, _rng3)[k - 1](state)
    if mask is None:
        return state2, x
    return torch.where(mask[..., None], state2, state), x


def draw_cuda(state: torch.Tensor, k: int, mask: torch.Tensor | None = None):
    """k in 1..3 draws a lane of an (..., 4) int64 state on the card, one
    launch of csrc/rng.cu -> (state', value (...) for k = 1, else (..., k)),
    bit-equal to the plain version; with `mask` (bool, broadcast to the
    state's lanes) lanes where it is False keep their words, and the value
    is written on every lane."""
    if state.dtype != torch.int64 or state.shape[-1:] != (4,):
        raise ValueError(f"rng_draw: expected an (..., 4) int64 state, got {tuple(state.shape)} {state.dtype}")
    if k not in (1, 2, 3):
        raise ValueError(f"rng_draw: k must be 1, 2 or 3, got {k}")
    lanes = state.shape[:-1]
    state = state.contiguous()
    if mask is not None:
        if mask.dtype != torch.bool:
            raise ValueError(f"rng_draw: expected a bool mask, got {mask.dtype}")
        mask = mask.expand(lanes).contiguous()
        kernels.require_cuda("rng_draw", state, mask)
    else:
        kernels.require_cuda("rng_draw", state)
    if state.data_ptr() % 16:
        state = state.clone()  # a lane's words are loaded as two 16-byte words
    state_out = torch.empty_like(state)
    out = torch.empty((*lanes, k) if k > 1 else lanes, dtype=torch.float32, device=state.device)
    n = out.numel() // k
    if n:
        kernels.launch("vx_rng_draw", state, state.data_ptr(), None if mask is None else mask.data_ptr(),
                       state_out.data_ptr(), out.data_ptr(), k, n, counter="rng_draw")
    return state_out, out


def _draw(state, k: int, mask=None):
    if state.device.type == "cpu":
        return draw_plain(state, k, mask)
    return draw_cuda(state, k, mask)


def rng(state):
    """Draw float32 in [0, 1) from the top 24 bits (random.glsl:103-106)."""
    with span("vx::rng"):
        return _draw(state, 1)


def rng2(state):
    with span("vx::rng"):
        return _draw(state, 2)


def rng3(state):
    with span("vx::rng"):
        return _draw(state, 3)


def rng_where(mask, state):
    """Masked draw: lanes where mask is False do NOT consume the draw.

    The GLSL consumes draws conditionally (inside `if` bodies and after
    early returns), so per-lane stream parity with the reference needs
    conditional consumption, not just conditional use. The returned value
    is meaningful only where mask is True.
    """
    with span("vx::rng"):
        return _draw(state, 1, mask)


def rng2_where(mask, state):
    with span("vx::rng"):
        return _draw(state, 2, mask)


def rng3_where(mask, state):
    with span("vx::rng"):
        return _draw(state, 3, mask)


def seed_rays_plain(pixel_index, frame_index):
    """seed_rays in plain PyTorch, on any device."""
    pixel_index = _u32(pixel_index)
    if isinstance(frame_index, torch.Tensor):
        frame = _u32(frame_index, pixel_index.device).expand_as(pixel_index)
    else:
        frame = torch.full_like(pixel_index, int(frame_index) & M32)
    return seed_xoshiro(tea((42 * pixel_index) & M32, frame))


def seed_rays_cuda(pixel_index: torch.Tensor, frame_index) -> torch.Tensor:
    """seed_rays on the card, one launch of csrc/rng.cu, bit-equal to the
    plain version: int32 or int64 pixel indices of any shape; the frame an
    int or an int32 / int64 tensor that broadcasts to them (one frame a
    lane is read from the card)."""
    for name, t in (("pixel indices", pixel_index), ("frames", frame_index)):
        if isinstance(t, torch.Tensor) and t.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"rng_seed: expected int32 or int64 {name}, got {t.dtype}")
    pixel = pixel_index.contiguous()
    kernels.require_cuda("rng_seed", pixel)
    frame, frame_bytes, frame_word = None, 8, 0
    if isinstance(frame_index, torch.Tensor):
        frame = frame_index.to(pixel.device).expand(pixel.shape).contiguous()
        frame_bytes = frame.element_size()
    else:
        frame_word = int(frame_index) & M32
    state = torch.empty((*pixel.shape, 4), dtype=torch.int64, device=pixel.device)
    if pixel.numel():
        kernels.launch("vx_rng_seed", pixel, pixel.data_ptr(), pixel.element_size(),
                       None if frame is None else frame.data_ptr(), frame_bytes, frame_word,
                       state.data_ptr(), pixel.numel(), counter="rng_seed")
    return state


def seed_rays(pixel_index, frame_index):
    """Per-ray state from pixel index + frame (fragment.frag:143-144).
    frame_index is one frame for every ray (an int) or a tensor of one
    frame per ray, as a batch of views gives (parallel.multiview)."""
    with span("vx::rng"):
        if isinstance(pixel_index, torch.Tensor) and pixel_index.device.type != "cpu":
            return seed_rays_cuda(pixel_index, frame_index)
        return seed_rays_plain(pixel_index, frame_index)
