"""The single-position replay that the port's mesh checks hold a sharded
step and a DistributedRenderer to, shared by tests/test_torch_parallel.py
(CPU), tests/test_torch_cuda.py (card) and chip_smoke.py (phase 2d).
Imports neither JAX nor volxel_tpu."""

from __future__ import annotations

import torch

from volxel_tpu_torch.render.pathtrace import render_sample


def renderer_operands(r) -> tuple:
    """(config, grid, params, lut, env, inv_view, inv_proj, light_dir) of
    renderer `r`'s next sample, as render_sample takes them."""
    config = r._config()
    return (config, r._device_grid, r.volume_params(), r._lut, r.environment.state, *r._camera_operands(config))


def step_mean(ops: tuple, step: int, sp: int) -> torch.Tensor:
    """The mean of single-position samples [step * sp, step * sp + sp):
    render_sample(*ops, i) summed in position order, then divided by sp."""
    acc = render_sample(*ops, step * sp)
    for s in range(1, sp):
        acc = acc + render_sample(*ops, step * sp + s)
    return acc / sp


def replayed_framebuffer(r, steps: int) -> torch.Tensor:
    """The framebuffer of `steps` steps of DistributedRenderer `r`,
    replayed over single-position samples on r's device: each step's
    step_mean folded in as (count * fb + sp * mean) / (count + sp)."""
    ops = renderer_operands(r)
    fb = torch.zeros((ops[0].width * ops[0].height, 3), dtype=torch.float32, device=r.device)
    for step in range(steps):
        count = step * r.sp
        fb = (count * fb + r.sp * step_mean(ops, step, r.sp)) / (count + r.sp)
    return fb
