"""Brick-grid acceleration structure (numpy, copied from volxel_tpu.grid)."""

from volxel_tpu_torch.grid.brick import BrickGrid, construct_brick_grid  # noqa: F401
