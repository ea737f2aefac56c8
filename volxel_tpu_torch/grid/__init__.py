"""Brick-grid acceleration structure (numpy, copied from volxel_tpu.grid)."""

import dataclasses

import numpy as np

from volxel_tpu_torch.grid.brick import BrickGrid, construct_brick_grid  # noqa: F401


def _leaves(name: str, value):
    """(name, value) of each array of a field (range_mips' levels one by
    one), or of the field itself when it holds no array."""
    if isinstance(value, (list, tuple)) and any(isinstance(v, (np.ndarray, list, tuple)) for v in value):
        for i, v in enumerate(value):
            yield from _leaves(f"{name}[{i}]", v)
    else:
        yield name, value


def grid_differences(a, b) -> list[str]:
    """The fields of two brick grids that differ: an array in dtype, shape
    or any bit, any other field in value."""
    differ = []
    for f in dataclasses.fields(a):
        ours, theirs = list(_leaves(f.name, getattr(a, f.name))), list(_leaves(f.name, getattr(b, f.name)))
        if [n for n, _ in ours] != [n for n, _ in theirs]:
            differ.append(f.name)
            continue
        for (name, x), (_, y) in zip(ours, theirs):
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                same = (isinstance(x, np.ndarray) and isinstance(y, np.ndarray) and x.dtype == y.dtype
                        and x.shape == y.shape and x.tobytes() == y.tobytes())
            else:
                same = x == y
            if not same:
                differ.append(name)
    return differ
