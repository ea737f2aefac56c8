"""Carry scene state from the JAX package into the port.

`from_jax_state` takes the JAX package's DeviceGrid, VolumeParams, LUT and
EnvState with their arrays already converted to numpy (for example with
`jax.tree_util.tree_map(numpy.asarray, ...)`) and returns the port's
counterparts on `device`. It reads fields by name and imports nothing of
the JAX package, so the port and the reference can render from one state.
"""

from __future__ import annotations

import numpy as np
import torch

from volxel_tpu_torch.render.sampling import DeviceGrid, VolumeParams, decode_dense_device
from volxel_tpu_torch.scene.environment import EnvState


def _tensor(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)  # a copy: jax arrays are read-only


def _bf16(a, device) -> torch.Tensor:
    """A numpy bfloat16 array (ml_dtypes) -> torch bfloat16, bit for bit."""
    bits = np.array(a).view(np.int16)
    return torch.from_numpy(bits).to(device).view(torch.bfloat16)


def from_jax_state(grid, params, lut, env, device):
    """(DeviceGrid, VolumeParams, lut, EnvState) of the JAX package, as
    numpy arrays -> the port's (DeviceGrid, VolumeParams, lut, EnvState).

    The dense bf16 field is taken as it is when present, else decoded from
    the brick atlas on `device` (bit-equal to the JAX decode).
    """
    if getattr(grid, "dense", None) is not None:
        dense = _bf16(grid.dense, device)
    else:
        dense = decode_dense_device(
            _tensor(grid.atlas, device, torch.uint8),
            _tensor(grid.range_lo, device),
            _tensor(grid.range_hi, device),
            _tensor(grid.ptr, device, torch.int32),
        )
    t_grid = DeviceGrid(
        dense=dense,
        maj_mips=_tensor(grid.maj_mips, device),
        extent=tuple(int(v) for v in np.asarray(grid.extent)),
    )
    t_params = VolumeParams(*(_tensor(getattr(params, f), device) for f in VolumeParams._fields))
    t_env = EnvState(
        envmap=_tensor(env.envmap, device),
        imp_mips=tuple(_tensor(m, device) for m in env.imp_mips),
        strength=_tensor(env.strength, device),
    )
    return t_grid, t_params, _tensor(lut, device), t_env
