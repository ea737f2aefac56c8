"""Device-mesh construction: the PyTorch counterpart of
volxel_tpu.parallel.mesh.

The reference is single-GPU; its only parallelism is a Web Worker and the
implicit per-pixel SIMT of the fragment shader. Here the scaling axes are
explicit, with the JAX package's names:

  'sp' — sample parallelism: each position renders a different
         progressive sample index of the same frame; the samples are
         summed in position order and divided by sp (pmean = psum / n).
  'px' — pixel parallelism: the ray wavefront is split into contiguous
         blocks of pixels (whole rows when the width divides the block),
         one per position along this axis.
  'vz' — volume z-slabs (parallel/volshard.py): the dense field is cut
         into z-slabs, one per position along the axis, and each pixel
         block is split once more among those positions, whose lanes
         read every tap from the slab that owns it.

A mesh is a numpy array of positions of shape (sp, px) or (sp, px, vz),
with the axis names and a `.shape` dict, as a jax.sharding.Mesh is. Each
position is a torch.device and the process (torch.distributed rank) that
owns it. One process drives every position it owns, one after another
(the JAX package's single controller); positions that name the same card
share it, which is how one card or the CPU drives a 2x2 mesh. The
processes may be one a host, each owning its host's cards, or one a
card on a node (`torchrun --nproc-per-node=N`), whose mesh names each
position's process and card explicitly:
`make_mesh(vz=N, devices=[(rank, f"cuda:{rank}") for rank in range(N)])`
(multihost.global_devices raises there, rather than guess). Processes
combine their positions' results with one torch.distributed collective
(parallel/shard.py).
"""

from __future__ import annotations

import numpy as np
import torch

from volxel_tpu_torch.parallel import multihost


class Mesh:
    """Positions (torch.devices) in an array with named axes; `processes`
    gives each position's owning rank, `shape` maps each axis name to its
    size (`mesh.shape["sp"]`)."""

    def __init__(self, devices: np.ndarray, processes: np.ndarray, axis_names: tuple[str, ...]):
        if devices.shape != processes.shape or devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} with owners {processes.shape} and axes {axis_names}")
        self.devices = devices
        self.processes = processes
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def positions(self) -> list[tuple[int, ...]]:
        """Every position's index, in row-major (rank) order."""
        return list(np.ndindex(self.devices.shape))

    def local_positions(self) -> list[tuple[int, ...]]:
        """The positions this process owns, in row-major order."""
        rank = multihost.process_index()
        return [pos for pos in self.positions() if int(self.processes[pos]) == rank]

    def local_devices(self) -> list[torch.device]:
        """The distinct devices of this process's positions, first seen first."""
        seen: list[torch.device] = []
        for pos in self.local_positions():
            if self.devices[pos] not in seen:
                seen.append(self.devices[pos])
        return seen

    def _owned(self) -> list[tuple[int, str]]:
        return [(int(r), str(d)) for r, d in zip(self.processes.flat, self.devices.flat)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self._owned()})"


def _position(spec) -> tuple[int, torch.device]:
    """(rank, device) of a position given as a device (this process's) or
    as a (rank, device) pair."""
    if isinstance(spec, tuple):
        rank, device = spec
        return int(rank), _device(device)
    return multihost.process_index(), _device(spec)


def _device(spec) -> torch.device:
    device = torch.device(spec)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(sp: int = 1, px: int | None = None, vz: int = 1, devices=None) -> Mesh:
    """Build an (sp, px[, vz]) mesh over `devices`.

    `devices` defaults to every card of this process or, once
    multihost.initialize_multihost has joined processes, every card of
    every process in rank order (which raises where several processes of
    a node each see several cards: one process a card names its
    positions, `[(rank, f"cuda:{local}"), ...]`); it raises when there is
    none, and never falls back to the CPU: a caller that wants the CPU
    names its positions (`[torch.device("cpu")] * 4`). An entry is a device of this
    process, or a (rank, device) pair for a position another process
    owns; a device named more than once gives several positions that run
    on it one after another. px defaults to len(devices) // (sp * vz);
    the 'vz' axis is only added when vz > 1."""
    if devices is None:
        positions = multihost.global_devices()
        if not positions:
            raise RuntimeError("make_mesh: no CUDA device; name the positions with devices= "
                               "(e.g. [torch.device('cpu')] * 4) to build a mesh without a card")
    else:
        positions = [_position(d) for d in devices]
    if px is None:
        px = len(positions) // (sp * vz)
    if sp * px * vz != len(positions):
        raise ValueError(f"mesh {sp}x{px}" + (f"x{vz}" if vz > 1 else "") + f" != {len(positions)} devices")
    shape, names = ((sp, px, vz), ("sp", "px", "vz")) if vz > 1 else ((sp, px), ("sp", "px"))
    ranks = np.array([r for r, _ in positions], dtype=np.int64).reshape(shape)
    devs = np.empty(len(positions), dtype=object)
    devs[:] = [d for _, d in positions]
    return Mesh(devs.reshape(shape), ranks, names)
