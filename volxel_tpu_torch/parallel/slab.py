"""Brick-range construction split by z-slabs with halos: the PyTorch
counterpart of volxel_tpu.parallel.slab.

The reference builds its acceleration structure on the host, serialized
(brick.rs:90). Here the dilated per-brick min/max (brick.rs:99-112) runs
on the mesh: the dense volume is split into z-slabs along one mesh axis,
each slab takes its neighbours' 2-voxel boundary slices (the dilation
half-width, exactly the halo the reference's window [-2, BRICK+2) needs)
and reduces its own bricks with a 12-voxel window at stride 8. This is a
load-time reduction with no TPU kernel behind it, so plain PyTorch
(max_pool3d) is its port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from volxel_tpu_torch.grid.encoding import BRICK_SIZE, NUM_MIPMAPS
from volxel_tpu_torch.parallel import multihost
from volxel_tpu_torch.parallel.mesh import Mesh
from volxel_tpu_torch.utils.mathutil import div_round_up

HALO = 2  # dilation half-width (brick.rs:101-103)


def _halo_exchange_z(slabs: dict, owners: list[int]) -> dict:
    """[previous slab's last HALO slices, slab, next slab's first HALO
    slices] for each slab this process holds: `slabs` maps slab i of
    len(owners) (process owners[i] holds it) to its tensor. Between this
    process's slabs a copy; with another process's one send and one
    receive each way (multihost.exchange). The first and last slabs get
    zeros on their outer side (out-of-extent lookups read 0.0,
    dicom.rs:8-10)."""
    n = len(owners)
    halos, sends, recvs = {}, [], []
    for i, local in slabs.items():
        below, above = torch.zeros_like(local[:HALO]), torch.zeros_like(local[:HALO])
        for j, halo, theirs, mine in ((i - 1, below, slice(-HALO, None), slice(None, HALO)),
                                      (i + 1, above, slice(None, HALO), slice(-HALO, None))):
            if not 0 <= j < n:
                continue
            if j in slabs:
                halo.copy_(slabs[j][theirs])
            else:  # tag: the sending slab, and whether it sends upward
                recvs.append((halo, owners[j], 2 * j + int(j < i)))
                sends.append((local[mine], owners[j], 2 * i + int(i < j)))
        halos[i] = (below, above)
    if sends or recvs:
        multihost.exchange(sends, recvs)
    return {i: torch.cat([halos[i][0], local, halos[i][1]]) for i, local in slabs.items()}


def _slab_ranges(local: torch.Tensor):
    """Per-brick dilated min/max of one halo'd z-slab (Z + 4, Y + 4, X + 4)."""
    window = BRICK_SIZE + 2 * HALO
    x = local[None, None]
    lo = -F.max_pool3d(-x, window, BRICK_SIZE)[0, 0]
    hi = F.max_pool3d(x, window, BRICK_SIZE)[0, 0]
    return lo, hi


def brick_ranges_sharded(volume: np.ndarray, mesh: Mesh, axis: str = "px"):
    """Dilated per-brick (min, max) of a dense (Z, Y, X) volume on a mesh.

    The volume is zero-padded to the aligned brick extent and split in z
    over `axis`: slab i lies on the position with index i on `axis` and 0
    on the other axes. Returns host numpy (bz, by, bx) arrays matching the
    reference window semantics exactly (pre-f16-rounding), on every
    process, and (bx, by, bz)."""
    n_shards = mesh.shape[axis]
    ez, ey, ex = volume.shape
    align = 1 << NUM_MIPMAPS
    bx = div_round_up(div_round_up(ex, BRICK_SIZE), align) * align
    by = div_round_up(div_round_up(ey, BRICK_SIZE), align) * align
    bz = div_round_up(div_round_up(ez, BRICK_SIZE), align) * align
    if bz % n_shards != 0:
        # round the z brick count up so slabs divide evenly
        bz = div_round_up(bz, n_shards * align) * n_shards * align

    full = np.zeros((bz * BRICK_SIZE, by * BRICK_SIZE + 2 * HALO, bx * BRICK_SIZE + 2 * HALO), np.float32)
    full[:ez, HALO:HALO + ey, HALO:HALO + ex] = volume

    k = mesh.axis_names.index(axis)
    where = [tuple(i if a == k else 0 for a in range(len(mesh.axis_names))) for i in range(n_shards)]
    owners = [int(mesh.processes[pos]) for pos in where]
    rank = multihost.process_index()
    slab = full.shape[0] // n_shards
    slabs = {i: torch.from_numpy(full[i * slab:(i + 1) * slab]).to(mesh.devices[where[i]])
             for i in range(n_shards) if owners[i] == rank}
    ranges = {i: torch.stack(_slab_ranges(local)) for i, local in _halo_exchange_z(slabs, owners).items()}
    device = (mesh.local_devices() or [torch.device("cpu")])[0]
    blocks = multihost.gather_owned(owners, ranges, (2, slab // BRICK_SIZE, by, bx), device)
    lo, hi = torch.cat(blocks, dim=1).cpu().numpy()
    return lo, hi, (bx, by, bz)
