"""Render-time volume slabs: the dense field in z-slabs over a mesh axis,
the PyTorch counterpart of volxel_tpu.parallel.volshard.

The bulk operand is the decoded dense field (a 512^3 bf16 field is
256 MiB, 2048^3 is 16 GiB); the majorant pyramid and the extent are
metadata and stay replicated. Over a mesh axis of n positions ('vz' by
default) the field is cut into n z-slabs of ceil(Z / n) slices, and slab v
lies, with SLAB_HALO (= 2) slices of each neighbour on either side (zeros
beyond the field), on the card of each position whose index on the axis
is v. The halo is the reference's brick dilation half-width
(brick.rs:101-103); it holds every tap of a trilinear stencil and of the
stochastic tricubic pick whose base cell a slab owns.

The JAX package replicates the ray state over the axis, answers each tap
on the device that owns it and combines the answers with a psum. Here a
leg is one launch that marches each lane to its end, so no collective can
run inside it: position (s, p, v) renders the v-th of n parts of pixel
block p, and its lanes read every tap from the owner's slab, a plain load
through a table of the slabs' device pointers on its card (a peer load
over NVLink where the owner's card is another one). Seeds are keyed by
global pixel and sample, so the frames are bit-equal to those of the
replicated field (tests/test_torch_volshard.py).

A card named by several positions of the axis holds each slab once; the
positions (s, p, ·) on other cards hold copies of their own, as the JAX
package replicates a slab over 'sp' and 'px'. A slab axis whose positions
span processes is not ported (ROADMAP.md, queue 1, "Slabs across
processes").
"""

from __future__ import annotations

import torch

from volxel_tpu_torch.grid.brick import BrickGrid
from volxel_tpu_torch.parallel import multihost
from volxel_tpu_torch.parallel.mesh import Mesh
from volxel_tpu_torch.parallel.slab import _halo_exchange_z
from volxel_tpu_torch.render.sampling import (
    SLAB_HALO,
    DeviceGrid,
    SlabGrid,
    build_majorant_pyramid,
    decode_dense_rows_device,
    slabs_written,
)
from volxel_tpu_torch.utils.mathutil import div_round_up

SLABS_ACROSS_PROCESSES = ("a slab axis whose positions span processes (slabs read across processes, through CUDA "
                          "IPC handles within a node) is not ported yet: ROADMAP.md, queue 1, 'Slabs across "
                          "processes'")
# brick z-rows decoded at once when a slab is built from the brick grid: the
# decode's f32 scratch stays a few times these rows' bytes
DECODE_ROWS = 2


def rows_along(mesh: Mesh, axis: str) -> list[tuple[tuple, list[tuple]]]:
    """Every row of `mesh` along `axis`: (the position's index without the
    axis, the row's positions in axis order), in row-major order. Raises
    NotImplementedError where a row's positions span processes."""
    k = mesh.axis_names.index(axis)
    rows = []
    for pos in mesh.positions():
        if pos[k]:
            continue
        row = pos[:k] + pos[k + 1:]
        along = [pos[:k] + (v,) + pos[k + 1:] for v in range(mesh.shape[axis])]
        if len({int(mesh.processes[q]) for q in along}) > 1:
            raise NotImplementedError(SLABS_ACROSS_PROCESSES)
        rows.append((row, along))
    return rows


class SlabbedVolume:
    """A grid's dense field in halo'd z-slabs over a mesh axis, and the
    replicated rest.

    `slabs` maps (card, v) to slab v, (slab + 2 * SLAB_HALO, Y, X) bf16 on
    that card, for each card of this process that a position with index v
    on `axis` names. `meta` is the DeviceGrid without its field (dense is
    None): the majorant pyramid and the extent. A mesh step moves `meta` to
    each card like any operand (parallel.shard) and hands each position
    its `local_grid`."""

    def __init__(self, slabs: dict, meta: DeviceGrid, mesh: Mesh, axis: str, slab: int,
                 tap_dtype: str = "float32"):
        self.slabs = slabs
        self.meta = meta
        self.mesh = mesh
        self.axis = axis
        self.slab = slab
        self.tap_dtype = tap_dtype
        self._tables: dict[tuple, dict] = {}  # a row's cards -> its SlabGrids' pointer tables, per card
        self._ready = dict(zip(slabs, slabs_written(slabs.values())))  # (card, v) -> slab v written there

    def local_grid(self, position: tuple | None = None, meta: DeviceGrid | None = None) -> SlabGrid:
        """The SlabGrid that position `position`'s lanes read (this
        process's first position by default): the slabs of its row along
        the axis, and `meta`'s pyramids and extent (the card's copy of
        `self.meta`, with its premultiplied pyramid, by default self.meta)."""
        pos = tuple(position) if position is not None else self.mesh.local_positions()[0]
        k = self.mesh.axis_names.index(self.axis)
        cards = tuple(self.mesh.devices[pos[:k] + (v,) + pos[k + 1:]] for v in range(self.mesh.shape[self.axis]))
        meta = self.meta if meta is None else meta
        keys = [(card, v) for v, card in enumerate(cards)]
        return SlabGrid([self.slabs[k] for k in keys], self.slab, meta.maj_mips, meta.extent, self.tap_dtype,
                        maj_alpha=meta.maj_alpha, tables=self._tables.setdefault(cards, {}),
                        ready=[self._ready[k] for k in keys])


def _local_rows(mesh: Mesh, axis: str) -> list[list[torch.device]]:
    """The cards along `axis` of each of this process's rows, each list of
    cards once."""
    mine = mesh.local_positions()
    seen = []
    for _, along in rows_along(mesh, axis):
        cards = [mesh.devices[q] for q in along]
        if along[0] in mine and cards not in seen:
            seen.append(cards)
    return seen


def build_slabbed_volume(grid: DeviceGrid, mesh: Mesh, axis: str = "vz", tap_dtype: str = "float32") -> SlabbedVolume:
    """Cut a DeviceGrid's dense field into halo'd z-slabs over `axis`:
    each slab copied to its cards, the halos taken from the neighbouring
    slabs by parallel.slab._halo_exchange_z (zeros at the field's ends).
    `tap_dtype="bfloat16"` rounds each trilinear sum to bf16 (SlabGrid)."""
    if grid.dense is None:
        raise ValueError("volume slabs from a DeviceGrid need its dense field; for volumes too large to decode on "
                         "one card use build_slabbed_volume_from_brick(host_brick_grid, mesh)")
    n = mesh.shape[axis]
    z, y, x = grid.dense.shape
    slab = div_round_up(z, n)
    slabs = {}
    for cards in _local_rows(mesh, axis):
        if all((card, v) in slabs for v, card in enumerate(cards)):
            continue
        local = {}
        for v, card in enumerate(cards):
            part = torch.zeros((slab, y, x), dtype=torch.bfloat16, device=card)
            rows = grid.dense[v * slab:(v + 1) * slab]
            part[:rows.shape[0]] = rows
            local[v] = part
        # every slab of the row is this process's (rows_along), so the
        # exchange only copies
        for v, halod in _halo_exchange_z(local, [multihost.process_index()] * n).items():
            slabs.setdefault((cards[v], v), halod)
    return SlabbedVolume(slabs, grid._replace(dense=None), mesh, axis, slab, tap_dtype)


def build_slabbed_volume_from_brick(grid: BrickGrid, mesh: Mesh, axis: str = "vz", tap_dtype: str = "float32",
                                    maj_dtype: str = "float32") -> SlabbedVolume:
    """Build a SlabbedVolume straight from a host BrickGrid, never holding
    the whole dense field: each halo'd slab is decoded on its card from its
    own brick rows and its halos' (sampling.decode_dense_rows_device,
    DECODE_ROWS brick rows at a time), so a card's peak is one slab and the
    scratch of a few rows. Zeros beyond the field, as the halo exchange
    gives, so the slabs are bit-equal to build_slabbed_volume's of the
    decoded field. `meta` holds the majorant pyramid and the extent, and
    nothing volume-sized. `maj_dtype` is there for the JAX package's
    signature: the port's pyramid is float32, and any other value raises."""
    if maj_dtype != "float32":
        raise ValueError(f"the port's majorant pyramid is float32; maj_dtype {maj_dtype!r} is not ported")
    bx, by, bz = grid.brick_count
    z, y, x = bz * 8, by * 8, bx * 8
    n = mesh.shape[axis]
    slab = div_round_up(z, n)
    slabs = {}
    for cards in _local_rows(mesh, axis):
        for v, card in enumerate(cards):
            if (card, v) in slabs:
                continue
            z0 = v * slab - SLAB_HALO
            block = torch.zeros((slab + 2 * SLAB_HALO, y, x), dtype=torch.bfloat16, device=card)
            lo, hi = max(z0, 0), min(z0 + block.shape[0], z)
            for b in range(lo >> 3, (hi + 7) >> 3, DECODE_ROWS):
                b1 = min(b + DECODE_ROWS, (hi + 7) >> 3)
                rows = decode_dense_rows_device(grid, b, b1, card)
                s0, s1 = max(lo, b * 8), min(hi, b1 * 8)
                block[s0 - z0:s1 - z0] = rows[s0 - b * 8:s1 - b * 8]
                del rows
            slabs[(card, v)] = block
    first = (mesh.local_devices() or [torch.device("cpu")])[0]
    meta = DeviceGrid(dense=None, maj_mips=torch.from_numpy(build_majorant_pyramid(grid)).to(first),
                      extent=tuple(int(v) for v in grid.index_extent))
    return SlabbedVolume(slabs, meta, mesh, axis, slab, tap_dtype)
