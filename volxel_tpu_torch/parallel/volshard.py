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
package replicates a slab over 'sp' and 'px'. A row whose positions lie
on several processes of one node (one process a card, multihost) has
each process build only the slabs of its own positions and map the
others' into its address space (parallel/nodeshare.py: CUDA IPC on the
cards, shared memory on the CPU), never a copy; the processes then render
their own parts of the row, which parallel.shard gathers part by part.
Such a volume is released by all its processes together
(SlabbedVolume.release).

A row whose processes span nodes (`torchrun --nnodes=N
--nproc-per-node=8`, or one process a host on several hosts) shares slabs
within each node as above and none across nodes: a slab on another node is
absent from the SlabGrid (None, a null pointer in its table). A lane about
to read it parks and moves to the process that owns it, which resumes it
(parallel.migrate); SlabbedVolume records each row's owners and process
groups for that (`rows`). Every process of such a row owns as many of its
positions, so that their leg calls line up (rows_along raises otherwise);
make_mesh's defaults give that on nodes of equal card counts.
"""

from __future__ import annotations

import torch

from volxel_tpu_torch.grid.brick import BrickGrid
from volxel_tpu_torch.parallel import multihost
from volxel_tpu_torch.parallel.mesh import Mesh
from volxel_tpu_torch.parallel.migrate import Row
from volxel_tpu_torch.parallel.nodeshare import NodeShares
from volxel_tpu_torch.render.sampling import (
    SLAB_HALO,
    DeviceGrid,
    SlabGrid,
    build_majorant_pyramid,
    decode_dense_rows_device,
    slabs_written,
)
from volxel_tpu_torch.utils.mathutil import div_round_up

# brick z-rows decoded at once when a slab is built from the brick grid: the
# decode's f32 scratch stays a few times these rows' bytes
DECODE_ROWS = 2


def rows_along(mesh: Mesh, axis: str) -> list[tuple[tuple, list[tuple], list[list[int]]]]:
    """Every row of `mesh` along `axis`: (the position's index without the
    axis, the row's positions in axis order, its node groups: the indices
    along the axis of the positions on each node, nodes in order of first
    position), in row-major order. Raises ValueError where a row's
    processes span nodes and do not each own as many of its positions (the
    equal-positions rule: their leg calls must line up, parallel.migrate)."""
    k = mesh.axis_names.index(axis)
    rows = []
    for pos in mesh.positions():
        if pos[k]:
            continue
        row = pos[:k] + pos[k + 1:]
        along = [pos[:k] + (v,) + pos[k + 1:] for v in range(mesh.shape[axis])]
        owners = [int(mesh.processes[q]) for q in along]
        nodes: dict[str, list[int]] = {}
        for v, owner in enumerate(owners):
            nodes.setdefault(multihost.node_of(owner), []).append(v)
        if len(nodes) > 1 and len({owners.count(r) for r in owners}) > 1:
            raise ValueError(f"the {axis} row {row} spans nodes with processes {owners} along it: a row across "
                             "nodes needs every process to own the same number of its positions (the "
                             "equal-positions rule), so that their leg calls line up")
        rows.append((row, along, list(nodes.values())))
    return rows


def spans_processes(mesh: Mesh, axis: str) -> bool:
    """Whether a row of `mesh` along `axis` has positions on several
    processes."""
    return any(len({int(mesh.processes[q]) for q in along}) > 1 for _, along, _ in rows_along(mesh, axis))


class SlabbedVolume:
    """A grid's dense field in halo'd z-slabs over a mesh axis, and the
    replicated rest.

    `slabs` maps (card, v) to slab v, (slab + 2 * SLAB_HALO, Y, X) bf16 on
    that card, for each slab that a row of this process reads: one that
    this process built for a position it owns, or one that another process
    of the node owns, mapped (parallel.nodeshare) on the card of this
    process that reads it (the mapping lives in that card's context; the
    bytes stay on the owner's card). `meta` is the DeviceGrid without its
    field (dense is None): the majorant pyramid and the extent. A mesh step
    moves `meta` to each card like any operand (parallel.shard) and hands
    each position its `local_grid`."""

    def __init__(self, slabs: dict, meta: DeviceGrid, mesh: Mesh, axis: str, slab: int, tap_dtype: str = "float32",
                 mapped: frozenset = frozenset(), shares: NodeShares | None = None, rows: dict | None = None):
        self.slabs = slabs
        self.meta = meta
        self.mesh = mesh
        self.axis = axis
        self.slab = slab
        self.tap_dtype = tap_dtype
        self.mapped = mapped  # the keys of `slabs` that other processes own
        self._shares = shares
        self.rows = rows or {}  # each row across nodes that this process is in (index without the axis) -> its Row
        self._tables: dict[tuple, dict] = {}  # a row's slab keys -> its SlabGrids' pointer tables, per card
        self._ready = dict(zip(slabs, slabs_written(slabs.values())))  # (card, v) -> slab v written there

    def local_grid(self, position: tuple | None = None, meta: DeviceGrid | None = None) -> SlabGrid:
        """The SlabGrid that position `position`'s lanes read (this
        process's first position by default): the slabs of its row along
        the axis (None for one on another node, with the row's migrate.Row),
        and `meta`'s pyramids and extent (the card's copy of `self.meta`,
        with its premultiplied pyramid, by default self.meta)."""
        pos = tuple(position) if position is not None else self.mesh.local_positions()[0]
        keys = tuple(_slab_key(self.mesh, self.axis, pos, v) for v in range(self.mesh.shape[self.axis]))
        meta = self.meta if meta is None else meta
        k = self.mesh.axis_names.index(self.axis)
        return SlabGrid([None if key is None else self.slabs[key] for key in keys], self.slab, meta.maj_mips,
                        meta.extent, self.tap_dtype, maj_alpha=meta.maj_alpha,
                        tables=self._tables.setdefault(keys, {}),
                        ready=[None if key is None else self._ready[key] for key in keys],
                        row=self.rows.get(pos[:k] + pos[k + 1:]))

    def release(self) -> None:
        """Drop the slabs. Where they are shared between processes this is
        collective, and every process of the mesh calls it: each
        synchronizes the cards that read the slabs, closes its mappings and
        waits for the others before the owners free their blocks
        (parallel.nodeshare's rules). Callers drop any SlabGrid they keep
        first."""
        shares, self._shares = self._shares, None
        if shares is not None:
            for card in self.mesh.local_devices():
                if card.type == "cuda":
                    torch.cuda.synchronize(card)
        self.slabs, self._ready, self._tables = {}, {}, {}
        if shares is not None:
            shares.close()


def _slab_key(mesh: Mesh, axis: str, reader: tuple, v: int) -> tuple | None:
    """The key in SlabbedVolume.slabs of slab v as position `reader` reads
    it: on the card of the row's position v where this process owns that
    position, else mapped on the reader's own card; None where that
    position lies on another node."""
    k = mesh.axis_names.index(axis)
    q = reader[:k] + (v,) + reader[k + 1:]
    owner, rank = int(mesh.processes[q]), multihost.process_index()
    if owner == rank:
        return (mesh.devices[q], v)
    return (mesh.devices[reader], v) if multihost.same_node({owner, rank}) else None


def _node_slabs(mesh: Mesh, axis: str, make) -> dict:
    """SlabbedVolume's slabs, mapped keys, shares and rows for this
    process: make(v, card) builds slab v on `card` for each card of a
    position this process owns (once a card). Where a row has several
    processes on one node, the slabs are exported, the records exchanged
    and each slab of another process of this node that a row of this
    process reads is mapped on the reading card (where this process holds
    slab v on that card itself, it reads its own). A row across nodes gets
    its process groups (every process asks for every such row's, in row
    order) and, where this process is in it, a migrate.Row."""
    rank = multihost.process_index()

    def owner(q):
        return int(mesh.processes[q])

    every = rows_along(mesh, axis)
    rows = [along for _, along, _ in every if any(owner(q) == rank for q in along)]
    slabs = {}
    for along in rows:
        for v, q in enumerate(along):
            if owner(q) == rank and (mesh.devices[q], v) not in slabs:
                slabs[(mesh.devices[q], v)] = make(v, mesh.devices[q])
    crossing = {}
    for row, along, nodes in every:
        if len(nodes) > 1:
            ranks = tuple(sorted({owner(q) for q in along}))
            groups = multihost.row_groups(ranks)
            if rank in ranks:
                crossing[row] = Row(ranks, tuple(owner(q) for q in along), *groups)

    def mates(along, r):  # the other processes of the row on process r's node
        return {owner(x) for x in along if owner(x) != r and multihost.same_node({r, owner(x)})}

    if not any(mates(along, owner(q)) for _, along, _ in every for q in along):
        return {"slabs": slabs, "rows": crossing}
    shares, records = NodeShares(), {}
    for along in rows:
        for v, q in enumerate(along):
            key = (str(mesh.devices[q]), v)
            if owner(q) == rank and mates(along, rank) and key not in records:
                records[key], slabs[(mesh.devices[q], v)] = shares.export(slabs[(mesh.devices[q], v)])
    everyone = multihost.all_gather_object(records)
    mapped = set()
    for along in rows:
        for reader in (q for q in along if owner(q) == rank):
            for v, q in enumerate(along):
                key = _slab_key(mesh, axis, reader, v)
                if key is not None and owner(q) != rank and key not in slabs:
                    slabs[key] = shares.open(everyone[owner(q)][(str(mesh.devices[q]), v)], key[0])
                    mapped.add(key)
    return {"slabs": slabs, "mapped": frozenset(mapped), "shares": shares, "rows": crossing}


def build_slabbed_volume(grid: DeviceGrid, mesh: Mesh, axis: str = "vz", tap_dtype: str = "float32") -> SlabbedVolume:
    """Cut a DeviceGrid's dense field into halo'd z-slabs over `axis`:
    each slab of this process's positions cut from the field with its
    halos (zeros beyond the field's ends) onto its card; every process
    holds the whole field here (a time series' timestep), so no halo
    crosses processes. `tap_dtype="bfloat16"` rounds each trilinear sum
    to bf16 (SlabGrid)."""
    if grid.dense is None:
        raise ValueError("volume slabs from a DeviceGrid need its dense field; for volumes too large to decode on "
                         "one card use build_slabbed_volume_from_brick(host_brick_grid, mesh)")
    z, y, x = grid.dense.shape
    slab = div_round_up(z, mesh.shape[axis])

    def cut(v, card):
        z0 = v * slab - SLAB_HALO
        block = torch.zeros((slab + 2 * SLAB_HALO, y, x), dtype=torch.bfloat16, device=card)
        lo, hi = max(z0, 0), min(z0 + block.shape[0], z)
        block[lo - z0:hi - z0] = grid.dense[lo:hi]
        return block

    return SlabbedVolume(meta=grid._replace(dense=None), mesh=mesh, axis=axis, slab=slab, tap_dtype=tap_dtype,
                         **_node_slabs(mesh, axis, cut))


def build_slabbed_volume_from_brick(grid: BrickGrid, mesh: Mesh, axis: str = "vz",
                                    tap_dtype: str = "float32") -> SlabbedVolume:
    """Build a SlabbedVolume straight from a host BrickGrid, never holding
    the whole dense field: each halo'd slab is decoded on its card from its
    own brick rows and its halos' (sampling.decode_dense_rows_device,
    DECODE_ROWS brick rows at a time), so a card's peak is one slab and the
    scratch of a few rows; each process decodes the slabs of its own
    positions only, and maps the others' (parallel.nodeshare). Zeros
    beyond the field, as build_slabbed_volume's cut gives, so the slabs
    are bit-equal to build_slabbed_volume's of the decoded field. `meta` holds the majorant pyramid and the extent, and
    nothing volume-sized. Unlike the JAX package's, it takes no `maj_dtype`: the port's pyramid is float32."""
    bx, by, bz = grid.brick_count
    z, y, x = bz * 8, by * 8, bx * 8
    slab = div_round_up(z, mesh.shape[axis])

    def decode(v, card):
        z0 = v * slab - SLAB_HALO
        block = torch.zeros((slab + 2 * SLAB_HALO, y, x), dtype=torch.bfloat16, device=card)
        lo, hi = max(z0, 0), min(z0 + block.shape[0], z)
        for b in range(lo >> 3, (hi + 7) >> 3, DECODE_ROWS):
            b1 = min(b + DECODE_ROWS, (hi + 7) >> 3)
            rows = decode_dense_rows_device(grid, b, b1, card)
            s0, s1 = max(lo, b * 8), min(hi, b1 * 8)
            block[s0 - z0:s1 - z0] = rows[s0 - b * 8:s1 - b * 8]
            del rows
        return block

    parts = _node_slabs(mesh, axis, decode)
    first = (mesh.local_devices() or [torch.device("cpu")])[0]
    meta = DeviceGrid(dense=None, maj_mips=torch.from_numpy(build_majorant_pyramid(grid)).to(first),
                      extent=tuple(int(v) for v in grid.index_extent))
    return SlabbedVolume(meta=meta, mesh=mesh, axis=axis, slab=slab, tap_dtype=tap_dtype, **parts)
