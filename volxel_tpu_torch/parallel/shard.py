"""Multi-card rendering, pixel-split and sample-parallel over a mesh: the
PyTorch counterpart of volxel_tpu.parallel.shard.

Position (s, p) of an (sp, px) mesh renders the p-th of px contiguous
blocks of pixels at sample `frame_index * sp + s`, through
pathtrace.render_pixels on its own card; the positions' radiances are
summed over 'sp' in position order and divided by sp (the JAX package's
pmean = psum / n), block by block. Because RNG seeding is a pure function
of (global pixel index, global sample index), the result is bit-equal to
the same sum of single-card render_sample calls.

A third axis ('vz', or any other name: render-time volume slabs) splits
each block once more: position (s, p, v) renders the v-th of its n
contiguous parts (torch.tensor_split's), so no card idles. With a
SlabbedVolume as the grid operand (parallel.volshard) its lanes read the
slabs of the positions (s, p, ·) through that card's slab table; with a
replicated DeviceGrid they read the card's copy. Either way the frame is
bit-equal to the replicated two-axis render. The JAX package instead
replicates the ray state over 'vz' and psums each tap; a leg here is one
launch, inside which no collective can run.

Operands are copied to each card once, and again only when the caller
passes other operand objects (a restart or a change): the copies are held
by a CardOperands that the caller keeps (DistributedRenderer keeps one, so
they live and die with it); each step builds the default mode's
premultiplied pyramid once per card, not once per position. A
SlabbedVolume's slabs stay where they are: only its replicated metadata
is copied. The JAX package caches its compiled functions; here a function
is a closure that costs nothing to build, so there is no function cache.
A process renders the positions it owns one after another; several
processes exchange their results with one torch.distributed all_gather
on the frame (multihost.all_gather): whole rows where each row's
positions are one process's, else each position's part, padded to the
longest part and cut back (a row whose parts lie on several processes of
a node, one process a card: volshard's shared slabs). The result lies on
this process's first device of the mesh. A slab axis whose positions span
nodes renders the same way: a lane about to read a slab on another node
parks and moves to the process that owns it (parallel.migrate), so every
process of such a row renders its positions in axis order, and each owns
as many of them.
"""

from __future__ import annotations

import torch

from volxel_tpu_torch.parallel import multihost
from volxel_tpu_torch.parallel.mesh import Mesh
from volxel_tpu_torch.parallel.volshard import SlabbedVolume, rows_along
from volxel_tpu_torch.render.pathtrace import RenderConfig, render_pixels, with_premul_majorant


def to_device(operand, device: torch.device):
    """`operand` with every tensor in it (through NamedTuples and tuples)
    on `device`; a tensor already there is returned as it is."""
    if isinstance(operand, torch.Tensor):
        return operand.to(device)
    if isinstance(operand, tuple):
        moved = (to_device(x, device) for x in operand)
        return type(operand)(*moved) if hasattr(operand, "_fields") else tuple(moved)
    return operand


class CardOperands:
    """Each card's copy of a tuple of operands, kept while the caller
    passes the same operand objects and made again when any of them is
    another object."""

    def __init__(self):
        self._source: tuple | None = None
        self._copies: dict[torch.device, tuple] = {}

    def on(self, device: torch.device, operands: tuple) -> tuple:
        if self._source is None or any(a is not b for a, b in zip(self._source, operands)):
            self._source, self._copies = operands, {}
        if device not in self._copies:
            self._copies[device] = to_device(operands, device)
        return self._copies[device]


def step_operands(config: RenderConfig, mesh: Mesh, cards: CardOperands, operands: tuple) -> dict:
    """Each local card's (grid, params, lut, env, ...) for one step, the
    grid with the default mode's premultiplied pyramid built once on the
    card."""
    out = {}
    for device in mesh.local_devices():
        grid, params, lut, *rest = cards.on(device, operands)
        if config.mode == "default" and grid.maj_alpha is None and not config.debug_hits:
            grid = with_premul_majorant(config, grid, params, lut)
        out[device] = (grid, params, lut, *rest)
    return out


def part_axis(mesh: Mesh) -> str | None:
    """The axis besides 'sp' and 'px' that splits each pixel block (None
    for a two-axis mesh)."""
    extra = [a for a in mesh.axis_names if a not in ("sp", "px")]
    if len(extra) > 1:
        raise ValueError(f"a mesh has at most one axis besides 'sp' and 'px', got {mesh.axis_names}")
    return extra[0] if extra else None


def mesh_rows(mesh: Mesh) -> list[tuple[tuple[int, int], list[tuple]]]:
    """Every (s, p) of the mesh with its positions along the part axis (one
    position on a two-axis mesh), in row-major order."""
    axis = part_axis(mesh)
    sp_k, px_k = mesh.axis_names.index("sp"), mesh.axis_names.index("px")
    if axis is None:
        return [((pos[sp_k], pos[px_k]), [pos]) for pos in mesh.positions()]
    return [((along[0][sp_k], along[0][px_k]), along) for _, along, _ in rows_along(mesh, axis)]


def part_pixels(block: range, parts: int, v: int, device: torch.device) -> torch.Tensor:
    """The global pixel indices of part v of `parts` contiguous parts of
    `block`, as torch.tensor_split cuts it (the first len % parts parts one
    longer), on `device`."""
    q, r = divmod(len(block), parts)
    start = block.start + v * q + min(v, r)
    return torch.arange(start, start + q + (v < r), dtype=torch.int64, device=device)


def position_grid(grid, card_grid, position: tuple):
    """The grid that `position` renders with: its SlabGrid when `grid` is a
    SlabbedVolume (`card_grid` its metadata's copy on the card), else the
    card's copy of the grid."""
    return grid.local_grid(position, card_grid) if isinstance(grid, SlabbedVolume) else card_grid


def render_rows(config: RenderConfig, mesh: Mesh, cards: CardOperands, operands: tuple, local_n: int,
                render) -> dict:
    """Each of this process's positions (s, p, ·): render(position's grid,
    the card's other operands, its part of pixel block p, s). `operands`
    is (grid, ...) as the caller got them; their copies on each card are
    step_operands' (of a SlabbedVolume only its metadata). Returns
    {position: part}, which gather_rows joins into rows."""
    grid = operands[0]
    ops = step_operands(config, mesh, cards,
                        (grid.meta if isinstance(grid, SlabbedVolume) else grid, *operands[1:]))
    mine = set(mesh.local_positions())
    parts = {}
    for (s, p), along in mesh_rows(mesh):
        for v, pos in enumerate(along):
            if pos not in mine:
                continue
            device = mesh.devices[pos]
            card_grid, *rest = ops[device]
            pixel_index = part_pixels(range(p * local_n, (p + 1) * local_n), len(along), v, device)
            parts[pos] = render(position_grid(grid, card_grid, pos), rest, pixel_index, s)
    return parts


def operand_device(mesh: Mesh, grid) -> torch.device:
    """Where a step's result lies: this process's first device of the mesh,
    else the grid's."""
    local = mesh.local_devices()
    if local:
        return local[0]
    return (grid.meta.maj_mips if isinstance(grid, SlabbedVolume) else grid.dense).device


def gather_rows(mesh: Mesh, parts: dict, shape: tuple, device: torch.device) -> dict:
    """Every row's block (each of `shape`, f32, pixels on dim -2) on
    `device`, from this process's `parts` (render_rows'). Where each row's
    positions are one process's, its parts are joined on the row's first
    card and the rows gathered across processes; else every part is
    gathered, padded to the longest part (torch.tensor_split's parts differ
    by one pixel at most), cut back and joined in axis order. One
    all_gather either way (multihost.gather_owned), none in one process."""
    rows = mesh_rows(mesh)

    def owner(q):
        return int(mesh.processes[q])

    if all(len({owner(q) for q in along}) == 1 for _, along in rows):
        local = {}
        for i, (_, along) in enumerate(rows):
            if along[0] in parts:
                first = parts[along[0]].device
                local[i] = parts[along[0]] if len(along) == 1 else torch.cat([parts[q].to(first) for q in along],
                                                                             dim=-2)
        blocks = multihost.gather_owned([owner(along[0]) for _, along in rows], local, shape, device)
        return {row: block for (row, _), block in zip(rows, blocks)}
    k = len(rows[0][1])
    base, extra = divmod(shape[-2], k)
    longest = base + (extra > 0)
    positions = [pos for _, along in rows for pos in along]
    local = {}
    for i, pos in enumerate(positions):
        if pos in parts:
            part = parts[pos]
            local[i] = part.new_zeros((*shape[:-2], longest, shape[-1]))
            local[i][..., :part.shape[-2], :] = part
    blocks = multihost.gather_owned([owner(pos) for pos in positions], local, (*shape[:-2], longest, shape[-1]),
                                    device)
    return {row: torch.cat([blocks[j * k + v][..., :base + (v < extra), :] for v in range(k)], dim=-2)
            for j, (row, _) in enumerate(rows)}


def sharded_render_fn(config: RenderConfig, mesh: Mesh, cards: CardOperands | None = None):
    """A sharded render: (grid, params, lut, env, inv_view, inv_proj,
    light_dir, frame_index) -> (n, 3), the mean of samples
    [frame_index * sp, frame_index * sp + sp) of every pixel. One call
    advances sp progressive samples. `grid` is a DeviceGrid or a
    SlabbedVolume built on this mesh. `cards` holds the operands' copies
    on the mesh's cards (a new one, owned by the function, by default)."""
    n = config.width * config.height
    sp, px = mesh.shape["sp"], mesh.shape["px"]
    if n % px != 0:
        raise ValueError(f"pixel count {n} not divisible by px axis {px}")
    mesh_rows(mesh)  # refuses a row across nodes whose processes own unequal parts of it
    local_n = n // px
    cards = cards if cards is not None else CardOperands()

    def render(grid, params, lut, env, inv_view, inv_proj, light_dir, frame_index):
        parts = render_rows(config, mesh, cards, (grid, params, lut, env, inv_view, inv_proj, light_dir), local_n,
                            lambda g, rest, pixels, s: render_pixels(config, g, *rest, pixels,
                                                                     int(frame_index) * sp + s))
        first = operand_device(mesh, grid)
        blocks = gather_rows(mesh, parts, (local_n, 3), first)
        frame = torch.empty((n, 3), dtype=torch.float32, device=first)
        for p in range(px):
            acc = blocks[(0, p)]
            for s in range(1, sp):  # sum in position order, then / sp
                acc = acc + blocks[(s, p)]
            frame[p * local_n:(p + 1) * local_n] = acc / sp
        return frame

    return render


def render_sample_sharded(config: RenderConfig, mesh: Mesh, grid, params, lut, env, inv_view, inv_proj, light_dir,
                          frame_index, cards: CardOperands | None = None):
    """One sharded progressive step (advances mesh.shape['sp'] samples);
    `grid` and `cards` as in sharded_render_fn."""
    return sharded_render_fn(config, mesh, cards)(grid, params, lut, env, inv_view, inv_proj, light_dir, frame_index)
