"""Multi-card rendering, pixel-split and sample-parallel over a mesh: the
PyTorch counterpart of volxel_tpu.parallel.shard.

Position (s, p) of an (sp, px) mesh renders the p-th of px contiguous
blocks of pixels at sample `frame_index * sp + s`, through
pathtrace.render_pixels on its own card; the positions' radiances are
summed over 'sp' in position order and divided by sp (the JAX package's
pmean = psum / n), block by block. Because RNG seeding is a pure function
of (global pixel index, global sample index), the result is bit-equal to
the same sum of single-card render_sample calls.

Operands are copied to each card once, and again only when the caller
passes other operand objects (a restart or a change): the copies are held
by a CardOperands that the caller keeps (DistributedRenderer keeps one, so
they live and die with it); each step builds the default mode's
premultiplied pyramid once per card, not once per position. The JAX
package caches its compiled functions; here a function is a closure that
costs nothing to build, so there is no function cache. A process renders the positions it owns one after another;
several processes exchange their positions' results with one
torch.distributed all_gather on the frame (multihost.all_gather). The
result lies on this process's first device of the mesh.

Render-time volume slabs (a 'vz' axis > 1, the JAX package's
parallel/volshard.py) are not ported yet: they need a slab table in the
legs' field reads over peer access (ROADMAP.md, queue 1: "Render-time volume
slabs").
"""

from __future__ import annotations

import torch

from volxel_tpu_torch.parallel import multihost
from volxel_tpu_torch.parallel.mesh import Mesh
from volxel_tpu_torch.render.pathtrace import RenderConfig, render_pixels, with_premul_majorant

VZ_NOT_PORTED = ("rendering over a 'vz' mesh axis > 1 (the JAX package's parallel/volshard.py) is not ported "
                 "yet: ROADMAP.md, queue 1, 'Render-time volume slabs'")


def check_no_slabs(mesh: Mesh) -> None:
    if mesh.shape.get("vz", 1) > 1:
        raise NotImplementedError(VZ_NOT_PORTED)


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


def gather_positions(mesh: Mesh, local: dict, shape: tuple, device: torch.device) -> dict:
    """Every position's block (each of `shape`, f32) on `device`, from
    this process's `local` blocks (position -> tensor) and, across
    processes, one all_gather (multihost.gather_owned)."""
    positions = mesh.positions()
    index = {pos: i for i, pos in enumerate(positions)}
    owners = [int(mesh.processes[pos]) for pos in positions]
    blocks = multihost.gather_owned(owners, {index[pos]: t for pos, t in local.items()}, shape, device)
    return dict(zip(positions, blocks))


def sharded_render_fn(config: RenderConfig, mesh: Mesh, cards: CardOperands | None = None):
    """A sharded render: (grid, params, lut, env, inv_view, inv_proj,
    light_dir, frame_index) -> (n, 3), the mean of samples
    [frame_index * sp, frame_index * sp + sp) of every pixel. One call
    advances sp progressive samples. `cards` holds the operands' copies on
    the mesh's cards (a new one, owned by the function, by default)."""
    n = config.width * config.height
    sp, px = mesh.shape["sp"], mesh.shape["px"]
    if n % px != 0:
        raise ValueError(f"pixel count {n} not divisible by px axis {px}")
    check_no_slabs(mesh)
    local_n = n // px
    cards = cards if cards is not None else CardOperands()

    def render(grid, params, lut, env, inv_view, inv_proj, light_dir, frame_index):
        ops = step_operands(config, mesh, cards, (grid, params, lut, env, inv_view, inv_proj, light_dir))
        blocks = {}
        for s, p in mesh.local_positions():
            device = mesh.devices[s, p]
            pixel_index = torch.arange(p * local_n, (p + 1) * local_n, dtype=torch.int64, device=device)
            blocks[(s, p)] = render_pixels(config, *ops[device], pixel_index, int(frame_index) * sp + s)
        first = (mesh.local_devices() or [grid.dense.device])[0]
        blocks = gather_positions(mesh, blocks, (local_n, 3), first)
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
    `cards` as in sharded_render_fn."""
    return sharded_render_fn(config, mesh, cards)(grid, params, lut, env, inv_view, inv_proj, light_dir, frame_index)
