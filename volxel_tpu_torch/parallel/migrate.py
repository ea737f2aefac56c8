"""Lanes that move between the nodes of a 'vz' row: the legs over slabs that
no process of this node can load.

A row whose processes span nodes (parallel/volshard.py) gives each process
a SlabGrid whose slabs on other nodes are absent. Within a node nothing
changes: a slab is read in place, through peer loads or an IPC mapping.
Across nodes a leg cannot load the owner's memory, and it is one launch
that marches each lane to its end, so the JAX package's design (each tap
psummed over 'vz') cannot run inside it. Instead a lane about to read an
absent slab parks: the leg's park form (render.ddaleg, render.trackleg,
render.tilemarch) stops it with its whole loop state, and the lane goes to
the process that owns that slab, which resumes it with the same park form.

A leg marches along a straight ray with t rising, so the owner of its taps
never turns back within a leg: a lane crosses each node boundary of its row
at most once, and parks at most once more than that (when its first tap
already lies on another node). The rounds of a leg call are bounded by the
node changes along the row: two for a row of two nodes.

One leg call on such a row (`Row.leg_call`), on every process of the row:

  1. run the park form on this process's lanes;
  2. count the parked lanes per destination, the process that owns the
     slab each one waits for, and gather the counts of the row (a gloo
     all_gather);
  3. if no process of the row parked a lane, stop;
  4. else send the parked lanes, each with its origin process and lane
     index, resume the arrived ones with the park form, and repeat from 2;
  5. one last exchange brings every lane that ended away from home back,
     and its outputs are scattered by origin index.

Every process of the row takes part in every round of every call, with no
lanes where it has none, so the collectives cannot deadlock: render_rows
renders a process's positions in axis order and trace_path calls each leg
`bounces` times on every process, so the calls line up, and a row across
nodes has every process own as many of its positions (volshard.rows_along).
A process resumes arrived lanes on the card of the position it renders in
that call, whose SlabGrid reads every slab of its node.

Lookups outside the legs (shading.density_gradient's six trilinear taps)
are answered by their owners instead (`Row.lookup_density_trilinear`): the
coordinates of the taps whose slab lies on another node go to its owner,
which returns the f32 trilinear sum (bf16-rounded where the grid's
tap_dtype asks) from its own slabs, whose halos hold the whole stencil, so
the value is bit-equal; one exchange per lookup call.

The renderer reaches this module only through the Row that a SlabGrid of
such a row carries (render.modes and render.shading call its methods), so
render/ imports nothing of parallel/.

The lanes travel as one byte row each through multihost.exchange
(batch_isend_irecv on the row's group, staged through the host under gloo,
and through one card of each process under NCCL, whose group was joined by
every process of the row when it was made: multihost.row_groups).
Nothing falls back: an exchange that fails raises, and a lookup of an absent
slab outside these paths raises (render.sampling._slab_taps). `CALLS` keeps
the last leg calls' lanes parked, moved and returned, rounds and bytes sent.
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from volxel_tpu_torch.parallel import multihost
from volxel_tpu_torch.render import sampling
from volxel_tpu_torch.render.ddaleg import (
    DDA_SAMPLE_MAX_STEPS,
    DDA_TRANSMITTANCE_MAX_STEPS,
    dda_leg_sample_park,
    dda_leg_shadow_park,
)
from volxel_tpu_torch.render.tilemarch import tile_march_sample_park, tile_march_transmittance_park
from volxel_tpu_torch.render.trackleg import TRACKING_MAX_EVENTS, track_leg_sample_park, track_leg_shadow_park

# this process's last leg calls: {"leg", "lanes", "running" (at home), "parked" (at home), "moved" and
# "returned" (lanes it sent), "rounds", "bytes" (it sent)}
CALLS: collections.deque = collections.deque(maxlen=1024)


class Row:
    """A 'vz' row whose processes span nodes, as one of its processes sees
    it: `ranks` its processes (ascending), `owners[v]` the process that
    owns slab v, the row's lanes and counts groups and, under NCCL, the
    card its lanes go through (multihost.row_groups). Its three
    collectives are the only messages of the protocol. A SlabGrid of the
    row carries it as `row`, and the renderer's legs and lookups go
    through its `leg_call` and `lookup_density_trilinear`."""

    def __init__(self, ranks: tuple, owners: tuple, lanes_group, counts_group, card=None):
        self.ranks = tuple(ranks)
        self.owners = tuple(owners)
        self.lanes_group = lanes_group
        self.counts_group = counts_group
        self.card = card  # under NCCL the card every exchange of the row goes through (None: the lanes' own)

    def counts(self, sizes: list[int]) -> list[list[int]]:
        """Every process's `sizes` (one count per process of the row, in
        `ranks` order): [source][destination]."""
        mine = torch.tensor(sizes, dtype=torch.int64)
        out = [torch.empty_like(mine) for _ in self.ranks]
        dist.all_gather(out, mine, group=self.counts_group)
        return [o.tolist() for o in out]

    def swap(self, sends: dict, sizes: dict, width: int, device) -> dict:
        """Send each (k, width) uint8 tensor of `sends` to its rank and
        receive sizes[rank] rows from each rank that sends some: {rank:
        rows}. A process sends itself nothing."""
        me = multihost.process_index()
        via = device if self.card is None else self.card
        recvs = {r: torch.empty((k, width), dtype=torch.uint8, device=via) for r, k in sizes.items()
                 if k and r != me}
        multihost.exchange([(t.to(via), r, 0) for r, t in sends.items() if t.shape[0]],
                           [(t, r, 0) for r, t in recvs.items()], group=self.lanes_group)
        return {r: t.to(device) for r, t in recvs.items()}

    def ask(self, queries: dict, answer, device) -> dict:
        """Owner-answered lookups: `queries` {rank: (k, 3) f32 points} go to
        their ranks, each process answers the points it receives (on
        `device`) with answer(points) -> (k,) f32, and the answers come
        back: {rank: (k,) f32}."""
        me = multihost.process_index()
        matrix = self.counts([int(queries[r].shape[0]) if r in queries else 0 for r in self.ranks])
        got = self.swap({r: _bytes(q) for r, q in queries.items()},
                        {r: matrix[i][self.ranks.index(me)] for i, r in enumerate(self.ranks)}, 12, device)
        replies = {r: _bytes(answer(_floats(rows, 3)).reshape(-1, 1)) for r, rows in got.items()}
        back = self.swap(replies, {r: int(queries[r].shape[0]) for r in queries}, 4, device)
        return {r: _floats(rows, 1).reshape(-1) for r, rows in back.items()}

    def leg_call(self, name: str, field, *args):
        """Leg `name` (modes' call: its field, then its own arguments) on
        `field`, a SlabGrid of this row: the park form here, the parked lanes
        moved to their slabs' owners and resumed there in rounds until no
        process of the row parks one, and the lanes that ended away brought
        home. Returns what the leg returns, bit-equal to the one-run slab
        form; with_stats' budgets and events are each lane's whole, wherever
        it spent them."""
        leg = LEGS[name]
        me = multihost.process_index()
        consts, lanes = home_lanes(leg, args)
        n, device = _size(lanes)
        outs = park_call(leg, field, consts, lanes)
        home = {k: outs[k] for k in leg.result}
        idx = torch.nonzero(outs["park"] >= 0).squeeze(1)
        moving, waits = parked_carry(leg, lanes, outs, idx), outs["park"][idx]
        origin = torch.stack([torch.full_like(idx, me), idx], dim=1).to(torch.int32)
        carry_layout = _layout(moving, leg.carry)
        owners = torch.tensor(self.owners, dtype=torch.int64, device=device)
        stat = {"leg": name, "lanes": n, "running": int(lanes["running" if "running" in lanes else "valid"].sum()),
                "parked": int(idx.numel()), "moved": 0, "returned": 0, "rounds": 0, "bytes": 0}
        done = []  # (result fields, origin) of the lanes that ended here away from home
        while True:
            sends, sizes = _split(self, owners[waits.to(torch.int64)], moving, origin, carry_layout)
            got = _post(self, sends, sizes, carry_layout, device, stat)
            if got is None:
                break
            stat["rounds"] += 1
            stat["moved"] += sum(sizes)
            moving, origin, waits = {k: v[:0] for k, v in moving.items()}, origin[:0], waits[:0]
            if got:  # resume the lanes that arrived; those that park again move on in the next round
                arrived, arrived_origin = _unpack(torch.cat([got[r] for r in self.ranks if r in got]), carry_layout)
                outs = park_call(leg, field, consts, arrived)
                ended = torch.nonzero(outs["park"] < 0).squeeze(1)
                done.append(({k: outs[k][ended] for k in leg.result}, arrived_origin[ended]))
                again = torch.nonzero(outs["park"] >= 0).squeeze(1)
                moving = parked_carry(leg, arrived, outs, again)
                origin, waits = arrived_origin[again], outs["park"][again]
        _bring_home(self, me, home, done, device, stat)
        CALLS.append(stat)
        return tuple(home[k] for k in leg.result)

    def trilinear_sum(self, grid, ipos):
        """sampling.trilinear_sum on `grid`, a SlabGrid of this row: the
        points whose stencil lies in an absent slab are answered by that slab's
        owner (`ask`), the others here. Every process of the row calls it
        together."""
        flat = ipos.reshape(-1, 3)
        owner = sampling.slab_owner(grid, flat[:, 2])
        absent = grid.absent(flat.device)[owner]
        out = torch.empty(flat.shape[0], dtype=torch.float32, device=flat.device)
        here = torch.nonzero(~absent).squeeze(1)
        out[here] = sampling.trilinear_sum(grid, flat[here])
        away = torch.nonzero(absent).squeeze(1)
        ranks = torch.tensor(self.owners, dtype=torch.int64, device=flat.device)[owner[away]]
        picks = {r: away[ranks == r] for r in self.ranks}
        answers = self.ask({r: flat[sel] for r, sel in picks.items() if sel.numel()},
                          lambda points: sampling.trilinear_sum(grid, points), flat.device)
        for r, values in answers.items():
            out[picks[r]] = values
        return out.reshape(ipos.shape[:-1])

    def lookup_density_trilinear(self, grid, params, ipos):
        """sampling.lookup_density_trilinear through `trilinear_sum`."""
        return params.density_scale * self.trilinear_sum(grid, ipos)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """(k, ...) f32 as (k, 4 * ...) uint8."""
    return t.contiguous().reshape(t.shape[0], -1).view(torch.uint8)


def _floats(rows: torch.Tensor, width: int) -> torch.Tensor:
    return rows.contiguous().view(torch.float32).reshape(-1, width)


# -- the legs ------------------------------------------------------------------


class Leg(NamedTuple):
    """How leg calls of one leg migrate. `args`: the leg's arguments after
    its field; `park`: its park form's name in this module, whose
    arguments after the field are `park_args`; per-lane arguments of the
    park form that the leg has not, at home (`home`: (dtype, value)) and
    for resumed lanes (`resumed`); `outs`: the park form's outputs;
    `carry`: what a parked lane takes with it; `result`: the leg's
    outputs, which come home."""

    args: tuple
    park: str
    park_args: tuple
    home: dict
    resumed: dict
    outs: tuple
    carry: tuple
    result: tuple


CONSTS = ("maj_alpha", "extent", "scalars", "lut", "physical")  # the arguments that are not per lane
_DDA = ("maj_alpha", "extent", "scalars", "lut", "ipos", "idir", "ri", "far", "t", "tau", "mip", "state", "running")
_DDA_PARK = (*_DDA[:11], "m", "budget", "state", "running", "resume")
_DDA_RESUMED = {"tau": (torch.float32, 0.0), "running": (torch.bool, True), "resume": (torch.bool, True)}
_DDA_CARRY = ("ipos", "idir", "ri", "far", "t", "mip", "m", "budget", "state")
_TRACK = ("extent", "scalars", "lut", "ipos", "idir", "far", "t", "state", "running")
_TRACK_PARK = (*_TRACK[:7], "events", "state", "running")
_TRACK_HOME = {"events": (torch.int32, TRACKING_MAX_EVENTS)}
_TRACK_CARRY = ("ipos", "idir", "far", "t", "events", "state")
_TILE = ("ipos", "idir", "start", "dt", "far", "valid", "tau_target", "state", "lut", "scalars", "extent")
_TILE_HOME = {"step": (torch.int32, 0), "tau": (torch.float32, 0.0)}
_TILE_CARRY = ("ipos", "idir", "start", "dt", "far", "tau_target", "state", "step", "tau")

LEGS = {
    "dda_leg_sample": Leg(_DDA, "dda_leg_sample_park", _DDA_PARK,
                          {"m": (torch.float32, 0.0), "budget": (torch.int32, DDA_SAMPLE_MAX_STEPS),
                           "resume": (torch.bool, False)}, _DDA_RESUMED,
                          ("state", "hit", "t", "rgb", "budget", "mip", "m", "park"), _DDA_CARRY,
                          ("state", "hit", "t", "rgb", "budget")),
    "dda_leg_shadow": Leg((*_DDA, "tr", "physical"), "dda_leg_shadow_park", (*_DDA_PARK, "tr", "physical"),
                          {"m": (torch.float32, 0.0), "budget": (torch.int32, DDA_TRANSMITTANCE_MAX_STEPS),
                           "resume": (torch.bool, False)}, _DDA_RESUMED,
                          ("state", "tr", "budget", "t", "mip", "m", "park"), (*_DDA_CARRY, "tr"),
                          ("state", "tr", "budget")),
    "track_leg_sample": Leg(_TRACK, "track_leg_sample_park", _TRACK_PARK, _TRACK_HOME,
                            {"running": (torch.bool, True)}, ("state", "hit", "t", "rgb", "events", "park"),
                            _TRACK_CARRY, ("state", "hit", "t", "rgb", "events")),
    "track_leg_shadow": Leg((*_TRACK, "tr"), "track_leg_shadow_park", (*_TRACK_PARK, "tr"), _TRACK_HOME,
                            {"running": (torch.bool, True)}, ("state", "tr", "events", "t", "park"),
                            (*_TRACK_CARRY, "tr"), ("state", "tr", "events")),
    "tile_march_sample": Leg(_TILE, "tile_march_sample_park", (*_TILE, "step", "tau"), _TILE_HOME,
                             {"valid": (torch.bool, True)}, ("state", "hit", "t", "rgb", "step", "tau", "park"),
                             _TILE_CARRY, ("state", "hit", "t", "rgb")),
    "tile_march_transmittance": Leg((*_TILE[:6], *_TILE[7:]), "tile_march_transmittance_park",
                                    (*_TILE[:6], *_TILE[7:], "step", "tau"), _TILE_HOME,
                                    {"valid": (torch.bool, True)}, ("state", "tau", "step", "park"),
                                    tuple(k for k in _TILE_CARRY if k != "tau_target"), ("state", "tau")),
}


def home_lanes(leg: Leg, args: tuple) -> tuple[dict, dict]:
    """A leg call's arguments after its field as (consts, lanes): the
    per-lane ones with the park form's own at their home values."""
    named = dict(zip(leg.args, args))
    named.setdefault("physical", False)
    consts = {k: v for k, v in named.items() if k in CONSTS}
    lanes = {k: v for k, v in named.items() if k not in CONSTS}
    n, device = _size(lanes)
    for key, (dtype, value) in leg.home.items():
        lanes[key] = torch.full((n,), value, dtype=dtype, device=device)
    return consts, lanes


def park_args(leg: Leg, consts: dict, lanes: dict) -> list:
    """The park form's arguments after its field for `lanes` (home lanes,
    or resumed ones, which have only the carry: the rest takes its
    `resumed` value)."""
    n, device = _size(lanes)
    full = dict(lanes)
    for key, (dtype, value) in leg.resumed.items():
        if key not in full:
            full[key] = torch.full((n,), value, dtype=dtype, device=device)
    return [consts[k] if k in CONSTS else full[k] for k in leg.park_args]


def park_call(leg: Leg, field, consts: dict, lanes: dict) -> dict:
    """The park form on `lanes` (see park_args); its outputs by name."""
    return dict(zip(leg.outs, globals()[leg.park](field, *park_args(leg, consts, lanes))))


def parked_carry(leg: Leg, lanes: dict, outs: dict, idx: torch.Tensor) -> dict:
    """What the lanes at `idx` take with them when they park."""
    return {k: (outs[k] if k in outs else lanes[k])[idx] for k in leg.carry}


def _size(lanes: dict) -> tuple[int, torch.device]:
    first = lanes["ipos"]
    return first.shape[0], first.device


# -- packing -------------------------------------------------------------------


def _layout(template: dict, keys: tuple) -> list:
    """(key, dtype, trailing shape, bytes a lane) of each key of `template`."""
    return [(k, template[k].dtype, tuple(template[k].shape[1:]),
             math.prod(template[k].shape[1:]) * template[k].element_size()) for k in keys]


def _pack(lanes: dict, origin: torch.Tensor, layout: list) -> torch.Tensor:
    """Each lane as one row of bytes: its fields in `layout`, then its
    origin (rank, index) as two int32."""
    k = origin.shape[0]
    parts = [lanes[key].contiguous().reshape(k, -1).view(torch.uint8) for key, *_ in layout]
    return torch.cat([*parts, origin.contiguous().view(torch.uint8)], dim=1)


def _unpack(rows: torch.Tensor, layout: list) -> tuple[dict, torch.Tensor]:
    lanes, at = {}, 0
    k = rows.shape[0]

    def field(cols, dtype):  # a fresh copy: a view of one row may start at any byte
        return cols.clone(memory_format=torch.contiguous_format).view(dtype)

    for key, dtype, shape, width in layout:
        lanes[key] = field(rows[:, at:at + width], dtype).reshape(k, *shape)
        at += width
    return lanes, field(rows[:, at:], torch.int32).reshape(k, 2)


# -- the protocol --------------------------------------------------------------


def _split(row: Row, dest: torch.Tensor, fields: dict, origin: torch.Tensor, layout: list) -> tuple[dict, list]:
    """The lanes going to each process of the row (`dest`: each lane's
    rank), packed, and how many go to each, in `row.ranks` order."""
    sends, sizes = {}, []
    for r in row.ranks:
        sel = torch.nonzero(dest == r).squeeze(1)
        sizes.append(int(sel.numel()))
        if sel.numel():
            sends[r] = _pack({k: v[sel] for k, v in fields.items()}, origin[sel], layout)
    return sends, sizes


def _post(row: Row, sends: dict, sizes: list, layout: list, device, stat: dict) -> dict | None:
    """Every process's `sizes` gathered, then the packed lanes swapped:
    {rank: rows this process received}, or None where no process of the
    row sends any (every process sees the same counts, so all stop
    together)."""
    matrix = row.counts(sizes)
    if not any(map(any, matrix)):
        return None
    stat["bytes"] += sum(int(t.numel()) for t in sends.values())
    mine = row.ranks.index(multihost.process_index())
    return row.swap(sends, {r: matrix[i][mine] for i, r in enumerate(row.ranks)},
                    sum(w for *_, w in layout) + 8, device)


def _bring_home(row: Row, me: int, home: dict, done: list, device, stat: dict) -> None:
    """The last exchange: every lane that ended away from home goes back
    to its origin process, which scatters its outputs by lane index."""
    layout = _layout(home, tuple(home))
    if done:
        results = {k: torch.cat([d[k] for d, _ in done]) for k in home}
        origin = torch.cat([o for _, o in done])
    else:
        results, origin = {k: v[:0] for k, v in home.items()}, torch.zeros((0, 2), dtype=torch.int32, device=device)
    here = origin[:, 0] == me
    _scatter(home, {k: v[here] for k, v in results.items()}, origin[here, 1])
    away = torch.nonzero(~here).squeeze(1)
    sends, sizes = _split(row, origin[away, 0], {k: v[away] for k, v in results.items()}, origin[away], layout)
    stat["returned"] = sum(sizes)
    for rows in (_post(row, sends, sizes, layout, device, stat) or {}).values():
        lanes, back = _unpack(rows, layout)
        _scatter(home, lanes, back[:, 1])


def _scatter(home: dict, lanes: dict, index: torch.Tensor) -> None:
    index = index.to(torch.int64)
    for k, v in lanes.items():
        home[k][index] = v


