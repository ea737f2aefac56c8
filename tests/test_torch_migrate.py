"""Lanes parked at slabs on another node and resumed by the slabs' owner
(render.ddaleg, render.trackleg, render.tilemarch park forms;
parallel.migrate), in one process on the CPU.

The six legs' lanes are each leg's calls in a 32^2 frame of every mode on
a 24^3 volume; the field is a SlabGrid of three slabs of 8 z-slices, cut
from the frame's dense field. Node A holds slabs 1 and 2, node B slab 0:
A's grid has slab 0 absent, B's slabs 1 and 2. The park form on A's grid,
then the parked lanes resumed on B's grid, then those that parked again
resumed on A's, give every output bit for bit as the one-run slab form on
the whole grid (tolerance: none). A leg marches with t rising, so a lane parks a second
time only where its ray runs from B back into A (idir z > 0), and never a
third time. The gradient lookups' owner-answered exchange is faked by a Row
whose owner is B's grid in this process. The renderer reaches the protocol
only through the Row a SlabGrid carries: render/ imports nothing of
parallel/.
"""

from __future__ import annotations

import ast
import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu_torch import Renderer
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.parallel import make_mesh, migrate
from volxel_tpu_torch.parallel.volshard import build_slabbed_volume
from volxel_tpu_torch.render import ddaleg, modes, tilemarch, trackleg
from volxel_tpu_torch.render.pathtrace import render_sample
from volxel_tpu_torch.render.sampling import SlabGrid, trilinear_sum
from volxel_tpu_torch.render.shading import density_gradient
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume

SIDE = 24
VZ = 3
FOREIGN = 0  # the slab on node B
LEG_MODES = {"dda_leg_sample": "default", "dda_leg_shadow": "default", "track_leg_sample": "no_dda",
             "track_leg_shadow": "no_dda", "tile_march_sample": "raymarch", "tile_march_transmittance": "raymarch"}
LEG_MODULES = {"dda_leg": ddaleg, "track_leg": trackleg, "tile_march": tilemarch}


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@contextlib.contextmanager
def _recorded(names):
    """Record each call's arguments of modes' legs `names`."""
    calls = {name: [] for name in names}
    originals = {name: getattr(modes, name) for name in names}

    def wrap(name):
        def call(*args):
            calls[name].append(args)
            return originals[name](*args)
        return call

    for name in names:
        setattr(modes, name, wrap(name))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(modes, name, fn)


@pytest.fixture(scope="module")
def scene():
    """The frame's leg calls by leg (on the dense field), the whole
    SlabGrid, node A's and node B's."""
    vol = synthetic_ct_volume((SIDE,) * 3, bits_stored=12).astype(np.float32)
    grid = construct_brick_grid(vol / vol.max(), transform=np.eye(4, dtype=np.float32))
    r = Renderer(32, 32, device="cpu")
    r.restart_from_grid(grid)
    r.camera.rotate_around_view(0.4, 0.2)
    r.camera.zoom(2.0)
    r.settings.bounces = 2
    calls = {}
    for mode in ("default", "no_dda", "raymarch"):
        r.render_mode = mode
        config = r._config()
        names = [n for n, m in LEG_MODES.items() if m == mode]
        with _recorded(names) as got:
            render_sample(config, r._device_grid, r.volume_params(), r._lut, r.environment.state,
                          *r._camera_operands(config), 0)
        calls.update(got)
    mesh = make_mesh(sp=1, px=1, vz=VZ, devices=[torch.device("cpu")] * VZ)
    whole = build_slabbed_volume(r._device_grid, mesh).local_grid()
    node_a = SlabGrid([None if v == FOREIGN else s for v, s in enumerate(whole.slabs)], whole.slab, whole.maj_mips,
                      whole.extent)
    node_b = SlabGrid([s if v == FOREIGN else None for v, s in enumerate(whole.slabs)], whole.slab, whole.maj_mips,
                      whole.extent)
    return r, calls, whole, node_a, node_b


def _one_run(name, grid, args):
    """The leg's slab form (its plain version here) in one run."""
    module = LEG_MODULES[name.rsplit("_", 1)[0]]
    return dict(zip(migrate.LEGS[name].result, getattr(module, name)(grid, *args)))


@pytest.mark.parametrize("name", list(LEG_MODES))
def test_parked_then_resumed_equals_one_run(scene, name):
    """Each leg's park form on node A's grid: the lanes that ended equal
    the one-run slab form's; the parked ones wait for slab 0, and resumed
    on node B's grid (and those that parked again back on A's) they give
    every output bit-equal to the one-run slab form's at the same lanes.
    Some lanes park, a lane parks again only where its ray runs back into
    A, and none a third time."""
    _, calls, whole, node_a, node_b = scene
    leg = migrate.LEGS[name]
    for args in calls[name]:  # each bounce's call
        args = args[1:]
        want = _one_run(name, whole, args)
        consts, lanes = migrate.home_lanes(leg, args)
        outs = migrate.park_call(leg, node_a, consts, lanes)
        ended = outs["park"] < 0
        for k in leg.result:
            assert torch.equal(_bits(outs[k][ended]), _bits(want[k][ended])), (name, k)
        first = torch.nonzero(~ended).squeeze(1)
        assert first.numel() > 0 and bool((outs["park"][first] == FOREIGN).all())
        carry = migrate.parked_carry(leg, lanes, outs, first)
        outs_b = migrate.park_call(leg, node_b, consts, carry)
        again = outs_b["park"] >= 0
        assert bool((outs_b["park"][again] > FOREIGN).all())
        assert bool((lanes["idir"][first[again], 2] > 0).all()), "a lane parked again while moving down in z"
        second = torch.nonzero(again).squeeze(1)
        outs_a = migrate.park_call(leg, node_a, consts, migrate.parked_carry(leg, carry, outs_b, second))
        assert bool((outs_a["park"] < 0).all()), "a lane parked a third time on a row of two nodes"
        got = {k: outs[k].clone() for k in leg.result}
        for k in leg.result:
            got[k][first[~again]] = outs_b[k][~again]
            got[k][first[again]] = outs_a[k]
            assert torch.equal(_bits(got[k]), _bits(want[k])), (name, k)


@pytest.mark.parametrize("name", list(LEG_MODES))
def test_park_form_without_absent_slabs_is_the_slab_form(scene, name):
    """On a grid that holds every slab no lane parks, and the park form's
    outputs are the slab form's."""
    _, calls, whole, _, _ = scene
    leg = migrate.LEGS[name]
    args = calls[name][0][1:]
    want = _one_run(name, whole, args)
    outs = migrate.park_call(leg, whole, *migrate.home_lanes(leg, args))
    assert bool((outs["park"] < 0).all())
    for k in leg.result:
        assert torch.equal(_bits(outs[k]), _bits(want[k])), (name, k)


def test_lanes_pack_and_unpack_bit_for_bit(scene):
    """A parked lane's carry packed into one byte row each and unpacked is
    the same bits, with its origin; a DDA camera lane is 96 bytes."""
    _, calls, _, node_a, _ = scene
    leg = migrate.LEGS["dda_leg_sample"]
    consts, lanes = migrate.home_lanes(leg, calls["dda_leg_sample"][0][1:])
    outs = migrate.park_call(leg, node_a, consts, lanes)
    idx = torch.nonzero(outs["park"] >= 0).squeeze(1)
    carry = migrate.parked_carry(leg, lanes, outs, idx)
    origin = torch.stack([torch.full_like(idx, 3), idx], dim=1).to(torch.int32)
    layout = migrate._layout(carry, leg.carry)
    rows = migrate._pack(carry, origin, layout)
    assert rows.dtype == torch.uint8 and tuple(rows.shape) == (idx.numel(), 96)
    back, back_origin = migrate._unpack(rows, layout)
    assert torch.equal(back_origin, origin)
    for k in leg.carry:
        assert back[k].dtype == carry[k].dtype and torch.equal(_bits(back[k]), _bits(carry[k])), k


class _OwnerHere(migrate.Row):
    """A row of two processes in which this process (0) holds slabs 1 and 2
    and process 1 slab 0, faked here: process 1's answers come from node
    B's grid."""

    def __init__(self, node_b):
        super().__init__((0, 1), (1, 0, 0), None, None)
        self.node_b = node_b
        self.asked = 0

    def ask(self, queries, answer, device):
        assert set(queries) <= {1}
        self.asked += 1
        return {r: trilinear_sum(self.node_b, q) for r, q in queries.items()}


def test_gradient_lookups_answered_by_the_owner(scene):
    """density_gradient on node A's grid of a row across nodes: the six
    lookups' taps in slab 0 are answered by its owner (one exchange a
    lookup), bit-equal to the lookups on the whole grid; slab 0 read here
    raises."""
    r, _, whole, node_a, node_b = scene
    row = _OwnerHere(node_b)
    grid = node_a._replace(row=row)
    gen = np.random.default_rng(5)
    ipos = torch.from_numpy(gen.uniform(-2.0, SIDE + 2.0, (512, 3)).astype(np.float32))
    params = r.volume_params()
    got = density_gradient(grid, params, ipos)
    assert row.asked == 6
    assert torch.equal(_bits(got), _bits(density_gradient(whole, params, ipos)))
    with pytest.raises(ValueError, match="another node"):
        trilinear_sum(node_a, ipos)


def test_render_imports_nothing_of_parallel():
    """render/ reaches parallel.migrate only through the Row that a SlabGrid
    of a row across nodes carries (modes._leg, shading.density_gradient):
    no module of render/ imports volxel_tpu_torch.parallel, at its top or
    inside a function."""
    render = Path(__file__).resolve().parent.parent / "volxel_tpu_torch" / "render"
    found = []
    for path in sorted(render.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                names = [("." * node.level) + (node.module or "")]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            found += [(path.name, n) for n in names if "parallel" in n.split(".")]
    assert len(list(render.glob("*.py"))) > 10 and not found, found
