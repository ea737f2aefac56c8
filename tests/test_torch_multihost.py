"""The port's multihost layer: a no-op for one process, and two real
processes joined by torch.distributed over gloo on the CPU.

The two-process tests spawn fresh interpreters on localhost (a free port,
PYTHONPATH, one torch thread, a timeout on each), as
tests/test_multihost_real.py does for the JAX package; the workers import
neither JAX nor volxel_tpu, and each tears its group down before it
exits (gloo's threads otherwise can abort the interpreter's exit under
load). Tolerance: none. The sample-sharded frame across the processes is
bit-equal to the mean of samples 0 and 1 rendered in one process, the
pixel-sharded frame to sample 0, and a vz row across the processes (each
holding its own slab and mapping the other's) to the vz = 1 render. Rows
across nodes run on one machine with fed node identities
(multihost._node_ids, set in each worker after initialize_multihost): two
and four workers, bit-equal to the vz = 1 render, and one frame held to
the JAX package's at atol 2e-2.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu.grid import construct_brick_grid as jax_construct
from volxel_tpu.parallel import process_info as jax_process_info
from volxel_tpu.parallel.distributed import DistributedRenderer as JDistributedRenderer
from volxel_tpu.utils.fixtures import synthetic_ct_volume as jax_synthetic_ct_volume
from volxel_tpu_torch.parallel import initialize_multihost, make_mesh, multihost, nodeshare, process_info
from volxel_tpu_torch.parallel.nodeshare import NodeShares
from volxel_tpu_torch.parallel.volshard import rows_along

REPO = Path(__file__).resolve().parent.parent
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")

_WORKER = """
import sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from volxel_tpu_torch.parallel import initialize_multihost, make_mesh, multihost, nodeshare, process_info
from volxel_tpu_torch.parallel.nodeshare import NodeShares
from volxel_tpu_torch.parallel.volshard import rows_along

addr, pid = sys.argv[1], int(sys.argv[2])
assert initialize_multihost(coordinator_address=addr, num_processes=2, process_id=pid, backend="gloo") is True
assert initialize_multihost() is True  # a second call is a no-op
info = process_info()
assert info["process_count"] == 2 and info["process_index"] == pid and info["distributed"] is True, info
assert dist.get_backend() == "gloo"
x = torch.tensor([float(pid)])
dist.all_reduce(x)
gathered = multihost.all_gather(torch.tensor([pid, 10 + pid]))
assert [g.tolist() for g in gathered] == [[0, 10], [1, 11]], gathered
# blocks owned evenly in mixed order, and unevenly (one process's padded)
for owners in ([1, 0, 0, 1], [0, 1, 1]):
    local = {i: torch.full((2, 3), float(i)) for i, owner in enumerate(owners) if owner == pid}
    blocks = multihost.gather_owned(owners, local, (2, 3), torch.device("cpu"))
    assert [b.tolist() for b in blocks] == [[[float(i)] * 3] * 2 for i in range(len(owners))], (owners, blocks)
assert "jax" not in sys.modules and "volxel_tpu" not in sys.modules
print(f"proc {pid} ok: count={info['process_count']} sum={float(x[0])}", flush=True)
dist.destroy_process_group()
"""

_RENDER_WORKER = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from volxel_tpu_torch import Renderer
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.grid.brick import _dilated_brick_minmax
from volxel_tpu_torch.parallel import initialize_multihost, make_mesh, render_sample_sharded
from volxel_tpu_torch.parallel.distributed import DistributedRenderer
from volxel_tpu_torch.parallel.slab import brick_ranges_sharded
from volxel_tpu_torch.render.pathtrace import render_sample
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume

addr, pid = sys.argv[1], int(sys.argv[2])
assert initialize_multihost(coordinator_address=addr, num_processes=2, process_id=pid, backend="gloo") is True
vol = synthetic_ct_volume((16, 16, 16), bits_stored=12)
g = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))

def setup(r):
    r.restart_from_grid(g)
    r.camera.rotate_around_view(0.4, 0.2)
    r.camera.zoom(2.0)
    r.settings.bounces = 1
    return r

r = setup(Renderer(16, 16, device="cpu"))
config = r._config()
ops = (r._device_grid, r.volume_params(), r._lut, r.environment.state, *r._camera_operands(config))
bits = lambda t: t.contiguous().view(torch.int32)
s0, s1 = render_sample(config, *ops, 0), render_sample(config, *ops, 1)

# sp=2 spans the two processes: each renders one sample, and the all_gather
# of the frame gives both the mean of samples 0 and 1
procs = [(0, "cpu"), (1, "cpu")]
sp2 = make_mesh(sp=2, px=1, devices=procs)
got = render_sample_sharded(config, sp2, *ops, 0)
assert torch.equal(bits(got), bits((s0 + s1) / 2)), float((got - (s0 + s1) / 2).abs().max())
assert bool(torch.isfinite(got).all()) and float(got.max()) > 0
# px=2 spans them: each renders half of the pixels of sample 0
got = render_sample_sharded(config, make_mesh(sp=1, px=2, devices=procs), *ops, 0)
assert torch.equal(bits(got), bits(s0))
# a DistributedRenderer over the two processes: two steps are samples 0..3
dist = setup(DistributedRenderer(16, 16, mesh=sp2, device="cpu"))
dist.render_frame()
dist.render_frame()
mean01 = (s0 + s1) / 2
mean23 = (render_sample(config, *ops, 2) + render_sample(config, *ops, 3)) / 2
assert torch.equal(bits(dist._framebuffer), bits((2 * mean01 + 2 * mean23) / 4))
# brick ranges with the z-slabs on the two processes (halos by send/recv)
data = synthetic_ct_volume((20, 24, 28), bits_stored=12).astype(np.float32)
data /= data.max()
lo, hi, (bx, by, bz) = brick_ranges_sharded(data, sp2, axis="sp")
full = np.zeros((bz * 8, by * 8, bx * 8), np.float32)
full[:20, :24, :28] = data
exp_lo, exp_hi = _dilated_brick_minmax(np.pad(full, 2))
assert np.array_equal(lo, exp_lo) and np.array_equal(hi, exp_hi)
assert "jax" not in sys.modules and "volxel_tpu" not in sys.modules
print(f"proc {pid} sharded-render ok", flush=True)
torch.distributed.destroy_process_group()
"""


_SLAB_WORKER = """
import glob
import os
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from volxel_tpu_torch.api.timeseries import TimeSeriesPlayer
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.parallel import initialize_multihost, make_mesh, sharded_render_fn
from volxel_tpu_torch.parallel.distributed import DistributedRenderer
from volxel_tpu_torch.parallel.nodeshare import BLOCK_PREFIX
from volxel_tpu_torch.parallel.volshard import build_slabbed_volume_from_brick
from volxel_tpu_torch.render.pathtrace import render_sample
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume

addr, pid = sys.argv[1], int(sys.argv[2])
assert initialize_multihost(coordinator_address=addr, num_processes=2, process_id=pid, backend="gloo") is True
CPU = torch.device("cpu")
base = synthetic_ct_volume((16, 16, 16), bits_stored=12).astype(np.float32) / 4095.0
vols = np.stack([base * (1.0 - 0.3 * t) for t in range(3)])
g = construct_brick_grid(vols[0], transform=np.eye(4, dtype=np.float32))
bits = lambda t: t.contiguous().view(torch.int32)
blocks = lambda: sorted(glob.glob(f"/dev/shm/{BLOCK_PREFIX}{os.getpid()}_*"))
across = make_mesh(sp=1, px=1, vz=2, devices=[(0, "cpu"), (1, "cpu")])
mixed = make_mesh(sp=2, px=1, vz=2, devices=[(0, "cpu"), (1, "cpu"), (1, "cpu"), (0, "cpu")])
within = make_mesh(sp=2, px=1, vz=2, devices=[(0, "cpu")] * 2 + [(1, "cpu")] * 2)  # each row one process's

def setup(r, mode="default"):
    r.restart_from_grid(g)
    r.camera.rotate_around_view(0.4, 0.2)
    r.camera.zoom(2.0)
    r.settings.bounces = 1
    r.render_mode = mode
    return r

def local(sp=1):  # the one-process vz = 1 render: no position of the other process
    return DistributedRenderer(16, 16, mesh=make_mesh(sp=sp, px=1, devices=[(pid, "cpu")] * sp), device="cpu")

# the slabs: this process decodes its own and maps the other's shared block
sv = build_slabbed_volume_from_brick(g, across)
assert sorted(sv.slabs) == [(CPU, 0), (CPU, 1)] and sv.mapped == {(CPU, 1 - pid)}, (sv.slabs.keys(), sv.mapped)
(block,) = sv._shares._mapped_blocks
assert sv.slabs[(CPU, 1 - pid)].data_ptr() == torch.frombuffer(block.buf, dtype=torch.uint8).data_ptr()
assert block.name.startswith(f"{BLOCK_PREFIX}") and len(blocks()) == 1
r = setup(local())
for mode, shading in (("default", False), ("raymarch", False), ("no_dda", False), ("default", True)):
    r.render_mode = mode
    r.settings.gradient_shading = shading
    config = r._config()
    rest = (r.volume_params(), r._lut, r.environment.state, *r._camera_operands(config))
    got = sharded_render_fn(config, across)(sv, *rest, 0)
    assert torch.equal(bits(got), bits(render_sample(config, r._device_grid, *rest, 0))), (mode, shading)
sv.release()
assert blocks() == [] and sv.slabs == {}

# DistributedRenderers loaded from the brick grid, two steps a mode: the
# row across the processes, the mixed mesh, whose rows each have one part
# on each process, and sp across the processes with each row within one
for mesh, sp in ((across, 1), (mixed, 2), (within, 2)):
    for mode in ("default", "raymarch", "no_dda"):
        a, b = setup(DistributedRenderer(16, 16, mesh=mesh, device="cpu"), mode), setup(local(sp), mode)
        assert (a._slabbed._shares is None) == (mesh is within) and (mesh is within or len(blocks()) > 0)
        for _ in range(2):
            a.render_frame()
            b.render_frame()
        assert torch.equal(bits(a._framebuffer), bits(b._framebuffer)), (sp, mode)
        a.close()
    assert blocks() == []
a, b = setup(DistributedRenderer(16, 16, mesh=across, device="cpu")), setup(local())
a.settings.gradient_shading = b.settings.gradient_shading = True
assert torch.equal(bits(a.render_frame()), bits(b.render_frame()))
a.close()

# three timestep swaps (each cuts this process's slab from the whole field
# and releases the old shared blocks), bit-equal to the vz = 1 player's
a, b = setup(DistributedRenderer(16, 16, mesh=across, device="cpu")), setup(local())
frames = [list(TimeSeriesPlayer(x, vols).play(samples_per_step=2)) for x in (a, b)]
for (t0, fa), (t1, fb) in zip(*frames):
    assert t0 == t1 and np.array_equal(fa, fb), t0
assert not np.allclose(frames[0][0][1], frames[0][2][1])
assert len(blocks()) == 1 and a._slabbed.mapped == {(CPU, 1 - pid)}
a.close()
assert blocks() == []
assert "jax" not in sys.modules and "volxel_tpu" not in sys.modules
print(f"proc {pid} slabs ok", flush=True)
torch.distributed.destroy_process_group()
"""


_NODES_WORKER = """
import glob
import os
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from volxel_tpu_torch.api.timeseries import TimeSeriesPlayer
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.parallel import initialize_multihost, make_mesh, migrate, multihost, sharded_render_fn
from volxel_tpu_torch.parallel.distributed import DistributedRenderer
from volxel_tpu_torch.parallel.nodeshare import BLOCK_PREFIX
from volxel_tpu_torch.parallel.volshard import build_slabbed_volume_from_brick
from volxel_tpu_torch.render.pathtrace import render_sample
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume
from volxel_tpu_torch.utils.stepstats import step_statistics

addr, pid, layout, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
nodes, owners = {"a": (["A", "B"], [0, 1]), "b": (["A", "B"], [0, 0, 1, 1]),
                 "c": (["A", "A", "B", "B"], [0, 1, 2, 3])}[layout]
assert initialize_multihost(coordinator_address=addr, num_processes=len(nodes), process_id=pid, backend="gloo")
multihost._node_ids[:] = [f"host-{n}/boot" for n in nodes]  # fed identities: one machine, two nodes
base = synthetic_ct_volume((16, 16, 16), bits_stored=12).astype(np.float32) / 4095.0
vols = np.stack([base * (1.0 - 0.3 * t) for t in range(2)])
g = construct_brick_grid(vols[0], transform=np.eye(4, dtype=np.float32))
bits = lambda t: t.contiguous().view(torch.int32)
blocks = lambda: sorted(glob.glob(f"/dev/shm/{BLOCK_PREFIX}{os.getpid()}_*"))
row = make_mesh(sp=1, px=1, vz=len(owners), devices=[(r, "cpu") for r in owners])

def setup(r, mode="default"):
    r.restart_from_grid(g)
    r.camera.rotate_around_view(0.4, 0.2)
    r.camera.zoom(2.0)
    r.settings.bounces = 2
    r.render_mode = mode
    return r

def local():  # the one-process vz = 1 render
    return DistributedRenderer(16, 16, mesh=make_mesh(sp=1, px=1, devices=[(pid, "cpu")]), device="cpu")

migrate.CALLS.clear()
sv = build_slabbed_volume_from_brick(g, row)
grid = sv.local_grid()
absent = [v for v, s in enumerate(grid.slabs) if s is None]
assert absent == [v for v, r in enumerate(owners) if nodes[r] != nodes[pid]] and grid.row is not None, absent
assert (sv._shares is None) == (layout != "c") and (layout == "c" or blocks() == []), (sv._shares, blocks())
r = setup(local())
for mode, shading in (("default", False), ("raymarch", False), ("no_dda", False), ("default", True),
                      ("raymarch", True), ("no_dda", True)):
    r.render_mode = mode
    r.settings.gradient_shading = shading
    config = r._config()
    rest = (r.volume_params(), r._lut, r.environment.state, *r._camera_operands(config))
    got = sharded_render_fn(config, row)(sv, *rest, 0)
    assert torch.equal(bits(got), bits(render_sample(config, r._device_grid, *rest, 0))), (mode, shading)
sv.release()
del grid
moved = sum(c["moved"] for c in migrate.CALLS)  # lanes this process sent; the row's sum must be positive
assert sum(multihost.all_gather_object(moved)) > 0 and max(c["rounds"] for c in migrate.CALLS) >= 1

# DistributedRenderers loaded from the brick grid, two steps a mode; step_statistics
for mode in ("default", "raymarch", "no_dda"):
    a, b = setup(DistributedRenderer(16, 16, mesh=row, device="cpu"), mode), setup(local(), mode)
    for _ in range(2):
        a.render_frame()
        b.render_frame()
    assert torch.equal(bits(a._framebuffer), bits(b._framebuffer)), mode
    if mode == "default" and pid == 0 and layout == "a":
        np.save(out, a.image())
    if mode != "raymarch":
        assert step_statistics(a) == step_statistics(b), mode
    a.close()
# one timestep swap, two steps each, bit-equal to the vz = 1 player's
a, b = setup(DistributedRenderer(16, 16, mesh=row, device="cpu")), setup(local())
frames = [list(TimeSeriesPlayer(x, vols).play(samples_per_step=2)) for x in (a, b)]
for (t0, fa), (t1, fb) in zip(*frames):
    assert t0 == t1 and np.array_equal(fa, fb), t0
assert not np.allclose(frames[0][0][1], frames[0][1][1])
a.close()
assert blocks() == []
assert "jax" not in sys.modules and "volxel_tpu" not in sys.modules
print(f"proc {pid} nodes ok: {moved} lanes moved", flush=True)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_processes(worker_src: str, timeout: float, *args: str, processes: int = 2):
    addr = f"127.0.0.1:{_free_port()}"
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": os.environ.get("HOME", "/tmp"),
           "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo"}
    procs = [subprocess.Popen([sys.executable, "-c", worker_src, addr, str(pid), *args], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in range(processes)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{out}\n{err[-3000:]}"
    return outs


@pytest.fixture
def no_torchrun_env(monkeypatch):
    for var in TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)


def test_multihost_single_process_noop(no_torchrun_env):
    """initialize_multihost is a no-op without a coordinator; process_info
    has the JAX package's keys."""
    assert initialize_multihost() is False
    info = process_info()
    assert set(info) == set(jax_process_info())
    assert info["process_count"] == 1 and info["process_index"] == 0 and info["distributed"] is False
    assert info["global_device_count"] == info["local_device_count"]


def test_multihost_explicit_single_process(no_torchrun_env, monkeypatch):
    assert initialize_multihost(num_processes=1) is False
    assert initialize_multihost(coordinator_address="127.0.0.1:1", num_processes=1, process_id=0) is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert initialize_multihost() is False  # torchrun's variables, one process
    assert multihost.process_index() == 0


def test_multihost_coordinator_needs_a_process_id(no_torchrun_env):
    with pytest.raises(ValueError, match="process id"):
        initialize_multihost(coordinator_address="127.0.0.1:1", num_processes=2)


def test_two_process_initialize_and_all_reduce():
    outs = _run_processes(_WORKER, timeout=120)
    assert "proc 0 ok: count=2 sum=1.0" in outs[0][1]
    assert "proc 1 ok: count=2 sum=1.0" in outs[1][1]


def test_two_process_sharded_render():
    """sp = 2 and px = 2 across two processes, a DistributedRenderer over
    them and brick ranges with a slab on each: every process's result
    equals the one-process render (see the worker)."""
    outs = _run_processes(_RENDER_WORKER, timeout=240)
    assert "proc 0 sharded-render ok" in outs[0][1]
    assert "proc 1 sharded-render ok" in outs[1][1]


def test_two_process_slab_axis_renders():
    """A vz = 2 row across the two processes: each decodes its own slab
    and maps the other's shared block (its storage, not a copy). Frames
    bit-equal to the one-process vz = 1 render in every mode through
    sharded_render_fn (and with gradient shading), through
    DistributedRenderers loaded from the brick grid (two steps), on an
    sp = 2 x vz = 2 mesh whose rows each have a part on both processes, and
    over three timestep swaps; no shared block of the port's left after
    each release. A vz axis within each process, sp across them, renders
    as before, sharing nothing (see the worker)."""
    outs = _run_processes(_SLAB_WORKER, timeout=240)
    assert "proc 0 slabs ok" in outs[0][1]
    assert "proc 1 slabs ok" in outs[1][1]


def test_rows_along_raises_only_across_nodes(monkeypatch):
    """rows_along returns each row with its node groups: one group where
    the row's processes share a node, one a node where they span nodes (a
    rebooted host is another node); a row across nodes whose processes own
    unequal numbers of its positions raises, naming the equal-positions
    rule, and within a node such a row is taken (the node identities are
    fed in: no second node is needed)."""
    mesh = make_mesh(sp=1, px=1, vz=2, devices=[(0, "cpu"), (1, "cpu")])
    monkeypatch.setattr(multihost, "_node_ids", ["host-a/boot-1", "host-a/boot-1"])
    assert rows_along(mesh, "vz") == [((0, 0), [(0, 0, 0), (0, 0, 1)], [[0, 1]])]
    monkeypatch.setattr(multihost, "_node_ids", ["host-a/boot-1", "host-b/boot-2"])
    assert rows_along(mesh, "vz") == [((0, 0), [(0, 0, 0), (0, 0, 1)], [[0], [1]])]
    monkeypatch.setattr(multihost, "_node_ids", ["host-a/boot-1", "host-a/boot-2"])  # rebooted: another node
    assert [nodes for *_, nodes in rows_along(mesh, "vz")] == [[[0], [1]]]
    unequal = make_mesh(sp=1, px=1, vz=3, devices=[(0, "cpu"), (0, "cpu"), (1, "cpu")])
    with pytest.raises(ValueError, match="equal-positions rule"):
        rows_along(unequal, "vz")
    monkeypatch.setattr(multihost, "_node_ids", ["host-a/boot-1", "host-a/boot-1"])
    assert [nodes for *_, nodes in rows_along(unequal, "vz")] == [[[0, 1, 2]]]


def _nodes_run(layout: str, tmp_path) -> list:
    processes = 4 if layout == "c" else 2
    outs = _run_processes(_NODES_WORKER, 240, layout, str(tmp_path / "frame.npy"), processes=processes)
    for pid, (_, out, _) in enumerate(outs):
        assert f"proc {pid} nodes ok" in out
    return outs


def test_slab_row_across_two_nodes(tmp_path):
    """A vz = 2 row across two processes on two fed nodes: each holds its
    own slab, the other's is absent (no shared block is made), and lanes
    move across. Frames bit-equal to the one-process vz = 1 render in every
    mode, with gradient shading, through DistributedRenderers loaded from
    the brick grid (two steps) and over a timestep swap; step_statistics
    equal (see the worker). Process 0's default frame meets the JAX
    package's vz = 2 DistributedRenderer at test_torch_volshard's atol
    2e-2."""
    _nodes_run("a", tmp_path)
    vol = jax_synthetic_ct_volume((16, 16, 16), bits_stored=12).astype(np.float32) / 4095.0
    theirs = JDistributedRenderer(width=16, height=16, sp=1, px=4, vz=2)
    theirs.restart_from_grid(jax_construct(vol, transform=np.eye(4, dtype=np.float32)))
    theirs.camera.rotate_around_view(0.4, 0.2)
    theirs.camera.zoom(2.0)
    theirs.settings.bounces = 2
    for _ in range(2):
        theirs.render_frame()
    np.testing.assert_allclose(np.load(tmp_path / "frame.npy"), np.asarray(theirs.image()), rtol=0, atol=2e-2)


def test_slab_row_across_nodes_one_process_a_host(tmp_path):
    """vz = 4 over two processes on two fed nodes, each owning two
    positions of the row (one process a host): bit-equal to vz = 1 as
    above."""
    _nodes_run("b", tmp_path)


def test_slab_row_within_and_across_nodes(tmp_path):
    """Four processes on fed nodes [A, A, B, B] and vz = 4: within a node
    the slabs are shared (shared memory on the CPU, CUDA IPC on cards),
    across nodes lanes move; bit-equal to vz = 1 as above."""
    _nodes_run("c", tmp_path)


def test_default_mesh_refuses_processes_sharing_a_node_of_cards(monkeypatch):
    """Several processes of one node that each see several cards (one
    process a card under torchrun) would each be listed with every card:
    the default mesh raises and names the explicit (rank, card) form; one
    card a process, or one process a node, is taken as it is."""
    monkeypatch.setattr(multihost, "_initialized", True)
    monkeypatch.setattr(multihost, "_device_counts", [2, 2])
    monkeypatch.setattr(multihost, "_node_ids", ["host-a/boot-1", "host-a/boot-1"])
    with pytest.raises(ValueError, match=r"devices=\[\(rank, f'cuda:\{local\}'\)"):
        multihost.global_devices()
    monkeypatch.setattr(multihost, "_node_ids", ["host-a/boot-1", "host-b/boot-2"])
    assert [(r, str(d)) for r, d in multihost.global_devices()] == [(0, "cuda:0"), (0, "cuda:1"), (1, "cuda:0"),
                                                                   (1, "cuda:1")]
    monkeypatch.setattr(multihost, "_device_counts", [1, 1])
    monkeypatch.setattr(multihost, "_node_ids", ["host-a/boot-1", "host-a/boot-1"])
    assert [(r, str(d)) for r, d in multihost.global_devices()] == [(0, "cuda:0"), (1, "cuda:0")]


def test_node_shares_refuse_without_falling_back(monkeypatch):
    """A slab on a card this process does not see raises (a handle is never
    opened on another card), and so does an export under
    expandable_segments, which torch's allocator cannot share; the node
    identity names the host and its boot."""
    record = {"uuid": "GPU-00000000-0000-0000-0000-000000000000", "args": {}}
    with pytest.raises(RuntimeError, match="does not see"):
        NodeShares().open(record, torch.device("cuda", 0))
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    with pytest.raises(RuntimeError, match="expandable_segments"):
        nodeshare._check_ipc_allocator()
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "max_split_size_mb:128")
    nodeshare._check_ipc_allocator()
    assert multihost.node_identity().startswith(socket.gethostname() + "/")
