"""The port's multihost layer: a no-op for one process, and two real
processes joined by torch.distributed over gloo on the CPU.

The two-process tests spawn fresh interpreters on localhost (a free port,
PYTHONPATH, one torch thread, a timeout on each), as
tests/test_multihost_real.py does for the JAX package; the workers import
neither JAX nor volxel_tpu. Tolerance: none. The sample-sharded frame
across the processes is bit-equal to the mean of samples 0 and 1 rendered
in one process, and the pixel-sharded frame to sample 0.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu.parallel import process_info as jax_process_info
from volxel_tpu_torch.parallel import initialize_multihost, multihost, process_info

REPO = Path(__file__).resolve().parent.parent
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")

_WORKER = """
import sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from volxel_tpu_torch.parallel import initialize_multihost, multihost, process_info

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
"""


_SLAB_WORKER = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.parallel import initialize_multihost, make_mesh, sharded_render_fn
from volxel_tpu_torch.parallel.distributed import DistributedRenderer
from volxel_tpu_torch.render.pathtrace import RenderConfig
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume

addr, pid = sys.argv[1], int(sys.argv[2])
assert initialize_multihost(coordinator_address=addr, num_processes=2, process_id=pid, backend="gloo") is True
vol = synthetic_ct_volume((16, 16, 16), bits_stored=12)
g = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
mesh = make_mesh(sp=1, px=1, vz=2, devices=[(0, "cpu"), (1, "cpu")])
for attempt in (lambda: sharded_render_fn(RenderConfig(width=16, height=16), mesh),
                lambda: DistributedRenderer(16, 16, mesh=mesh, device="cpu").restart_from_grid(g)):
    try:
        attempt()
    except NotImplementedError as e:
        assert "ROADMAP.md, queue 1, 'Slabs across processes'" in str(e), e
    else:
        raise AssertionError("a vz axis across processes did not raise")
# a vz axis inside each process, with sp across them, renders
dist = DistributedRenderer(16, 16, mesh=make_mesh(sp=2, px=1, vz=2, devices=[(0, "cpu")] * 2 + [(1, "cpu")] * 2),
                           device="cpu")
dist.restart_from_grid(g)
assert bool(torch.isfinite(dist.render_frame()).all())
assert "jax" not in sys.modules and "volxel_tpu" not in sys.modules
print(f"proc {pid} slabs ok", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two_process(worker_src: str, timeout: float):
    addr = f"127.0.0.1:{_free_port()}"
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": os.environ.get("HOME", "/tmp"),
           "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo"}
    procs = [subprocess.Popen([sys.executable, "-c", worker_src, addr, str(pid)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for pid in (0, 1)]
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
    outs = _run_two_process(_WORKER, timeout=120)
    assert "proc 0 ok: count=2 sum=1.0" in outs[0][1]
    assert "proc 1 ok: count=2 sum=1.0" in outs[1][1]


def test_two_process_sharded_render():
    """sp = 2 and px = 2 across two processes, a DistributedRenderer over
    them and brick ranges with a slab on each: every process's result
    equals the one-process render (see the worker)."""
    outs = _run_two_process(_RENDER_WORKER, timeout=240)
    assert "proc 0 sharded-render ok" in outs[0][1]
    assert "proc 1 sharded-render ok" in outs[1][1]


def test_two_process_slab_axis_raises_naming_the_roadmap():
    """A vz axis whose positions span the two processes raises
    NotImplementedError naming its ROADMAP.md item, in sharded_render_fn
    and in DistributedRenderer.restart_from_grid; a vz axis within each
    process, sp across them, renders (see the worker)."""
    outs = _run_two_process(_SLAB_WORKER, timeout=240)
    assert "proc 0 slabs ok" in outs[0][1]
    assert "proc 1 slabs ok" in outs[1][1]
