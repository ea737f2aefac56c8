"""Multi-process (multi-host) initialization on torch.distributed: the
PyTorch counterpart of volxel_tpu.parallel.multihost.

Each host runs one process that owns every card of the host, as in the
JAX package's single-controller model; initialize_multihost joins the
processes into one torch.distributed group, and the mesh axes
(sp/px, parallel/mesh.py) then span every process's cards. A step
combines the processes' positions with one collective on the frame
(parallel/shard.py). Single-process behavior is unchanged: without a
coordinator, or with one process, initialize_multihost() is a no-op.

Typical use, one process per host under torchrun
(`torchrun --nnodes=N --nproc-per-node=1 ...`, which sets MASTER_ADDR,
MASTER_PORT, RANK and WORLD_SIZE) or with explicit arguments:

    from volxel_tpu_torch.parallel import initialize_multihost, make_mesh
    initialize_multihost()          # no-op in a single process
    mesh = make_mesh(sp=2, px=2)    # spans every process's cards

The backend is "nccl" unless the caller asks for another ("gloo", e.g.
for processes on the CPU or two processes sharing one card, which NCCL
refuses); it is never changed behind the caller's back.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_initialized = False
# every process's device count, in rank order, read once when the group forms
_device_counts: list[int] = []


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> bool:
    """Join torch.distributed if this looks like a multi-process run.

    coordinator_address is "host:port" (or a full "tcp://host:port"
    init method); the defaults come from torchrun's MASTER_ADDR /
    MASTER_PORT, WORLD_SIZE and RANK. Returns True when distributed mode
    was (or already is) active, False for the single-process no-op path.
    Safe to call more than once."""
    global _initialized
    if _initialized:
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None or num_processes in (None, 1):
        return False  # single process: nothing to do
    if process_id is None:
        raise ValueError("initialize_multihost: a process id (or RANK) is needed with a coordinator")
    init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend or "nccl", init_method=init_method, world_size=num_processes, rank=process_id)
    counts: list = [None] * num_processes
    dist.all_gather_object(counts, torch.cuda.device_count())
    _device_counts[:] = [int(c) for c in counts]
    _initialized = True
    return True


def process_index() -> int:
    return dist.get_rank() if _initialized else 0


def global_devices() -> list[tuple[int, torch.device]]:
    """(rank, card) of every card of every process, in rank order; this
    process's cards alone before initialize_multihost."""
    counts = _device_counts if _initialized else [torch.cuda.device_count()]
    return [(rank, torch.device("cuda", i)) for rank, count in enumerate(counts) for i in range(count)]


def all_gather(tensor: torch.Tensor) -> list[torch.Tensor]:
    """Every process's `tensor` (one shape on all), in rank order, on
    `tensor`'s device. gloo gathers CPU tensors only, so under gloo a
    CUDA tensor goes through pinned host memory and back."""
    staged = tensor.is_cuda and dist.get_backend() == "gloo"
    src = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True).copy_(tensor) if staged else tensor
    out = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(out, src.contiguous())
    return [o.to(tensor.device) for o in out] if staged else out


def exchange(sends: list, recvs: list) -> None:
    """Point-to-point messages between processes, posted together:
    `sends` and `recvs` hold (tensor, peer rank, tag); each received
    tensor is filled in place. Under gloo, which sends CPU tensors only,
    CUDA tensors go through host memory."""
    staged = dist.get_backend() == "gloo"

    def host(t):
        return t.cpu() if staged and t.is_cuda else t

    sends = [(host(t).contiguous(), peer, tag) for t, peer, tag in sends]
    bufs = [(t, host(torch.empty_like(t)) if staged and t.is_cuda else t, peer, tag) for t, peer, tag in recvs]
    ops = [dist.P2POp(dist.isend, t, peer, tag=tag) for t, peer, tag in sends]
    ops += [dist.P2POp(dist.irecv, buf, peer, tag=tag) for _, buf, peer, tag in bufs]
    for work in dist.batch_isend_irecv(ops) if ops else []:
        work.wait()
    for t, buf, _, _ in bufs:
        if buf is not t:
            t.copy_(buf)


def gather_owned(owners: list[int], local: dict, shape: tuple, device: torch.device) -> list[torch.Tensor]:
    """Block i of len(owners) f32 blocks of `shape`, which process
    owners[i] holds, for every i, on `device`: this process's blocks are
    `local` (index -> tensor); the others come from one all_gather of
    every process's own blocks in index order, padded to the most that
    one process owns (no padding where each owns as many, as on the
    meshes make_mesh builds by default)."""
    if len(local) == len(owners):
        return [local[i].to(device) for i in range(len(owners))]
    owned = [[i for i, owner in enumerate(owners) if owner == rank] for rank in range(dist.get_world_size())]
    mine = owned[dist.get_rank()]
    buf = torch.zeros((max(map(len, owned)), *shape), dtype=torch.float32, device=device)
    for slot, i in enumerate(mine):
        buf[slot] = local[i]
    gathered = all_gather(buf)
    blocks = [None] * len(owners)
    for rank, indices in enumerate(owned):
        for slot, i in enumerate(indices):
            blocks[i] = gathered[rank][slot]
    return blocks


def process_info() -> dict:
    """Process/device topology summary for logs and benchmark records."""
    local = torch.cuda.device_count()
    return {
        "process_index": process_index(),
        "process_count": dist.get_world_size() if _initialized else 1,
        "local_device_count": local,
        "global_device_count": sum(_device_counts) if _initialized else local,
        "distributed": _initialized,
    }
