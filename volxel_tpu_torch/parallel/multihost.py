"""Multi-process (multi-host) initialization on torch.distributed: the
PyTorch counterpart of volxel_tpu.parallel.multihost.

Two layouts. One process a host that owns every card of the host, as in
the JAX package's single-controller model (`torchrun --nnodes=N
--nproc-per-node=1`), whose mesh defaults to every card of every process;
or one process a card (`torchrun --nproc-per-node=8` on a node of eight),
which a 'vz' axis across processes needs (its slabs are shared within a
node, parallel/nodeshare.py). In the second layout each process reports
every card it sees, so the default mesh would name each card once a
process: global_devices raises there, and the caller names each
position's (rank, card) instead, e.g.
`make_mesh(vz=n, devices=[(rank, f"cuda:{rank % 8}") for rank in range(n)])`.
initialize_multihost joins the processes into one torch.distributed
group and records each one's card count and node (host name and boot
id); the mesh axes (sp/px/vz, parallel/mesh.py) then span the processes'
positions. A step combines the processes' positions with one collective
on the frame (parallel/shard.py). Single-process behavior is unchanged:
without a coordinator, or with one process, initialize_multihost() is a
no-op.

Typical use under torchrun (which sets MASTER_ADDR, MASTER_PORT, RANK
and WORLD_SIZE) or with explicit arguments:

    from volxel_tpu_torch.parallel import initialize_multihost, make_mesh
    initialize_multihost()          # no-op in a single process
    mesh = make_mesh(sp=2, px=2)    # one process a host: every process's cards

The backend is "nccl" unless the caller asks for another ("gloo", e.g.
for processes on the CPU or two processes sharing one card, which NCCL
refuses); it is never changed behind the caller's back. The small host
messages of this module (all_gather_object, host_barrier) go through a
gloo group whatever the backend: the default group under gloo, else one
made when the group forms.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

_initialized = False
# every process's device count and node, in rank order, read once when the group forms
_device_counts: list[int] = []
_node_ids: list[str] = []
_host_group = None  # the gloo group of the host messages (None: the default group, which is gloo)
_row_groups: dict[tuple, tuple] = {}  # a cross-node row's ranks -> its (lanes, counts) groups, card


def node_identity() -> str:
    """This machine's identity: its host name and the kernel's boot id, so
    that two processes agree exactly when they share a node."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:  # not Linux: the host name alone
        boot = ""
    return f"{socket.gethostname()}/{boot}"


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
    global _initialized, _host_group
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
    _host_group = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    _initialized = True
    found = all_gather_object((torch.cuda.device_count(), node_identity()))
    _device_counts[:] = [int(count) for count, _ in found]
    _node_ids[:] = [node for _, node in found]
    return True


def process_index() -> int:
    return dist.get_rank() if _initialized else 0


def node_of(rank: int) -> str:
    """The node process `rank` runs on ("" before initialize_multihost)."""
    return _node_ids[rank] if _node_ids else ""


def same_node(ranks) -> bool:
    """Whether the processes `ranks` all run on one node (always, before
    initialize_multihost: there is one process)."""
    return len({node_of(r) for r in ranks}) <= 1


def all_gather_object(obj) -> list:
    """Every process's `obj` (picklable), in rank order, through the gloo
    group of the host messages: a collective every process calls."""
    out: list = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj, group=_host_group)
    return out


def host_barrier() -> None:
    """Wait on the host until every process has reached this call (a gloo
    barrier, which neither waits for nor enqueues device work)."""
    dist.barrier(group=_host_group)


def global_devices() -> list[tuple[int, torch.device]]:
    """(rank, card) of every card of every process, in rank order; this
    process's cards alone before initialize_multihost. Raises where
    several processes of one node see more than one card each (one process
    a card, e.g. `torchrun --nproc-per-node=8`): each would be listed with
    every card of the node, and which card belongs to which process is the
    caller's to say."""
    counts = _device_counts if _initialized else [torch.cuda.device_count()]
    if _initialized:
        for node in set(_node_ids):
            ranks = [r for r, n in enumerate(_node_ids) if n == node]
            if len(ranks) > 1 and any(counts[r] > 1 for r in ranks):
                raise ValueError(
                    f"processes {ranks} share a node and each sees {[counts[r] for r in ranks]} cards, so a mesh "
                    "of every card of every process would name each card once a process; name each position's "
                    "process and card: make_mesh(..., devices=[(rank, f'cuda:{local}'), ...])")
    return [(rank, torch.device("cuda", i)) for rank, count in enumerate(counts) for i in range(count)]


def row_groups(ranks: tuple[int, ...]) -> tuple:
    """The process groups of a 'vz' row whose processes `ranks` span nodes
    (parallel.migrate): one on the default group's backend for the lanes,
    a gloo twin for the counts that precede them (the same group under
    gloo), and the card the lanes go through (None under gloo). Made once
    for each set of ranks; new_group is collective over every process, so
    every process asks for every such row, in one order (parallel.volshard
    builds them with the volume), and later volumes of the same rows reuse
    them.

    Under NCCL the processes of the row join the lanes group at once, with
    an all_reduce on this process's current card: a group's first batched
    point-to-point call must involve every rank of the group, and a round
    of migrate's leg calls involves only the processes that send or receive
    lanes. Each process's lanes then go through that one card, so no later
    call opens the group on another card."""
    if ranks not in _row_groups:
        lanes = dist.new_group(list(ranks), backend=dist.get_backend())
        card = None
        counts = lanes
        if dist.get_backend() != "gloo":
            counts = dist.new_group(list(ranks), backend="gloo")
            if dist.get_rank() in ranks:
                card = torch.device("cuda", torch.cuda.current_device())
                dist.all_reduce(torch.zeros(1, device=card), group=lanes)
        _row_groups[ranks] = (lanes, counts, card)
    return _row_groups[ranks]


def all_gather(tensor: torch.Tensor) -> list[torch.Tensor]:
    """Every process's `tensor` (one shape on all), in rank order, on
    `tensor`'s device. gloo gathers CPU tensors only, so under gloo a
    CUDA tensor goes through pinned host memory and back."""
    staged = tensor.is_cuda and dist.get_backend() == "gloo"
    src = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True).copy_(tensor) if staged else tensor
    out = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(out, src.contiguous())
    return [o.to(tensor.device) for o in out] if staged else out


def exchange(sends: list, recvs: list, group=None) -> None:
    """Point-to-point messages between processes, posted together:
    `sends` and `recvs` hold (tensor, peer rank, tag); each received
    tensor is filled in place. Under gloo, which sends CPU tensors only,
    CUDA tensors go through host memory. `group` is the group the messages
    go through (the default group by default); peers are global ranks."""
    staged = dist.get_backend() == "gloo"

    def host(t):
        return t.cpu() if staged and t.is_cuda else t

    sends = [(host(t).contiguous(), peer, tag) for t, peer, tag in sends]
    bufs = [(t, host(torch.empty_like(t)) if staged and t.is_cuda else t, peer, tag) for t, peer, tag in recvs]
    ops = [dist.P2POp(dist.isend, t, peer, group=group, tag=tag) for t, peer, tag in sends]
    ops += [dist.P2POp(dist.irecv, buf, peer, group=group, tag=tag) for _, buf, peer, tag in bufs]
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
