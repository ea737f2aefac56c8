"""Volume slabs shared between the processes of one node, read in place.

A 'vz' row whose positions lie on several processes of a node
(parallel/volshard.py) has each process build only the slabs of its own
positions; it exports each of them here, the processes exchange the
records (multihost.all_gather_object), and each maps the slabs its rows
need from the others into its own address space. Nothing is copied: the
legs' kernels load a mapped slab through the slab table like any other
device pointer (render.sampling.SlabGrid), and the plain lookups gather
from a mapped CPU slab like from their own.

On a card the route is CUDA IPC through torch's own reductions
(torch.multiprocessing.reductions.reduce_tensor / rebuild_cuda_tensor):
cudaIpcGetMemHandle of the slab's allocation with the slab's offset in
it, opened with cudaIpcOpenMemHandle(cudaIpcMemLazyEnablePeerAccess). On
the CPU it is a named POSIX shared-memory block
(multiprocessing.shared_memory, names starting with BLOCK_PREFIX) that
holds the owner's slab, which every process views as a bf16 tensor
(torch.frombuffer). No process-wide sharing strategy is set.

The rules:

  * Writes before reads. torch records an interprocess event on the
    owner's current stream when it exports a slab, after the writes that
    built it, and the reading card's current stream waits on it when the
    handle is opened; the SlabbedVolume then records its `ready` event on
    that stream (render.sampling.slabs_written), which every launch
    through the table waits on (SlabGrid.table). A CPU slab is written
    before the records are exchanged.
  * Reads before the drop. A process drops shared slabs only in
    SlabbedVolume.release, which every process of the mesh calls (a
    time-series swap, restart_from_grid and DistributedRenderer.close
    do): each process first synchronizes the cards that read the slabs,
    then closes its mappings, then waits on a host barrier
    (multihost.host_barrier, gloo, so it holds under NCCL too, whose
    step all_gather does not wait on the host), and only then are the
    owners' blocks freed (torch.cuda.ipc_collect) or unlinked. torch's
    reference count on an exported block keeps it allocated while any
    process holds a mapping, so a mapping that outlives release() keeps
    its bytes valid.
  * Device numbering and contexts. A mapping serves the card whose
    context opened it, so a slab is opened on the card that reads it, and
    the bytes stay on the owner's card, which that card reaches by peer
    access (kernels.enable_peer_access, which raises where it cannot). A
    record names the owner's card by UUID, which the reader maps to its
    own index of that card (processes that see different
    CUDA_VISIBLE_DEVICES number cards differently); a card the reader
    does not see raises. torch maps a handle once a process, so a slab
    read from two cards of one process raises (one process a card is the
    layout this serves).
  * No fallback. An export or an open that fails raises, and so does
    `expandable_segments:True` in PYTORCH_CUDA_ALLOC_CONF, under which
    torch's allocator refuses IPC export; nothing turns into a copy.
  * A process never opens its own handle (CUDA refuses it): its own
    slabs stay the tensors it built, and on the CPU the views of its own
    blocks.
"""

from __future__ import annotations

import inspect
import itertools
import math
import os
from multiprocessing import resource_tracker
from multiprocessing.shared_memory import SharedMemory

import torch
from torch.multiprocessing.reductions import rebuild_cuda_tensor, reduce_tensor

from volxel_tpu_torch import kernels
from volxel_tpu_torch.parallel import multihost

BLOCK_PREFIX = "vx_slab_"
_blocks = itertools.count()


def _card_uuid(index: int) -> str:
    return str(torch.cuda.get_device_properties(index).uuid)


def _card_of(uuid: str) -> torch.device:
    """This process's device of the card with `uuid`; raises where this
    process does not see it."""
    cards = {_card_uuid(i): i for i in range(torch.cuda.device_count())}
    if uuid not in cards:
        raise RuntimeError(f"a slab lies on card {uuid}, which this process does not see (it sees {sorted(cards)}); "
                           "every process of a node that shares a vz row must see the cards of the row "
                           "(CUDA_VISIBLE_DEVICES)")
    return torch.device("cuda", cards[uuid])


def _check_ipc_allocator() -> None:
    """Raise where torch's allocator refuses IPC export."""
    for var in ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"):
        conf = os.environ.get(var, "").replace(" ", "").lower()
        if "expandable_segments:true" in conf:
            raise RuntimeError(f"{var}={os.environ[var]!r}: torch's allocator refuses CUDA IPC export of "
                               "expandable segments, and slabs read across processes are mapped through CUDA "
                               "IPC; unset expandable_segments for a vz axis across processes")


class NodeShares:
    """The slabs one SlabbedVolume exported and mapped, and their
    release. `export` and `open` run while the volume is built; `close`
    once, in SlabbedVolume.release, after the caller dropped its tensors."""

    def __init__(self):
        self._own_blocks: list[SharedMemory] = []  # CPU blocks this process made
        self._mapped_blocks: list[SharedMemory] = []  # CPU blocks of other processes, opened here
        self._opened: dict[bytes, torch.device] = {}  # an IPC handle mapped here -> the card it serves
        self._cuda = False

    def export(self, slab: torch.Tensor) -> tuple[dict, torch.Tensor]:
        """A record of `slab` that another process of the node opens with
        `open`, and the slab as this process keeps it: the same tensor on a
        card; on the CPU its copy in a new shared block, which the caller
        keeps in its place."""
        if slab.is_cuda:
            _check_ipc_allocator()
            self._cuda = True
            _, args = reduce_tensor(slab)
            names = inspect.signature(rebuild_cuda_tensor).parameters
            return {"uuid": _card_uuid(slab.device.index), "args": dict(zip(names, args))}, slab
        block = SharedMemory(name=f"{BLOCK_PREFIX}{os.getpid()}_{next(_blocks)}", create=True,
                             size=slab.numel() * slab.element_size())
        self._own_blocks.append(block)
        view = _view(block, slab.dtype, slab.shape)
        view.copy_(slab)
        return {"block": block.name, "dtype": slab.dtype, "shape": tuple(slab.shape)}, view

    def open(self, record: dict, reader: torch.device) -> torch.Tensor:
        """The slab of another process's `record`, mapped into this process
        for the kernels of card `reader`: on a card, the handle is opened in
        `reader`'s context (a mapping serves the context it was opened in;
        the bytes stay on the owner's card, which `reader` must reach by
        peer access), and `reader`'s current stream waits on the owner's
        writes. torch maps a handle once a process, so one slab is mapped
        on one card of a process."""
        if "block" not in record:
            owner = _card_of(record["uuid"])
            kernels.enable_peer_access(reader, owner)
            first = self._opened.setdefault(record["args"]["storage_handle"], reader)
            if first != reader:
                raise NotImplementedError(f"a slab on {owner} is read from {first} and {reader} of one process: "
                                          "torch maps a CUDA IPC handle once a process, in one card's context; "
                                          "give each process one card of a vz row")
            self._cuda = True
            return rebuild_cuda_tensor(**dict(record["args"], storage_device=reader.index))
        block = SharedMemory(name=record["block"])
        # the owner unlinks its block (close); the reader's resource tracker must not
        resource_tracker.unregister(block._name, "shared_memory")
        self._mapped_blocks.append(block)
        return _view(block, record["dtype"], record["shape"])

    def close(self) -> None:
        """Close this process's mappings, wait on a host barrier until every
        process has closed its own, then free or unlink the blocks this
        process exported. The caller has synchronized the cards that read
        the slabs and dropped its references to them."""
        for block in self._mapped_blocks:
            _close(block)
        multihost.host_barrier()
        for block in self._own_blocks:
            _close(block)
            block.unlink()
        if self._cuda:
            torch.cuda.ipc_collect()
        self._own_blocks, self._mapped_blocks = [], []


def _view(block: SharedMemory, dtype: torch.dtype, shape: tuple) -> torch.Tensor:
    return torch.frombuffer(block.buf, dtype=dtype, count=math.prod(shape)).view(shape)


def _close(block: SharedMemory) -> None:
    try:
        block.close()
    except BufferError:
        # a view of the block outlives release() (a SlabGrid a caller kept):
        # its mapping stays until the view dies, and the bytes stay valid
        pass
