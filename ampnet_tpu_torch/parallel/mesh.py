"""The rank mesh over ``torch.distributed`` (``ampnet_tpu/parallel/mesh.py``
in torch).

JAX runs one process over a named ``Mesh`` of devices. The port runs one
process per rank: ``initialize_distributed`` joins the process group, and
``make_mesh`` lays the ranks out row-major over the axes

  * 'data'  — data parallelism over GraphSAINT subgraph streams;
  * 'graph' — edge/node partitioning of one graph with halo exchange;
  * 'heads' — tensor parallelism over attention heads (only when > 1),

and builds one process group per axis (``new_group``), so that a collective
over an axis is a collective over that group. Each rank computes on one
device: ``cuda:(local rank % device count)``, or the CPU when asked.

The backend is NCCL where every rank has a card of its own, else gloo (the
CPU; several ranks sharing one card). Which collectives gloo takes on CUDA
tensors, and how the others are staged through host memory, is
``parallel/collectives.py``'s.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


def default_backend(device, world_size: int) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    dev = torch.device(device)
    if dev.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """The rank's device: ``cuda:(local rank % device count)`` for 'cuda'
    (the local rank from ``LOCAL_RANK``, else the global rank), or the
    device named."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if rank is None:
        rank = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> None:
    """Join the process group: ``coordinator_address`` 'host:port' (a
    ``tcp://`` rendezvous; None reads ``MASTER_ADDR``/``MASTER_PORT`` as
    torchrun sets them), ``num_processes`` ranks, this one
    ``process_id``. No-op when ``num_processes`` is None (a single-process
    run without a group). ``backend`` None: ``default_backend``."""
    if num_processes is None:
        return
    if backend is None:
        backend = default_backend(device, num_processes)
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device, process_id))
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id)


@dataclass
class Mesh:
    """This rank's view of the mesh: the axes' sizes (row-major over the
    world's ranks), its index on each, the process group of each axis
    (None for an axis of size 1 in a larger world: nothing to exchange), the global ranks of
    its group on each axis by axis index, its device and the backend.
    ``spans``, when a dict, times the collectives; ``moved`` counts the
    bytes each collective brought this rank from its peers
    (``collectives.py``)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]
    ranks: Dict[str, Tuple[int, ...]]
    device: torch.device
    backend: str
    staged: Dict[str, int] = field(default_factory=dict)   # collectives.py
    spans: Optional[Dict[str, float]] = None                 # collectives.py
    moved: Dict[str, int] = field(default_factory=dict)      # collectives.py

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)


def make_mesh(data: int = 1, graph: int = 1, heads: int = 1, device="cuda") -> Mesh:
    """This rank's ('data', 'graph'[, 'heads']) mesh over the initialized
    process group (a world of data * graph * heads ranks), one group per
    axis. Every rank must call it (``new_group`` is collective). 'heads'
    is an axis only when heads > 1, as in the JAX package."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed")
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = {"data": data, "graph": graph}
    if heads > 1:
        shape["heads"] = heads
    need = data * graph * heads
    if need != world:
        raise ValueError(f"mesh {data}x{graph}x{heads} needs {need} ranks, the world has {world}")
    names = list(shape)
    sizes = [shape[a] for a in names]

    def coords_of(r):
        out = {}
        for a, n in zip(reversed(names), reversed(sizes)):
            out[a] = r % n
            r //= n
        return out

    def rank_of(c):
        r = 0
        for a, n in zip(names, sizes):
            r = r * n + c[a]
        return r

    mine = coords_of(rank)
    groups, ranks = {}, {}
    for axis in names:
        # every group of this axis, in one order on every rank (new_group is
        # collective over the world)
        seen = []
        for r in range(world):
            c = coords_of(r)
            if c[axis] == 0:
                seen.append(tuple(rank_of({**c, axis: i}) for i in range(shape[axis])))
        for members in seen:
            # the world's group for an axis that spans it (a one-rank world
            # too: its collectives then run, through the backend), a group of
            # its own for any other axis of more than one rank
            grp = (dist.group.WORLD if shape[axis] == world
                   else dist.new_group(list(members)) if shape[axis] > 1 else None)
            if rank in members:
                groups[axis], ranks[axis] = grp, members
    backend = dist.get_backend()
    return Mesh(shape, mine, groups, ranks, rank_device(device, rank), backend)


def auto_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Split n ranks into (data, graph): an even split when n >= 4 is even,
    so both strategies run; else all-graph."""
    if n_devices % 2 == 0 and n_devices >= 4:
        return 2, n_devices // 2
    return 1, n_devices


def replicated(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole tensor on the rank's device (every rank holds all of it)."""
    return t.to(mesh.device)


def data_sharded(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rank's slice of the leading (batch) axis over 'data', on its
    device: the leading axis holds one entry per data index."""
    n = mesh.size("data")
    if t.shape[0] % n:
        raise ValueError(f"leading axis {t.shape[0]} not divisible by data={n}")
    per = t.shape[0] // n
    i = mesh.index("data")
    return t[i * per:(i + 1) * per].to(mesh.device)
