"""Multi-process helpers for the distributed search path.

Counterpart of rag_icd10_tpu/parallel/multihost.py (:19-51). JAX joins
processes with ``jax.distributed``; the port with ``torch.distributed``:
NCCL between cards, gloo between CPU processes (the CPU tests). Nothing
tells a program of a cluster here, so ``initialize`` takes the
coordinator's address, the world size and this process's rank.

- ``initialize`` starts the default process group and records this
  process's devices, which ``mesh.make_mesh`` then joins across ranks.
- ``global_device_put`` places this rank's row blocks of an array that
  every process holds whole, one block per shard of a mesh axis.
- ``global_sum`` sums such blocks across every rank: one ``all_reduce``.
"""

from __future__ import annotations

from datetime import timedelta
from typing import List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

#: this process's devices, set by ``initialize``
_LOCAL_DEVICES: List[torch.device] = []


def initialize(
    coordinator: str,
    num_processes: int,
    process_id: int,
    local_device_count: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    timeout_s: float = 60.0,
) -> None:
    """Join ``num_processes`` processes through ``coordinator``
    ("host:port", a ``tcp://`` rendezvous that rank 0 serves).

    On ``cuda`` the backend is NCCL and this process uses its first
    ``local_device_count`` cards (default: all it sees); NCCL refuses two
    ranks on one card. On ``cpu`` the backend is gloo and the process
    holds ``local_device_count`` logical CPU devices (default 1).
    ``timeout_s`` bounds the rendezvous and every collective."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = local_device_count or torch.cuda.device_count()
        local = [torch.device("cuda", i) for i in range(count)]
        torch.cuda.set_device(local[0])
        backend = "nccl"
    else:
        local = [torch.device("cpu")] * (local_device_count or 1)
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=timedelta(seconds=timeout_s),
    )
    _LOCAL_DEVICES[:] = local


def shutdown() -> None:
    """Leave the process group ``initialize`` joined."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL_DEVICES.clear()


def local_devices(device_type: Optional[str] = None) -> List[torch.device]:
    """This process's devices of ``device_type`` (default: those
    ``initialize`` recorded, else ``cuda``): the recorded ones where their
    type matches, else every CUDA card (``cuda``; raises without one) or
    the one CPU (``cpu``)."""
    if _LOCAL_DEVICES and device_type in (None, _LOCAL_DEVICES[0].type):
        return list(_LOCAL_DEVICES)
    device_type = device_type or "cuda"
    resolve_device(device_type)
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def global_device_put(x, mesh, axis: str = "dp") -> List[Optional[torch.Tensor]]:
    """Row blocks of ``x`` (numpy or tensor, the SAME whole array in every
    process), one per index along ``axis``: a tensor on its device where
    this rank owns the shard, None where another rank does. The rows must
    divide evenly."""
    owners = mesh.axis_devices(axis)
    n = x.shape[0]
    if n % len(owners):
        raise ValueError(f"{n} rows do not split into {len(owners)} shards")
    rows = n // len(owners)
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    return [
        t[i * rows:(i + 1) * rows].to(dev).contiguous() if rank == mesh.rank else None
        for i, (rank, dev) in enumerate(owners)
    ]


def collective_device(mesh) -> torch.device:
    """Where this rank's tensors meet its process group's collectives: its
    current card under NCCL, the CPU under gloo."""
    if mesh.group is not None and dist.get_backend(mesh.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_sum(parts: List[Optional[torch.Tensor]], mesh) -> float:
    """Sum of every shard's elements across the mesh (blocks as
    ``global_device_put`` returns them): each rank sums its own, then one
    ``all_reduce`` where the mesh has a process group."""
    dev = collective_device(mesh)
    local = [p.sum(dtype=torch.float32).to(dev) for p in parts if p is not None]
    total = torch.stack(local).sum() if local else torch.zeros((), device=dev)
    if mesh.group is not None:
        dist.all_reduce(total, group=mesh.group)
    return float(total)
