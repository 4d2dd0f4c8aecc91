"""Device mesh for corpus-sharded search.

Counterpart of rag_icd10_tpu/parallel/mesh.py (``make_mesh``, :25-45). A
``Mesh`` is a grid of ``torch.device``s with named axes, the process rank
that owns each device, and the process group that joins those ranks
(None in one process). Search shards the corpus rows along one axis
(parallel/search.py); each shard lives on the device at index 0 of the
mesh's other axes.

- By default a mesh covers every local CUDA card, or, once
  ``torch.distributed`` is initialized (parallel/multihost.py), every
  rank's devices in rank order, as ``jax.devices()`` covers every
  process's devices under ``jax.distributed``.
- A mesh may name one device more than once: **logical shards**, the
  port's counterpart of the virtual CPU devices the JAX package's tests
  force (``--xla_force_host_platform_device_count``). They run each
  shard's kernels on one card or one CPU, so a single H100 and the CPU
  tests drive the sharded code at any shard count.

The JAX module's tensor-parallel rules (``param_shardings``,
``batch_sharding``) serve only its training step; they come with the
port of parallel/train.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .multihost import local_devices

Device = Union[str, torch.device]


class Mesh:
    """A grid of devices with named axes.

    devices:    object array of ``torch.device``, one axis per name
    ranks:      int array of the same shape, the process owning each device
    group:      the process group across the ranks, or None (one process)
    rank:       this process's rank in ``group`` (0 without one)
    """

    def __init__(
        self,
        devices: np.ndarray,
        axis_names: Sequence[str],
        ranks: Optional[np.ndarray] = None,
        group=None,
        rank: int = 0,
    ):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"devices of shape {self.devices.shape} for axes {self.axis_names}"
            )
        self.ranks = (
            np.zeros(self.devices.shape, np.int64) if ranks is None
            else np.asarray(ranks, np.int64).reshape(self.devices.shape)
        )
        self.group = group
        self.rank = rank

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[Tuple[int, torch.device]]:
        """(owner rank, device) of each index along ``axis``, taken at
        index 0 of every other axis."""
        pos = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[pos]):
            index[pos] = i
            out.append((int(self.ranks[tuple(index)]), self.devices[tuple(index)]))
        return out

    def __repr__(self) -> str:
        where = f", {dist.get_world_size(self.group)} ranks" if self.group else ""
        return f"Mesh({self.shape}{where})"


def _gather_devices(local: List[torch.device]) -> Tuple[List[torch.device], List[int]]:
    """Every rank's local devices in rank order, and their owners."""
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, [str(d) for d in local])
    devices, ranks = [], []
    for r, names in enumerate(per_rank):
        devices += [torch.device(n) for n in names]
        ranks += [r] * len(names)
    return devices, ranks


def make_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    tp: Optional[int] = None,
    axis_names: Sequence[str] = ("dp", "tp"),
    devices: Optional[Sequence[Device]] = None,
    distributed: Optional[bool] = None,
) -> Mesh:
    """Build a mesh over the available devices.

    Two axis names give a (dp, tp) grid with the JAX package's defaults:
    tp = min(8, n) (halved until it divides n) and dp = n // tp. One axis
    name gives a flat grid of all n devices.

    ``devices`` are this process's devices, in order, repeats allowed
    (logical shards); by default ``multihost.local_devices()``.
    ``distributed`` (default: whether ``torch.distributed`` is
    initialized) joins every rank's devices into the mesh, which then
    carries the default process group. ``n_devices`` keeps the first n."""
    local = [torch.device(d) for d in devices] if devices is not None else local_devices()
    if distributed is None:
        distributed = dist.is_available() and dist.is_initialized()
    if distributed:
        flat, owners = _gather_devices(local)
        group, rank = dist.group.WORLD, dist.get_rank()
    else:
        flat, owners, group, rank = local, [0] * len(local), None, 0
    n = n_devices or len(flat)
    if not 1 <= n <= len(flat):
        raise ValueError(f"n_devices={n}: the mesh has {len(flat)} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = flat[:n]
    if len(axis_names) == 1:
        shape: Tuple[int, ...] = (n,)
    else:
        if tp is None:
            tp = min(8, n)
            while n % tp:
                tp //= 2
        if dp is None:
            dp = n // tp
        if dp * tp != n:
            raise ValueError(f"dp={dp} x tp={tp} != {n} devices")
        shape = (dp, tp)
    return Mesh(grid.reshape(shape), axis_names, np.asarray(owners[:n]).reshape(shape),
                group=group, rank=rank)
