"""The ('data', 'index') mesh on ``torch.distributed``.

Counterpart: ``radad_tpu/parallel/mesh.py`` (``DATA_AXIS``, ``INDEX_AXIS``,
``make_mesh``, ``batch_sharding``, ``index_sharding``, ``replicated``).

JAX runs one process over every device of a mesh; the port runs one
process a rank (``torchrun``, or ``torch.multiprocessing`` with the spawn
start method). The world is ``data x index`` ranks, and rank r sits at
coordinates ``(r // index, r % index)``, the order of JAX's
``np.asarray(devices).reshape(data, index)``:

* **'data'** splits batches (DB-build embed, train, eval, serving);
* **'index'** splits the rows of the reference DB. A rank holds only its
  own block of rows; queries are replicated along 'index', and each
  shard's top-k candidates merge by all-gathers over the index group.

The index group of a rank is the ranks with its data coordinate (it
carries the candidate merge); its data group is the ranks with its index
coordinate (the batch-wide exclusion ids, the gradient sum, BatchNorm's
statistics and the results). What JAX leaves replicated the port keeps
replicated by computing it identically on every rank.

Backends: NCCL for CUDA tensors (a GPU a rank, ``cuda:LOCAL_RANK``, by
default) and gloo for CPU tensors. Several ranks on one card (NCCL refuses
two ranks on one device) run gloo with CUDA tensors: gloo takes both
collectives the mesh uses (all-gather, all-reduce) on CUDA tensors, which
``chip_smoke.py`` checks on the card before its worlds of 2 and 4 ranks
run. Nothing switches backend on its own.

Every collective of the port goes through ``Mesh.all_gather``,
``Mesh.all_reduce`` or ``all_reduce_sum`` (differentiable), which count
their calls by (op, axis) in ``Mesh.calls``, as the kernel wrappers count
their launches.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
INDEX_AXIS = "index"

@dataclasses.dataclass
class Mesh:
    """A rank's view of the mesh: its coordinates, its two subgroups, its
    device and backend, and the collectives it has run."""

    data: int
    index: int
    rank: int
    device: torch.device
    backend: str
    groups: Dict[str, object]  # axis -> this rank's ProcessGroup
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, INDEX_AXIS: self.index}

    @property
    def world(self) -> int:
        return self.data * self.index

    def coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.rank // self.index if axis == DATA_AXIS \
            else self.rank % self.index

    def reset_counts(self) -> None:
        self.calls.clear()

    def _count(self, op: str, axis: str) -> None:
        key = f"{op}/{axis}"
        self.calls[key] = self.calls.get(key, 0) + 1

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` of every rank of this rank's ``axis`` group, stacked in
        coordinate order → ``[size, *x.shape]``."""
        self._count("all_gather", axis)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x, group=self.groups[axis])
        return torch.stack(parts)

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``x`` over this rank's ``axis`` group (a new
        tensor)."""
        self._count("all_reduce", axis)
        out = x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.groups[axis])
        return out

    def barrier(self) -> None:
        """Every rank of the world reaches this point."""
        self._count("barrier", "world")
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index or 0])
        else:
            dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """Sum over an axis group whose gradient is the sum over the group of
    the output's gradients: the cross-rank term of a quantity, such as
    BatchNorm's batch statistics, that every rank computes from the same
    global sum."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad, ctx.axis), None, None


def all_reduce_sum(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """``Mesh.all_reduce`` that autograd differentiates."""
    return _AllReduceSum.apply(x, mesh, axis)


def _default_device(backend: str) -> torch.device:
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   dist.get_rank() % torch.cuda.device_count()))
        return torch.device("cuda", local)
    return torch.device("cpu")


def make_mesh(data: Optional[int] = None, index: int = 1, *,
              device=None) -> Mesh:
    """This rank's ('data', 'index') mesh over the initialized process
    group; ``data`` defaults to world // index. ``device``: the rank's
    device (default ``cuda:LOCAL_RANK`` under NCCL, else the CPU).

    Every rank builds every subgroup, in the same order, as
    ``dist.new_group`` requires: a rank that built only its own groups
    would wait for the others forever."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if data is None:
        if n % index:
            raise ValueError(f"{n} devices not divisible by index={index}")
        data = n // index
    if data * index != n:
        raise ValueError(f"mesh {data}x{index} != {n} available devices")
    backend = dist.get_backend()
    rank = dist.get_rank()
    groups = {}
    for d in range(data):  # index groups: one a data coordinate
        g = dist.new_group([d * index + i for i in range(index)])
        if rank // index == d:
            groups[INDEX_AXIS] = g
    for i in range(index):  # data groups: one an index coordinate
        g = dist.new_group([d * index + i for d in range(data)])
        if rank % index == i:
            groups[DATA_AXIS] = g
    dev = torch.device(device) if device is not None \
        else _default_device(backend)
    return Mesh(data=data, index=index, rank=rank, device=dev,
                backend=backend, groups=groups)


def _block(x: torch.Tensor, parts: int, i: int, what: str) -> torch.Tensor:
    if x.shape[0] % parts:
        raise ValueError(f"{what}: dimension 0 ({x.shape[0]}) is not "
                         f"divisible by the mesh axis size {parts}")
    step = x.shape[0] // parts
    return x[i * step:(i + 1) * step]


def batch_sharding(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of ``x`` along its first axis split over 'data'
    (replicated over 'index')."""
    return _block(x, mesh.data, mesh.coord(DATA_AXIS), "batch_sharding")


def index_sharding(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of rows of ``x`` split over 'index' (replicated
    over 'data')."""
    return _block(x, mesh.index, mesh.coord(INDEX_AXIS), "index_sharding")


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` whole on every rank."""
    del mesh
    return x
