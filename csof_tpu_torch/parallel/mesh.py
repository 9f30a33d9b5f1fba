"""The ``(data, model)`` mesh over a ``torch.distributed`` process group
(port of ``csof_tpu/parallel/mesh.py``).

The JAX package lays the global batch out over the ``data`` axis of a device
mesh and lets XLA insert the gradient reduction. Here every rank is one
process on one device: the global host batch is split by rank
(``shard_batch``), ``DistributedDataParallel`` averages the gradients over
the ranks, and the Dice statistics that JAX sums over the sharded batch are
gathered by ``global_batch_dice_stats``, whose backward makes DDP's average
the global batch's gradient (the reference's ``awesome_allgather_function``).

A rank's data index is ``rank // (world // n_data)``: the ranks of one data
index hold the same rows, as the devices of one ``data`` index of the JAX
mesh do (its ``model`` axis), so the mesh's model size is ``world //
n_data``. ``n_data`` must divide the world size. ``batch_sharding`` and
``replicated`` (XLA shardings) have no counterpart: parameters are
replicated by DDP and the batch is split on the host.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A grid of ``world`` ranks, ``n_data`` data indices of ``world //
    n_data`` ranks each. ``group`` (None without a process group) is the
    process group of the trainer's own collectives (the Dice statistics,
    the loss), apart from the default group that DDP reduces the gradients
    over."""

    n_data: int
    world: int = 1
    rank: int = 0
    group: Any = None
    devices: tuple[str, ...] = ("cpu",)

    def __post_init__(self):
        if self.n_data < 1 or self.world % self.n_data:
            raise ValueError(f"{self.n_data} data indices do not split {self.world} ranks evenly")

    @property
    def replicas(self) -> int:
        return self.world // self.n_data

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.n_data, "model": self.replicas}

    @property
    def data_index(self) -> int:
        return self.rank // self.replicas

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if n % self.n_data:
            raise ValueError(f"a batch of {n} does not split over {self.n_data} data indices")
        per = n // self.n_data
        return slice(self.data_index * per, (self.data_index + 1) * per)


def make_mesh(n_data: int = -1, n_model: int = 1, device: torch.device | str = "cpu") -> Mesh:
    """The mesh of the initialized process group (world 1 and no group
    without one). ``n_data == -1`` takes ``world // n_model``. ``device`` is
    this rank's; the mesh lists every rank's. Collective: every rank calls
    it."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data == -1:
        if world % n_model:
            raise ValueError(f"{world} ranks do not divide by model={n_model}")
        n_data = world // n_model
    if n_data * n_model > world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs more than {world} ranks")
    if not dist.is_initialized():
        return Mesh(n_data, devices=(str(device),))
    group = dist.new_group(list(range(world)))
    devices = [None] * world
    dist.all_gather_object(devices, str(device), group=group)
    return Mesh(n_data, world, rank, group, tuple(devices))


def fit_batch(mesh: Mesh, n: int) -> Mesh:
    """``mesh`` with its data size cut to the largest that divides both a
    global batch of ``n`` and the world (the JAX trainer clamps its data axis
    to a divisor of the batch in the same way)."""
    if n % mesh.n_data == 0:
        return mesh
    d = next(d for d in range(min(n, mesh.n_data), 0, -1) if n % d == 0 and mesh.world % d == 0)
    return dataclasses.replace(mesh, n_data=d)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of every array of a global host batch (leading axis)."""
    if mesh.n_data == 1:
        return batch
    return {k: None if v is None else np.asarray(v)[mesh.rows(len(v))] for k, v in batch.items()}


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(world, *x.shape): every rank's ``x``, in rank order. gloo gathers
    host tensors only, so a CUDA tensor goes through the host there."""
    world = dist.get_world_size(group)
    via_host = x.is_cuda and dist.get_backend(group) == "gloo"
    src = x.detach().cpu() if via_host else x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(x.device)


class _GatherRanks(torch.autograd.Function):
    """forward: the all-gather; backward: the all-reduced (summed) gradient
    of the whole gathered tensor, this rank's slice of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad[ctx.rank], None


def global_batch_dice_stats(tp: torch.Tensor, fp: torch.Tensor, fn: torch.Tensor,
                            mesh: Mesh | None = None):
    """Per-sample statistics (B, C) summed over the global batch: over this
    rank's rows, and over one rank of every data index. Differentiable:
    under DDP's average over the ranks the gradient is the global batch's.
    Without a mesh or its process group, the plain sum (at world 1 the
    gather of one rank computes the same sum)."""
    if mesh is None or mesh.group is None:
        return tp.sum(0), fp.sum(0), fn.sum(0)
    gathered = _GatherRanks.apply(torch.stack([tp, fp, fn]), mesh.group)
    first = gathered[::mesh.replicas]  # one rank of each data index
    tp, fp, fn = first.sum((0, 2)).unbind(0)
    return tp, fp, fn


def all_mean(value: float, mesh: Mesh | None) -> float:
    """A host value averaged over the ranks (each data index holds the same
    number of ranks, so this is the mean over the data indices)."""
    if mesh is None or mesh.group is None:
        return value
    nccl = dist.get_backend(mesh.group) == "nccl"  # NCCL reduces on the card
    t = torch.tensor([value], dtype=torch.float64,
                     device=torch.device("cuda", torch.cuda.current_device()) if nccl else None)
    dist.all_reduce(t, group=mesh.group)
    return float(t[0]) / mesh.world
