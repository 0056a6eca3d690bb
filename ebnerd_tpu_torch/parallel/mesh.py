"""The (data, model) mesh over a process group, the batch split and the
collectives of data-parallel training (counterpart of
``ebnerd_tpu/parallel/mesh.py``).

JAX lays one global array over a mesh of devices and lets XLA insert the
collectives. PyTorch runs one process per device: every process holds the
whole model, passes the same global batch and keeps its contiguous row
block of it (``host_shard_rows``, the JAX split), and the trainer sums the
gradients over the ``data`` axis with one all-reduce a step. The
``model`` axis (row-sharded tables, ``table_sharding``) is ROADMAP A11b and
raises here.

Without an initialised process group a mesh has one process, and every
collective is the identity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as tdist

__all__ = [
    "Mesh",
    "make_mesh",
    "data_sharding",
    "replicated",
    "table_sharding",
    "shard_batch",
    "put_replicated",
    "host_shard_rows",
    "all_reduce_sum_",
    "all_reduce_sum",
    "average_cotangent",
    "broadcast_",
    "barrier",
]

_MODEL_AXIS = ("the mesh's model axis (row-sharded tables and parameters) is not ported: "
               "ROADMAP A11b")


@dataclass(frozen=True)
class Mesh:
    """``data`` processes (one device each) along the data axis of the
    default process group; ``rank`` is this process's place on it."""
    data: int
    model: int = 1
    rank: int = 0

    axis_names = ("data", "model")

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def active(self) -> bool:
        """True when the collectives run (a process group exists)."""
        return tdist.is_initialized()


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """Mesh over the processes of the default group (this process alone when
    no group is initialised). With no arguments every process goes to the
    data axis."""
    if model != 1:
        raise NotImplementedError(f"make_mesh(model={model}): {_MODEL_AXIS}")
    on = tdist.is_initialized()
    n = tdist.get_world_size() if on else 1
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"data*model = {data}*{model} != {n} processes")
    return Mesh(data=data, model=model, rank=tdist.get_rank() if on else 0)


class Sharding(NamedTuple):
    """How an array lies over a mesh: split along its leading axis over
    ``data`` (``axis="data"``) or whole on every process (``axis=None``)."""
    mesh: Mesh
    axis: Optional[str]

    def rows(self, n_rows: int) -> slice:
        """The rows of an n-row array this process holds."""
        if self.axis is None:
            return slice(0, n_rows)
        return host_shard_rows(n_rows, self.mesh.rank, self.mesh.data)


def data_sharding(mesh: Mesh) -> Sharding:
    """Batch arrays: leading axis split over 'data'."""
    return Sharding(mesh, "data")


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def table_sharding(mesh: Mesh):
    raise NotImplementedError(f"table_sharding: {_MODEL_AXIS}")


def shard_batch(batch: dict, mesh: Optional[Mesh]) -> dict:
    """This process's rows of a global host batch: every array with a
    leading axis keeps the rows ``host_shard_rows`` gives this process;
    scalars stay as they are. Every process passes the same global batch;
    the trainer copies the rows to its device."""
    if mesh is None:
        return batch
    rows = data_sharding(mesh).rows
    return {k: v[rows(v.shape[0])] if getattr(v, "ndim", 0) >= 1 else v
            for k, v in batch.items()}


def put_replicated(x, mesh: Mesh, device="cpu") -> torch.Tensor:
    """The whole of a host array on this process's ``device`` (every
    process passes the same value)."""
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(device)


def host_shard_rows(n_rows: int, process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> slice:
    """Contiguous row range owned by this process (each process feeds only
    its slice of the global batch); ceil(n / count) rows each, the last
    process the rest."""
    on = tdist.is_initialized()
    pi = process_index if process_index is not None else (tdist.get_rank() if on else 0)
    pc = process_count if process_count is not None else (tdist.get_world_size() if on else 1)
    per = -(-n_rows // pc)
    return slice(pi * per, min((pi + 1) * per, n_rows))


def all_reduce_sum_(tensors: list, mesh: Mesh) -> None:
    """Sum each tensor over the processes, in place, in one all-reduce of
    their concatenation (one dtype and device)."""
    if not mesh.active or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    tdist.all_reduce(flat)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the processes, differentiable: its backward
    sums the cotangents over the processes (the moments of
    ``WeightedBatchNorm`` over every process's rows)."""
    if not mesh.active:
        return t
    return _AllReduceSum.apply(t)


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the processes; dx = the sum of dy over them."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        tdist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone()
        tdist.all_reduce(dx)
        return dx


def average_cotangent(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` itself, whose cotangent is averaged over the processes in the
    backward. Every process computes ``x`` from the same replicated inputs
    and reads its own rows of it; so every process's backward upstream of
    ``x`` sees the whole batch's cotangent / processes, and the gradient
    all-reduce sums those copies to the whole batch's gradient (exactly,
    for a power-of-two count: the backward is linear in the cotangent)."""
    if not mesh.active or mesh.data == 1:
        return x
    return _AverageCotangent.apply(x, mesh.data)


class _AverageCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, count):
        ctx.count = count
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dx = dy.contiguous().clone()
        tdist.all_reduce(dx)
        return dx.div_(ctx.count), None


def broadcast_(tensors: list, mesh: Mesh, src: int = 0) -> None:
    """Every process's tensors set to process ``src``'s, in place."""
    if not mesh.active:
        return
    for t in tensors:
        tdist.broadcast(t, src=src)


def barrier(mesh: Mesh) -> None:
    if mesh.active:
        tdist.barrier()
