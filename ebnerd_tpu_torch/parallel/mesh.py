"""The (data, model) mesh over a process group, the batch split, the
row-sharded tables and the collectives of training over processes
(counterpart of ``ebnerd_tpu/parallel/mesh.py``).

JAX lays one global array over a mesh of devices and lets XLA insert the
collectives. PyTorch runs one process per device. Process ``rank`` sits at
``(data_index, model_index) = (rank // model, rank % model)``, where JAX's
``devs.reshape(data, model)`` puts device ``rank``. Every process passes
the same global batch and keeps the contiguous row block of its
``data_index`` (``host_shard_rows``, the JAX split): the batch is split
over ``data`` and replicated over ``model``. The trainer sums the
gradients over the **data group** (the processes of this ``model_index``)
with one all-reduce a step.

The ``model`` axis row-shards tables (``table_sharding``: JAX's even
split, which refuses a row count that ``model`` does not divide). A
process holds only its block of such a table; the processes of a **model
group** (this ``data_index``) hold the blocks of one table and read the
same row ids, so ``gather_rows`` takes the ids' unique values, each
process writes the rows it owns (zeros for the rest) and one all-reduce
over the model group sums them: exact, every row has one nonzero term.
Its backward adds each owned row's cotangent into the owner's block
gradient and exchanges nothing, since the computation after the gather,
and so its cotangent, is the same on every member of the group.
``ShardedTable`` wraps a value table's block so that the batch builders
index it as a tensor; ``models.layers.WordEmbed.shard_`` shards the word
table through the same gather.

Without an initialised process group a mesh has one process, and every
collective is the identity.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as tdist

from .. import resolve_device

__all__ = [
    "Mesh",
    "make_mesh",
    "mesh_shape",
    "Sharding",
    "data_sharding",
    "replicated",
    "table_sharding",
    "ShardedTable",
    "gather_rows",
    "all_gather_rows",
    "shard_batch",
    "put_replicated",
    "host_shard_rows",
    "all_reduce_sum_",
    "all_reduce_sum",
    "average_cotangent",
    "broadcast_",
    "barrier",
]


@dataclass(frozen=True)
class Mesh:
    """``data`` x ``model`` processes (one device each) of the default
    process group; ``rank`` is this process's place in it. ``data_group``
    and ``model_group`` are this process's subgroups along each axis
    (``make_mesh`` creates them when both axes exceed 1; an axis of the
    whole world uses the default group, one of size 1 no group)."""
    data: int
    model: int = 1
    rank: int = 0
    data_group: Any = field(default=None, compare=False, repr=False)
    model_group: Any = field(default=None, compare=False, repr=False)

    axis_names = ("data", "model")

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def active(self) -> bool:
        """True when the collectives run (a process group exists)."""
        return tdist.is_initialized()

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def group(self, axis: str):
        """The process group along ``axis`` ("data" or "model") that holds
        this process (None: the default group)."""
        if self.data > 1 and self.model > 1:
            group = self.data_group if axis == "data" else self.model_group
            if group is None and self.active:
                raise ValueError("a (data, model) mesh with both axes > 1 needs its subgroups: "
                                 "build it with make_mesh")
            return group
        return None

    def size(self, axis: str) -> int:
        return self.data if axis == "data" else self.model

    def first(self, axis: str) -> int:
        """The global rank of index 0 along ``axis`` in this process's group."""
        return self.model_index if axis == "data" else self.data_index * self.model


def mesh_shape(n: int, data: Optional[int] = None, model: int = 1) -> tuple:
    """(data, model) of a mesh over ``n`` processes, as JAX's ``make_mesh``
    shapes one over ``n`` devices: with no ``data`` every process not on
    the model axis goes to the data axis; raises when the two do not
    multiply to ``n``."""
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"data*model = {data}*{model} != {n} processes")
    return data, model


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """Mesh over the processes of the default group (this process alone when
    no group is initialised). With no arguments every process goes to the
    data axis. With both axes > 1 every process creates every subgroup, in
    the same order (a process that skipped one would hang the others)."""
    on = tdist.is_initialized()
    data, model = mesh_shape(tdist.get_world_size() if on else 1, data, model)
    groups = {}
    if on and data > 1 and model > 1:
        groups["data_group"], _ = tdist.new_subgroups_by_enumeration(
            [[d * model + m for d in range(data)] for m in range(model)])
        groups["model_group"], _ = tdist.new_subgroups_by_enumeration(
            [[d * model + m for m in range(model)] for d in range(data)])
    return Mesh(data=data, model=model, rank=tdist.get_rank() if on else 0, **groups)


class Sharding(NamedTuple):
    """How an array lies over a mesh: split along its leading axis over
    ``data`` (``axis="data"``: JAX's host split, ceil(n / data) rows each),
    over ``model`` (``axis="model"``: JAX's even split of ``P("model")``), or
    whole on every process (``axis=None``)."""
    mesh: Mesh
    axis: Optional[str]

    def shard_shape(self, shape: tuple) -> tuple:
        """The shape of this process's block of an array of ``shape``;
        raises, with JAX's message, when ``model`` does not divide its rows."""
        if self.axis != "model":
            return tuple(shape)
        k, n = self.mesh.model, shape[0]
        if n % k:
            factors = [k] + [1] * (len(shape) - 1)
            raise ValueError(
                f"Sharding {self} implies that array axis 0 is partitioned {k} times, but the "
                f"dimension size is {n} (full shape: {tuple(shape)}, per-dimension tiling "
                f"factors: {factors} should evenly divide the shape)")
        return (n // k,) + tuple(shape[1:])

    def rows(self, n_rows: int) -> slice:
        """The rows of an n-row array this process holds."""
        if self.axis is None:
            return slice(0, n_rows)
        if self.axis == "data":
            return host_shard_rows(n_rows, self.mesh.data_index, self.mesh.data)
        per = self.shard_shape((n_rows,))[0]
        return slice(self.mesh.model_index * per, (self.mesh.model_index + 1) * per)


def data_sharding(mesh: Mesh) -> Sharding:
    """Batch arrays: leading axis split over 'data', replicated over 'model'."""
    return Sharding(mesh, "data")


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def table_sharding(mesh: Mesh) -> Sharding:
    """Value tables ([V+1, ...]) and the word table row-sharded over 'model'."""
    return Sharding(mesh, "model")


def _owned_rows(block: torch.Tensor, ids: torch.Tensor, start: int, group,
                wire: torch.dtype) -> torch.Tensor:
    """Rows ``ids`` (unique, global) of the table whose rows
    [start, start + len(block)) are ``block``, in ``wire``: this process's
    owned rows, zeros for the rest, summed over ``group``."""
    local = ids - start
    owned = (local >= 0) & (local < block.shape[0])
    rows = block[torch.where(owned, local, 0)].to(wire)
    rows.masked_fill_(~owned.view((-1,) + (1,) * (rows.dim() - 1)), 0)
    tdist.all_reduce(rows, group=group)
    return rows


class _GatherRows(torch.autograd.Function):
    """rows = table[ids] (``_owned_rows``, returned in the block's dtype);
    the block's gradient: each owned row's cotangent, written where the row
    lies (the ids are unique, so nothing is summed)."""

    @staticmethod
    def forward(ctx, block, ids, start, group, wire):
        ctx.save_for_backward(ids)
        ctx.start, ctx.n = start, block.shape[0]
        return _owned_rows(block, ids, start, group, wire).to(block.dtype)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        local = ids - ctx.start
        owned = ((local >= 0) & (local < ctx.n)).view((-1,) + (1,) * (g.dim() - 1))
        grad = g.new_zeros((ctx.n,) + g.shape[1:])
        # rows this process does not own add exact zeros to its row 0
        grad.index_put_((torch.where(owned.view(-1), local, 0),),
                        torch.where(owned, g, 0), accumulate=True)
        return grad, None, None, None, None


def gather_rows(block: torch.Tensor, ids: torch.Tensor, sharding: Sharding, n_rows: int,
                wire: Optional[torch.dtype] = None) -> tuple:
    """(positions, rows): the unique values of ``ids`` gathered from the
    ``n_rows``-row table whose block over ``sharding``'s model axis is
    ``block``, and each id's position among them (``ids``' shape), so that
    ``rows[positions]`` is ``table[ids]``. Differentiable in ``block``.
    ``wire`` is the all-reduce's dtype (default the block's): a caller that
    casts the rows to a narrower dtype afterwards may name it, the sum being
    exact in any dtype; the rows come back in the block's dtype."""
    uniq, positions = torch.unique(ids, return_inverse=True)
    start = sharding.rows(n_rows).start
    group = sharding.mesh.group("model")
    rows = _GatherRows.apply(block, uniq, start, group, wire or block.dtype)
    return positions, rows


class ShardedTable:
    """A value table ([V+1, ...] ids or floats) row-sharded over the mesh's
    model axis: ``block`` is this process's rows. ``table[idx]`` (a tensor of
    row ids) gathers the rows as ``gather_rows`` does, so the batch builders
    of ``models/inputs.py`` index it as a tensor; ``shape`` and ``device``
    are the global table's (``serving.encode_corpus`` reads them). Every process of the model group must
    index it with the same ids at the same time."""

    def __init__(self, block: torch.Tensor, shape: tuple, sharding: Sharding):
        self.block, self.sharding = block, sharding
        self.shape = torch.Size(shape)
        if tuple(block.shape) != sharding.shard_shape(self.shape):
            raise ValueError(f"block {tuple(block.shape)} is not the {sharding.axis} shard of "
                             f"{tuple(self.shape)}")

    @property
    def device(self) -> torch.device:
        return self.block.device

    def __getitem__(self, idx: torch.Tensor) -> torch.Tensor:
        positions, rows = gather_rows(self.block, idx, self.sharding, self.shape[0])
        return rows[positions]


def all_gather_rows(block: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole table from this model group's blocks (``table_sharding``'s
    equal blocks, in model order), on every process of the group."""
    parts = [torch.empty_like(block) for _ in range(mesh.model)]
    tdist.all_gather(parts, block.contiguous(), group=mesh.group("model"))
    return torch.cat(parts)


def shard_batch(batch: dict, mesh: Optional[Mesh]) -> dict:
    """This process's rows of a global host batch: every array with a
    leading axis keeps the rows ``host_shard_rows`` gives this process's
    ``data_index``; scalars stay as they are. Every process passes the same
    global batch; the trainer copies the rows to its device."""
    if mesh is None:
        return batch
    rows = data_sharding(mesh).rows
    return {k: v[rows(v.shape[0])] if getattr(v, "ndim", 0) >= 1 else v
            for k, v in batch.items()}


def put_replicated(x, mesh: Mesh, device="cuda") -> torch.Tensor:
    """The whole of a host array on this process's ``device`` (every
    process passes the same value); the card unless the caller passes
    ``device="cpu"``, as JAX places it on the mesh's accelerators."""
    dev = resolve_device(device)
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(dev)


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


def _runs(mesh: Mesh, axis: str) -> bool:
    return mesh.active and mesh.size(axis) > 1


def all_reduce_sum_(tensors: list, mesh: Mesh, axis: str = "data") -> None:
    """Sum each tensor over the processes of this process's ``axis`` group,
    in place, in one all-reduce of their concatenation (one dtype and
    device)."""
    if not _runs(mesh, axis) or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    tdist.all_reduce(flat, group=mesh.group(axis))
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """The sum of ``t`` over the ``axis`` group, differentiable: its backward
    sums the cotangents over the group (the moments of ``WeightedBatchNorm``
    over every process's rows)."""
    if not _runs(mesh, axis):
        return t
    return _AllReduceSum.apply(t, mesh.group(axis))


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the group; dx = the sum of dy over it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        tdist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone()
        tdist.all_reduce(dx, group=ctx.group)
        return dx, None


def average_cotangent(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """``x`` itself, whose cotangent is averaged over the ``axis`` group in
    the backward. Every process computes ``x`` from the same replicated
    inputs and reads its own rows of it; so every process's backward
    upstream of ``x`` sees the whole batch's cotangent / processes, and the
    gradient all-reduce sums those copies to the whole batch's gradient
    (exactly, for a power-of-two count: the backward is linear in the
    cotangent)."""
    if not _runs(mesh, axis):
        return x
    return _AverageCotangent.apply(x, mesh.size(axis), mesh.group(axis))


class _AverageCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, count, group):
        ctx.count, ctx.group = count, group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dx = dy.contiguous().clone()
        tdist.all_reduce(dx, group=ctx.group)
        return dx.div_(ctx.count), None, None


def broadcast_(tensors: list, mesh: Mesh, axis: str = "data") -> None:
    """Every process's tensors set to those of index 0 of its ``axis``
    group, in place."""
    if not _runs(mesh, axis):
        return
    src, group = mesh.first(axis), mesh.group(axis)
    for t in tensors:
        tdist.broadcast(t, src=src, group=group)


def barrier(mesh: Mesh) -> None:
    """Every process of the mesh waits for the others."""
    if mesh.active:
        tdist.barrier()
