"""DTensor layouts and the collectives sharded training needs.

Parameters, optimizer moments and checkpoints of sharded training are
``torch.distributed.tensor.DTensor``s: a rank's local slice plus the
mesh and the placements (one per mesh dim, ``Shard(d)`` or
``Replicate()``).  The data moves through the plain ``torch.distributed``
collectives on the mesh's axis groups (``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce``), never through DTensor's own
redistribution: ranks that share one card run gloo, and gloo with CUDA
tensors does not carry DTensor's functional collectives in every torch
release the port meets.

A tensor dim sharded over several mesh dims (a tuple of axes, major to
minor) is cut by each mesh dim in turn, in mesh-dim order, as DTensor's
``Shard`` cuts it: the rank at coordinates ``(i, j)`` holds piece
``i · n_j + j``.

* :func:`local_chunk` / :func:`distribute` — a whole tensor that every
  rank holds, laid out without communication (each rank keeps its slice).
* :func:`gather` — the whole tensor of a DTensor (every rank).
* :func:`gather_at_use` — the same under autograd: the backward sums the
  whole-tensor gradients of every rank and hands each its slice, as a
  DTensor of the parameter's placements (a reduce-scatter along sharded
  mesh dims, an all-reduce along replicated ones).
* :func:`gather_rows` — every rank's own rows, stacked in batch order.
* :func:`all_reduce_over` — a sum over some mesh dims' groups.
* :func:`relayout` — a DTensor on other placements.
* :func:`select` — one index of a DTensor's replicated leading dim (a
  stacked layer of a checkpoint).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

__all__ = ["local_chunk", "distribute", "from_local", "gather",
           "gather_at_use", "gather_rows",
           "reduce_to_local", "all_reduce_over", "relayout", "is_dtensor",
           "sharded_mesh_dims", "replicas", "select"]


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _shards(placements) -> List[tuple]:
    """``(mesh dim, tensor dim)`` of every ``Shard`` placement, in mesh-dim
    order."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            out.append((i, pl.dim))
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl} on mesh dim {i}: sharded "
                             f"training lays tensors out as Shard or "
                             f"Replicate")
    return out


def sharded_mesh_dims(placements) -> Dict[int, List[int]]:
    """Tensor dim → the mesh dims that shard it, in mesh-dim order."""
    out: Dict[int, List[int]] = {}
    for i, d in _shards(placements):
        out.setdefault(d, []).append(i)
    return out


def replicas(mesh, placements) -> int:
    """How many ranks hold each element: the product of the sizes of the
    mesh dims the placements do not shard over."""
    sharded = {i for i, _ in _shards(placements)}
    n = 1
    for i in range(mesh.ndim):
        if i not in sharded:
            n *= mesh.size(i)
    return n


def _coordinate(mesh) -> List[int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not in the mesh")
    return list(coord)


def local_chunk(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's slice of ``full`` under ``placements`` (a view)."""
    coord = _coordinate(mesh)
    t = full
    for i, d in _shards(placements):
        n = mesh.size(i)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of a {tuple(full.shape)} tensor does "
                             f"not divide into {n} shards")
        t = t.chunk(n, dim=d)[coord[i]]
    return t


def from_local(local: torch.Tensor, mesh, placements, shape):
    """A DTensor of global ``shape`` (contiguous strides) from this rank's
    slice ``local``; no check, no communication."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, tuple(placements),
                              run_check=False, shape=shape, stride=stride)


def distribute(full: torch.Tensor, mesh, placements, device=None):
    """``full`` (the same whole tensor on every rank) as a DTensor: each
    rank keeps a contiguous copy of its slice on ``device`` (default:
    ``full``'s)."""
    local = local_chunk(full, mesh, placements)
    local = local.to(device if device is not None else full.device) \
        .clone(memory_format=torch.contiguous_format)
    return from_local(local, mesh, placements, full.shape)


def _gather_local(local: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The whole tensor from every rank's slice: all-gathers along the
    sharding mesh dims, minor mesh dim first."""
    t = local.contiguous()
    for i, d in reversed(_shards(placements)):
        n = mesh.size(i)
        buf = t.new_empty((n * t.numel(),))
        dist.all_gather_into_tensor(buf, t.reshape(-1),
                                    group=mesh.get_group(i))
        t = torch.cat(buf.view((n,) + tuple(t.shape)).unbind(0), dim=d)
    return t


def gather(dt) -> torch.Tensor:
    """The whole tensor of DTensor ``dt`` on every rank (collective: every
    rank of its mesh calls it).  A plain tensor is returned as it is."""
    if not is_dtensor(dt):
        return dt
    with torch.no_grad():
        return _gather_local(dt.to_local().detach(), dt.device_mesh,
                             dt.placements)


def gather_rows(local: torch.Tensor, mesh, placements) -> torch.Tensor:
    """Every rank's ``local`` (``(n, ...)``, one per rank) stacked along
    dim 0 in the order in which ``placements`` cut a batch's dim 0 (its
    other placements are ignored); ranks along the other mesh dims hold
    the same rows and give the same result (collective)."""
    from torch.distributed.tensor import Replicate
    rows = [pl if pl.is_shard(0) else Replicate() for pl in placements]
    return _gather_local(local, mesh, rows)


def reduce_to_local(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The sum over every rank of the mesh of ``full`` (each rank's whole
    tensor), this rank's slice of it under ``placements``: a
    reduce-scatter along each sharding mesh dim (in mesh-dim order) and an
    all-reduce along each replicated one."""
    sharded = dict(_shards(placements))
    t = full.contiguous()
    for i in range(mesh.ndim):
        group = mesh.get_group(i)
        if i in sharded:
            d, n = sharded[i], mesh.size(i)
            pieces = torch.stack(t.chunk(n, dim=d))       # (n, ...) in order
            out = t.new_empty(pieces.shape[1:])
            dist.reduce_scatter_tensor(out.view(-1), pieces.view(-1),
                                       group=group)
            t = out
        else:
            dist.all_reduce(t, group=group)
    return t


def all_reduce_over(t: torch.Tensor, mesh, mesh_dims: Sequence[int]):
    """``t`` summed in place over the groups of ``mesh_dims``."""
    for i in mesh_dims:
        dist.all_reduce(t, group=mesh.get_group(i))
    return t


class _GatherAtUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dt):
        ctx.mesh, ctx.placements, ctx.shape = (dt.device_mesh, dt.placements,
                                               tuple(dt.shape))
        return _gather_local(dt.to_local(), dt.device_mesh, dt.placements)

    @staticmethod
    def backward(ctx, grad):
        local = reduce_to_local(grad, ctx.mesh, ctx.placements)
        return from_local(local, ctx.mesh, ctx.placements, ctx.shape)


def gather_at_use(dt) -> torch.Tensor:
    """The whole tensor of parameter ``dt``, differentiable: its gradient
    reaches ``dt`` summed over every rank of the mesh and laid out as
    ``dt`` is."""
    return _GatherAtUse.apply(dt)


def relayout(dt, placements):
    """DTensor ``dt`` on ``placements`` (gathered whole, then sliced; a
    no-op when they are its own)."""
    placements = tuple(placements)
    if tuple(dt.placements) == placements:
        return dt
    mesh = dt.device_mesh
    full = gather(dt)
    local = local_chunk(full, mesh, placements) \
        .clone(memory_format=torch.contiguous_format)
    return from_local(local, mesh, placements, dt.shape)


def select(dt, r: int):
    """Index ``r`` of DTensor ``dt``'s leading dim, which must be
    replicated: a DTensor of the remaining dims whose slice on each rank
    is a view of ``dt``'s."""
    from torch.distributed.tensor import Shard
    placements = []
    for pl in dt.placements:
        if isinstance(pl, Shard):
            if pl.dim == 0:
                raise ValueError("select needs a replicated leading dim")
            pl = Shard(pl.dim - 1)
        placements.append(pl)
    return from_local(dt.to_local()[r], dt.device_mesh, placements,
                      dt.shape[1:])
