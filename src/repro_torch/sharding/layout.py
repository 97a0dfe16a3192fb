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
* :func:`gather` — the whole tensor of a DTensor (every rank);
  :func:`gather_local` the same from a rank's plain slice.
* :func:`gather_at_use` — the same under autograd: the backward sums the
  whole-tensor gradients of every rank and hands each its slice, as a
  DTensor of the parameter's placements (a reduce-scatter along sharded
  mesh dims, an all-reduce along replicated ones).  Restricted to some
  mesh dims (``mesh_dims=``, tensor-parallel training's batch dims), it
  gathers over those alone, keeps the slice the others cut, and its
  backward sums over those dims only; :func:`gather_local_at_use` is the
  same on a rank's plain slice.
* :func:`gather_rows` — every rank's own rows, stacked in batch order.
* :func:`all_reduce_over` — a sum over some mesh dims' groups.
* :func:`relayout` — a DTensor on other placements.
* :func:`select` — one index of a DTensor's replicated leading dim (a
  stacked layer of a checkpoint).

The region operators of tensor-parallel compute, each an autograd
function over one mesh dim's group, on plain local tensors (activations
are never DTensors):

* :func:`copy_in`    — identity forward, ``all_reduce`` backward: where a
  replicated activation enters compute split over the group;
* :func:`reduce_out` — ``all_reduce`` forward, identity backward: the sum
  of the ranks' partial results, which replicated compute then reads;
* :func:`gather_dim` — ``all_gather`` along a tensor dim forward; the
  backward takes this rank's slice (replicated compute reads the whole)
  or, with ``grad="sum"``, reduce-scatters (split compute reads it);
* :func:`split_dim`  — this rank's slice forward, ``all_gather`` backward;
* :func:`reduce_scatter_dim` — the sum over the group, this rank's slice
  along a tensor dim forward (``reduce_scatter``), ``all_gather``
  backward: each rank's partial sums of a whole, which split compute
  then reads in slices;
* :func:`all_reduce_max` — an elementwise maximum over the group (no
  gradient).

Every collective of these functions is recorded, one :class:`Collective`
per call, into each :func:`collective_log` open around it (a no-op when
none is): the dry run's cost model (``launch/hlo_cost.py``) and the card's
byte counts read the same records.  :func:`record_collective` records a
collective made elsewhere (the row-sharded SpMV's exchange).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["Collective", "collective_log", "record_collective",
           "local_chunk", "distribute", "from_local", "gather",
           "gather_local",
           "gather_at_use", "gather_local_at_use", "gather_rows",
           "reduce_to_local", "all_reduce_over", "relayout", "is_dtensor",
           "sharded_mesh_dims", "replicas", "select", "copy_in",
           "reduce_out", "gather_dim", "split_dim", "reduce_scatter_dim",
           "all_reduce_max"]


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective call: ``kind`` (the reference's HLO name:
    ``all-gather``, ``reduce-scatter``, ``all-reduce``, ``all-to-all``),
    ``axis`` (the mesh dim's name), ``size`` (its group's rank count) and
    ``bytes``: the whole tensor it moves on this rank — an all-gather's
    result, a reduce-scatter's operand, an all-reduce's tensor, an
    all-to-all's received buffer."""
    kind: str
    axis: str
    size: int
    bytes: int


_LOGS: List[List[Collective]] = []


@contextlib.contextmanager
def collective_log() -> Iterator[List[Collective]]:
    """Every collective called inside the block, in call order, appended
    to the yielded list (each of several nested logs gets every call)."""
    log: List[Collective] = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        del _LOGS[next(i for i, x in enumerate(_LOGS) if x is log)]


def record_collective(kind: str, axis: str, size: int, nbytes: int):
    """Record one collective into the open logs (none open: nothing)."""
    if _LOGS:
        entry = Collective(kind, axis, int(size), int(nbytes))
        for log in _LOGS:
            log.append(entry)


def _axis_name(mesh, i: int) -> str:
    names = mesh.mesh_dim_names
    return names[i] if names else str(i)


def _all_gather(buf: torch.Tensor, t: torch.Tensor, mesh, i: int):
    """``t`` of every rank of mesh dim ``i``'s group into ``buf``."""
    record_collective("all-gather", _axis_name(mesh, i), mesh.size(i),
                      buf.numel() * buf.element_size())
    dist.all_gather_into_tensor(buf, t, group=mesh.get_group(i))


def _reduce_scatter(out: torch.Tensor, pieces: torch.Tensor, mesh, i: int):
    """The sum over mesh dim ``i``'s group of ``pieces``, this rank's
    piece into ``out``."""
    record_collective("reduce-scatter", _axis_name(mesh, i), mesh.size(i),
                      pieces.numel() * pieces.element_size())
    dist.reduce_scatter_tensor(out, pieces, group=mesh.get_group(i))


def _all_reduce_(t: torch.Tensor, mesh, i: int, op=None):
    """``t`` reduced in place over mesh dim ``i``'s group (a sum, or
    ``op``)."""
    record_collective("all-reduce", _axis_name(mesh, i), mesh.size(i),
                      t.numel() * t.element_size())
    if op is None:
        dist.all_reduce(t, group=mesh.get_group(i))
    else:
        dist.all_reduce(t, op=op, group=mesh.get_group(i))


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


def _gather_local(local: torch.Tensor, mesh, placements,
                  mesh_dims: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The whole tensor from every rank's slice: all-gathers along the
    sharding mesh dims (those of ``mesh_dims`` alone when given), minor
    mesh dim first."""
    t = local.contiguous()
    for i, d in reversed(_shards(placements)):
        n = mesh.size(i)
        if n == 1 or (mesh_dims is not None and i not in mesh_dims):
            continue
        buf = t.new_empty((n * t.numel(),))
        _all_gather(buf, t.reshape(-1), mesh, i)
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


def gather_local(local: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The whole tensor from every rank's plain slice ``local`` under
    ``placements`` (collective: every rank of the mesh calls it)."""
    with torch.no_grad():
        return _gather_local(local.detach(), mesh, placements)


def gather_rows(local: torch.Tensor, mesh, placements) -> torch.Tensor:
    """Every rank's ``local`` (``(n, ...)``, one per rank) stacked along
    dim 0 in the order in which ``placements`` cut a batch's dim 0 (its
    other placements are ignored); ranks along the other mesh dims hold
    the same rows and give the same result (collective)."""
    from torch.distributed.tensor import Replicate
    rows = [pl if pl.is_shard(0) else Replicate() for pl in placements]
    return _gather_local(local, mesh, rows)


def reduce_to_local(full: torch.Tensor, mesh, placements,
                    mesh_dims: Optional[Sequence[int]] = None
                    ) -> torch.Tensor:
    """The sum over every rank of the mesh (of ``mesh_dims`` alone when
    given) of ``full`` (each rank's tensor, whole along those dims), this
    rank's slice of it under ``placements``: a reduce-scatter along each
    sharding mesh dim (in mesh-dim order) and an all-reduce along each
    replicated one."""
    sharded = dict(_shards(placements))
    t = full.contiguous()
    for i in range(mesh.ndim):
        if mesh.size(i) == 1 or (mesh_dims is not None
                                 and i not in mesh_dims):
            continue                  # a rank's sum over itself
        if i in sharded:
            d, n = sharded[i], mesh.size(i)
            pieces = torch.stack(t.chunk(n, dim=d))       # (n, ...) in order
            out = t.new_empty(pieces.shape[1:])
            _reduce_scatter(out.view(-1), pieces.view(-1), mesh, i)
            t = out
        else:
            _all_reduce_(t, mesh, i)
    return t


def all_reduce_over(t: torch.Tensor, mesh, mesh_dims: Sequence[int]):
    """``t`` summed in place over the groups of ``mesh_dims``."""
    for i in mesh_dims:
        _all_reduce_(t, mesh, i)
    return t


class _GatherAtUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, placements, shape, mesh_dims):
        ctx.meta = (mesh, placements, shape, mesh_dims, is_dtensor(t))
        local = t.to_local() if is_dtensor(t) else t
        return _gather_local(local, mesh, placements, mesh_dims)

    @staticmethod
    def backward(ctx, grad):
        mesh, placements, shape, mesh_dims, wrap = ctx.meta
        local = reduce_to_local(grad, mesh, placements, mesh_dims)
        if wrap:
            local = from_local(local, mesh, placements, shape)
        return local, None, None, None, None


def gather_at_use(dt, mesh_dims: Optional[Sequence[int]] = None
                  ) -> torch.Tensor:
    """The whole tensor of parameter ``dt``, differentiable: its gradient
    reaches ``dt`` summed over every rank of the mesh and laid out as
    ``dt`` is.  With ``mesh_dims`` it is gathered over those mesh dims
    only: the result keeps the slice that the other dims cut (a
    tensor-parallel rank's ``model`` slice), and the backward sums over
    ``mesh_dims`` alone (collective over their groups)."""
    return _GatherAtUse.apply(dt, dt.device_mesh, tuple(dt.placements),
                              tuple(dt.shape), mesh_dims)


def gather_local_at_use(local: torch.Tensor, mesh, placements,
                        mesh_dims: Optional[Sequence[int]] = None
                        ) -> torch.Tensor:
    """:func:`gather_at_use` of a parameter given by this rank's plain
    slice ``local`` and its ``placements``: the gradient reaches ``local``
    as a plain tensor."""
    return _GatherAtUse.apply(local, mesh, tuple(placements), None,
                              mesh_dims)


# ----------------------------------------------------- region operators


def _rank(mesh, mesh_dim: int) -> int:
    return _coordinate(mesh)[mesh_dim]


def _all_reduce(t: torch.Tensor, mesh, i: int) -> torch.Tensor:
    out = t.contiguous().clone()
    _all_reduce_(out, mesh, i)
    return out


def _all_gather_dim(t: torch.Tensor, d: int, mesh, i: int) -> torch.Tensor:
    n = mesh.size(i)
    t = t.contiguous()
    buf = t.new_empty((n * t.numel(),))
    _all_gather(buf, t.reshape(-1), mesh, i)
    return torch.cat(buf.view((n,) + tuple(t.shape)).unbind(0), dim=d)


def _reduce_scatter_dim(t: torch.Tensor, d: int, mesh, i: int
                        ) -> torch.Tensor:
    pieces = torch.stack(t.chunk(mesh.size(i), dim=d))
    out = t.new_empty(pieces.shape[1:])
    _reduce_scatter(out.view(-1), pieces.view(-1), mesh, i)
    return out


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, mesh_dim):
        ctx.meta = (mesh, mesh_dim)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, *ctx.meta), None, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, mesh_dim):
        return _all_reduce(x, mesh, mesh_dim)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, d, mesh, mesh_dim, rank, summed):
        ctx.meta = (d, mesh, mesh_dim, rank, summed)
        return _all_gather_dim(x, d, mesh, mesh_dim)

    @staticmethod
    def backward(ctx, grad):
        d, mesh, mesh_dim, rank, summed = ctx.meta
        if summed:
            out = _reduce_scatter_dim(grad, d, mesh, mesh_dim)
        else:
            out = grad.chunk(mesh.size(mesh_dim), dim=d)[rank].contiguous()
        return out, None, None, None, None, None


class _SplitDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, d, mesh, mesh_dim, rank):
        ctx.meta = (d, mesh, mesh_dim)
        return x.chunk(mesh.size(mesh_dim), dim=d)[rank].contiguous()

    @staticmethod
    def backward(ctx, grad):
        d, mesh, mesh_dim = ctx.meta
        return _all_gather_dim(grad, d, mesh, mesh_dim), None, None, None, \
            None


class _ReduceScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, d, mesh, mesh_dim):
        ctx.meta = (d, mesh, mesh_dim)
        return _reduce_scatter_dim(x, d, mesh, mesh_dim)

    @staticmethod
    def backward(ctx, grad):
        d, mesh, mesh_dim = ctx.meta
        return _all_gather_dim(grad, d, mesh, mesh_dim), None, None, None


def copy_in(x: torch.Tensor, mesh, mesh_dim: int) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``mesh_dim``'s group (the
    ranks each hold part of it)."""
    return _CopyIn.apply(x, mesh, mesh_dim)


def reduce_out(x: torch.Tensor, mesh, mesh_dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``mesh_dim``'s group; its gradient passed to
    every rank as it is."""
    return _ReduceOut.apply(x, mesh, mesh_dim)


def gather_dim(x: torch.Tensor, d: int, mesh, mesh_dim: int,
               grad: str = "slice") -> torch.Tensor:
    """The ranks' ``x`` concatenated along tensor dim ``d`` in the order of
    ``mesh_dim``'s coordinate.  Backward: this rank's slice of the
    gradient (``grad="slice"``: every rank's gradient of the whole is
    the whole's), or the slice of the gradients summed over the group
    (``grad="sum"``: each rank's is a part)."""
    if grad not in ("slice", "sum"):
        raise ValueError(f"gather_dim grad {grad!r}: 'slice' or 'sum'")
    return _GatherDim.apply(x, d % x.dim(), mesh, mesh_dim,
                            _rank(mesh, mesh_dim), grad == "sum")


def split_dim(x: torch.Tensor, d: int, mesh, mesh_dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` along tensor dim ``d`` (``x`` the same on
    every rank of ``mesh_dim``'s group); the backward all-gathers."""
    n = mesh.size(mesh_dim)
    if x.shape[d] % n:
        raise ValueError(f"dim {d} of a {tuple(x.shape)} tensor does not "
                         f"split into {n}")
    return _SplitDim.apply(x, d % x.dim(), mesh, mesh_dim,
                           _rank(mesh, mesh_dim))


def reduce_scatter_dim(x: torch.Tensor, d: int, mesh, mesh_dim: int
                       ) -> torch.Tensor:
    """This rank's slice along tensor dim ``d`` of the sum of ``x`` over
    ``mesh_dim``'s group (each rank's ``x`` a partial sum of the whole);
    the backward all-gathers the slices' gradients."""
    n = mesh.size(mesh_dim)
    if x.shape[d] % n:
        raise ValueError(f"dim {d} of a {tuple(x.shape)} tensor does not "
                         f"split into {n}")
    return _ReduceScatterDim.apply(x, d % x.dim(), mesh, mesh_dim)


def all_reduce_max(t: torch.Tensor, mesh, mesh_dim: int) -> torch.Tensor:
    """The elementwise maximum of ``t`` over ``mesh_dim``'s group, without
    gradient."""
    out = t.detach().contiguous().clone()
    _all_reduce_(out, mesh, mesh_dim, op=dist.ReduceOp.MAX)
    return out


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
