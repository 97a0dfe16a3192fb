"""Logical-axis partitioner: rules → specs and ``NamedSharding`` trees.

The PyTorch counterpart of ``repro.sharding.partitioner``.  Every
parameter dim carries a logical axis name (set in the layer specs); a
rules table maps names to mesh axes per *shape kind*:

* ``train``   — FSDP + TP: ``embed → data``, heads/mlp/vocab/experts →
  ``model``; batch over ``(pod, data)``.
* ``prefill/decode/long_decode`` — serving: TP only for dense params, MoE
  experts over the whole mesh (``(data, model)``), KV caches over
  batch/heads, or over sequence for ``long_decode``.

Every rule is divisibility-checked against the actual dim; on failure the
next candidate applies (finally: replicated), and one mesh axis shards at
most one dim of a leaf.  The tables use no framework and are copied from
the reference (a test holds them equal).

A spec is a tuple with one entry per tensor dim, each a mesh-axis name, a
tuple of names (major to minor) or ``None``: the entries of the
reference's ``PartitionSpec``.  The port's spec tree holds one subtree per
layer where the reference stacks the body on a leading ``layers → None``
dim, so a port leaf's spec is the reference leaf's without that dim.
:class:`NamedSharding` pairs a spec with a ``torch.distributed``
``DeviceMesh``: :meth:`NamedSharding.placements` gives the DTensor
placements and :meth:`NamedSharding.distribute` lays a whole tensor out
without communication (every rank holds the whole tensor and keeps its
slice).  Both tables map ``sparse_rows → model``: that rule routes
row-sharded SpMV (DESIGN.md §11), which :meth:`Partitioner.spmv_shard_axis`
resolves.

:meth:`Partitioner.tensor_parallel` reads the same leaf specs as the
tensor-parallel view of training: the ``model`` mesh dim, its size, this
rank's coordinate on it and its group, the other (batch, FSDP) mesh dims,
and for each leaf the tensor dim that ``model`` cuts (None where the
divisibility fallback left it whole).  A leaf cut over ``model`` together
with other axes (the serving rules' experts over ``("data", "model")``)
is cut over the whole of those mesh dims: the view keeps it apart
(``wide``), since a rank's chunk depends on every coordinate of the cut.

Serving on a mesh (``launch.steps.make_prefill_step`` / ``make_decode_step``
with ``partitioner=``) keeps its caches as plain local slices in the
layout of :meth:`Partitioner.cache_shardings`: :meth:`Partitioner.local_caches`
cuts a whole cache tree into this rank's slices and
:meth:`Partitioner.whole_caches` gathers them back (a collective).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.spec import P, map_spec
from repro_torch.sharding import layout

__all__ = ["Partitioner", "ShardingRules", "TRAIN_RULES", "SERVE_RULES",
           "NamedSharding", "TensorParallelView", "resolve_spmv_shard_axis",
           "mesh_signature", "LocalCache"]

Spec = Tuple[Any, ...]


def _candidates(x) -> Tuple:
    """Normalize a rule entry to a tuple of candidates (each axis-spec|None)."""
    if x is None:
        return (None,)
    if isinstance(x, list):
        return tuple(x) + (None,)
    return (x, None)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """params: logical-axis name → mesh-axis | tuple-of-axes | list of
    candidates (tried in order).  batch: axes for the batch dim."""
    params: Dict[str, Any]
    batch: Tuple[str, ...] = ("pod", "data")
    act_embed: Optional[str] = None       # residual-stream sharding constraint


TRAIN_RULES = ShardingRules(params={
    "vocab": "model",
    "embed": "data",                      # FSDP
    "q_heads_x_dim": "model",
    "kv_heads_x_dim": "model",
    "mlp": "model",
    "mlp2": None,
    "experts": "model",
    "mla_latent": None,
    "ssm_heads": None,
    "conv_ch": "model",
    "norm": None,
    "layers": None,
    "frontend": None,
    "embed2": None,
    "sparse_rows": "model",
})

SERVE_RULES = ShardingRules(params={
    "vocab": "model",
    "embed": None,                        # no FSDP on the latency path
    "q_heads_x_dim": "model",
    "kv_heads_x_dim": "model",
    "mlp": "model",
    "mlp2": None,
    "experts": [("data", "model"), "model"],   # whole-mesh EP, fallback TP
    "mla_latent": None,
    "ssm_heads": None,
    "conv_ch": "model",
    "norm": None,
    "layers": None,
    "frontend": None,
    "embed2": None,
    "sparse_rows": "model",
})


def _axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _axis_sizes(mesh) -> Dict[str, int]:
    """Axis name → size of a ``DeviceMesh`` (or of anything with its
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(_axis_names(mesh), (int(s) for s in mesh.shape)))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= _axis_size(mesh, a)
        return n
    return _axis_sizes(mesh)[axis]


def _filter_axis(mesh, axis):
    """Drop mesh axes that don't exist (e.g. 'pod' on the single-pod mesh)."""
    if axis is None:
        return None
    names = _axis_names(mesh)
    if isinstance(axis, tuple):
        kept = tuple(a for a in axis if a in names)
        return kept if kept else None
    return axis if axis in names else None


def _entry(axis):
    """A spec entry as ``PartitionSpec`` keeps it: a one-axis tuple is
    that axis."""
    if isinstance(axis, tuple) and len(axis) == 1:
        return axis[0]
    return axis


def mesh_signature(mesh) -> tuple:
    """Value identity of a ``DeviceMesh``: axis names, per-axis sizes, the
    global ranks in mesh order and the device type.

    Mesh-dependent caches (the engine's warm-plan bookkeeping) key on this
    instead of ``id(mesh)`` alone, so a resized or rebuilt mesh can never
    alias a stale entry (DESIGN.md §12).
    """
    return (_axis_names(mesh),
            tuple(int(s) for s in mesh.shape),
            tuple(int(r) for r in mesh.mesh.flatten().tolist()),
            str(mesh.device_type))


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """``spec`` on ``mesh``: the reference's ``NamedSharding``.  A spec
    shorter than the tensor's rank leaves the trailing dims replicated
    (``()`` is the reference's ``PartitionSpec()``)."""
    mesh: Any
    spec: Spec

    def placements(self) -> tuple:
        """One DTensor placement per mesh dim: ``Shard(d)`` on each mesh
        dim that the spec names for tensor dim ``d``, ``Replicate()``
        elsewhere.  A tuple of axes on one dim shards it over each of
        them, major to minor, which DTensor does in mesh-dim order: a
        tuple out of that order is refused."""
        from torch.distributed.tensor import Replicate, Shard
        names = _axis_names(self.mesh)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            idx = [names.index(a) for a in
                   (entry if isinstance(entry, tuple) else (entry,))]
            if idx != sorted(idx):
                raise ValueError(
                    f"spec entry {entry!r} is not in the mesh's axis order "
                    f"{names}: DTensor shards a dim over mesh dims in "
                    f"their order")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def device(self) -> torch.device:
        """The device a rank's shards live on: the mesh's type, the
        current card for ``"cuda"``."""
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)

    def distribute(self, full, device=None):
        """``full`` (a tensor or a numpy array, the same whole value on
        every rank) as a DTensor laid out by this sharding on ``device``
        (default :meth:`device`; ``"meta"`` for the dry run's shapes): each
        rank keeps only its slice, and nothing is communicated."""
        t = full if torch.is_tensor(full) else torch.from_numpy(
            np.array(full))
        return layout.distribute(t, self.mesh, self.placements(),
                                 device=device or self.device())


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallelView:
    """The tensor-parallel view of a mesh (training's, and a serving
    step's): ``mesh_dim`` is the ``model`` axis's index, ``size`` its rank
    count, ``rank`` this rank's coordinate on it, ``group`` its process
    group; ``batch_dims`` the other mesh dims (over which parameters are
    gathered and gradients summed); ``cuts`` maps each leaf (keyed as
    ``LanguageModel.tensors()`` keys it) to the tensor dim that ``model``
    alone cuts, or None; ``wide`` each leaf cut over ``model`` and other
    mesh dims together to ``(tensor dim, those mesh dims in order)`` (its
    ``cuts`` entry is None)."""
    mesh: Any
    mesh_dim: int
    size: int
    rank: int
    group: Any
    batch_dims: Tuple[int, ...]
    cuts: Dict[str, Optional[int]]
    wide: Dict[str, Tuple[int, Tuple[int, ...]]] = dataclasses.field(
        default_factory=dict)

    def piece(self, mesh_dims: Tuple[int, ...]) -> Tuple[int, int]:
        """``(count, index)`` of this rank's chunk of a dim cut over
        ``mesh_dims`` (major to minor), as ``layout.local_chunk`` cuts
        it."""
        coord = self.mesh.get_coordinate()
        n, i = 1, 0
        for d in mesh_dims:
            n *= self.mesh.size(d)
            i = i * self.mesh.size(d) + coord[d]
        return n, i


def _flat_specs(tree, prefix: str = "") -> Dict[str, Spec]:
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: Dict[str, Spec] = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _model_cut(spec: Spec) -> Optional[int]:
    """The tensor dim that ``model`` alone cuts (None: none, or a cut
    over ``model`` with other axes, :func:`_wide_cut`)."""
    for d, entry in enumerate(spec):
        if entry == "model" or entry == ("model",):
            return d
    return None


def _wide_cut(spec: Spec, names: Tuple[str, ...]):
    """``(tensor dim, mesh dims)`` of a dim cut over ``model`` together
    with other mesh axes, else None."""
    for d, entry in enumerate(spec):
        if isinstance(entry, tuple) and "model" in entry and len(entry) > 1:
            return d, tuple(names.index(a) for a in entry)
    return None


class LocalCache(dict):
    """One layer's cache (or a decoder layer's nested ``self`` cache) as
    this rank's plain slices: a dict of tensors that also carries
    ``placements``, each leaf's DTensor placements under
    :meth:`Partitioner.cache_shardings` (``index`` is replicated: every
    rank holds the whole ``(B,)`` vector)."""

    def __init__(self, items, placements):
        super().__init__(items)
        self.placements = dict(placements)


def _map_caches(fn, tree, shardings):
    """``fn(leaf, sharding)`` over a cache tree and its shardings; the
    dicts of leaves come back as :class:`LocalCache`."""
    if isinstance(tree, dict):
        out = {k: _map_caches(fn, v, shardings[k]) for k, v in tree.items()}
        pl = {k: sh.placements() for k, sh in shardings.items()
              if isinstance(sh, NamedSharding)}
        return LocalCache(out, pl)
    if isinstance(tree, (list, tuple)):
        return [_map_caches(fn, v, sh) for v, sh in zip(tree, shardings)]
    return None if tree is None else fn(tree, shardings)


def _plain(tree):
    """A cache tree with plain dicts."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    return tree


def resolve_spmv_shard_axis(mesh, shape_kind: str = "decode") -> str:
    """The mesh axis for row-sharded SpMV, or raise with guidance.

    The one lookup-or-raise shared by ``core.spmv`` dispatch and
    ``Engine.warm_spmv_plans`` (DESIGN.md §11 routing).
    """
    axis = Partitioner(mesh, shape_kind).spmv_shard_axis()
    if axis is None:
        raise ValueError(
            f"no mesh axis resolves the 'sparse_rows' rule on mesh axes "
            f"{_axis_names(mesh)}; pass mesh_axis= explicitly")
    return axis


class Partitioner:
    def __init__(self, mesh, shape_kind: str = "train",
                 rules: Optional[ShardingRules] = None):
        self.mesh = mesh
        self.shape_kind = shape_kind
        if rules is None:
            rules = TRAIN_RULES if shape_kind == "train" else SERVE_RULES
        self.rules = rules

    # ------------------------------------------------------------ sparse spmv
    def spmv_shard_axis(self) -> Optional[str]:
        """Mesh axis the ``sparse_rows`` rule resolves to on this mesh.

        ``ShardedRgCSR`` splits rows over exactly one mesh axis.  Returns
        the first rule candidate that is a single axis present on the mesh
        (row counts are padded per shard, so no divisibility check
        applies), or ``None`` when every candidate filters away.
        """
        for cand in _candidates(self.rules.params.get("sparse_rows")):
            cand = _filter_axis(self.mesh, cand)
            if cand is None:
                continue
            if isinstance(cand, tuple):   # row shards need a single 1-D axis
                cand = cand[0] if len(cand) == 1 else None
                if cand is None:
                    continue
            return cand
        return None

    def spmv_shard_count(self) -> int:
        """Rank count of the resolved SpMV row-shard axis (1 = unsharded)."""
        axis = self.spmv_shard_axis()
        return 1 if axis is None else _axis_size(self.mesh, axis)

    # ------------------------------------------------------- tensor parallel
    def tensor_parallel(self, spec_tree) -> Optional[TensorParallelView]:
        """The tensor-parallel view of this mesh for the parameters of
        ``spec_tree`` (a model's spec), from :meth:`param_specs`; None when
        the mesh has no ``model`` axis of more than one rank."""
        names = _axis_names(self.mesh)
        if "model" not in names:
            return None
        dim = names.index("model")
        if self.mesh.size(dim) == 1:
            return None
        specs = _flat_specs(self.param_specs(spec_tree))
        wide = {k: w for k, s in specs.items()
                if (w := _wide_cut(s, names)) is not None}
        return TensorParallelView(
            mesh=self.mesh, mesh_dim=dim, size=self.mesh.size(dim),
            rank=self.mesh.get_coordinate()[dim],
            group=self.mesh.get_group(dim),
            batch_dims=tuple(i for i in range(len(names)) if i != dim),
            cuts={k: _model_cut(s) for k, s in specs.items()}, wide=wide)

    # ------------------------------------------------------------ primitives
    def _dim_spec(self, dim: int, name: Optional[str], used: set):
        for cand in _candidates(self.rules.params.get(name)):
            cand = _filter_axis(self.mesh, cand)
            if cand is None:
                return None
            axes = cand if isinstance(cand, tuple) else (cand,)
            if any(a in used for a in axes):
                continue
            if dim % _axis_size(self.mesh, cand) == 0:
                used.update(axes)
                return _entry(cand)
        return None

    def _leaf_spec(self, p: P) -> Spec:
        used: set = set()
        return tuple(self._dim_spec(d, n, used)
                     for d, n in zip(p.shape, p.axes))

    def _named(self, spec: Spec) -> "NamedSharding":
        return NamedSharding(self.mesh, spec)

    # ---------------------------------------------------------------- params
    def param_specs(self, spec_tree):
        return map_spec(self._leaf_spec, spec_tree)

    def param_shardings(self, spec_tree):
        return map_spec(lambda p: self._named(self._leaf_spec(p)), spec_tree)

    # ------------------------------------------------------------- optimizer
    def opt_shardings(self, spec_tree, opt_name: str,
                      factored_min_dim: int = 2):
        """Sharding tree matching ``optimizer.init(params)``'s structure.
        The port's layers are not stacked, so Adafactor factors each
        layer's own tensor: a 1-D per-layer leaf keeps an unfactored
        ``v``.  An integer buffer (frozen RgCSR structure) carries a 0-d
        placeholder moment under either optimizer, replicated; the
        reference's Adafactor table gives a 2-D one ``vr``/``vc``, which
        its own ``init`` does not make."""
        rep = self._named(())

        def integer(p: P) -> bool:
            return p.dtype is not None and not p.dtype.is_floating_point

        if opt_name == "adamw":
            def moment(p: P):
                if integer(p):
                    return rep
                return self._named(self._leaf_spec(p))

            moments = map_spec(moment, spec_tree)
            return {"step": rep, "m": moments, "v": moments}

        def stats(p: P):
            if len(p.shape) >= factored_min_dim and not integer(p):
                used_r: set = set()
                vr = tuple(self._dim_spec(d, n, used_r) for d, n in
                           zip(p.shape[:-1], p.axes[:-1]))
                used_c: set = set()
                vc_dims = list(zip(p.shape[:-2], p.axes[:-2])) \
                    + [(p.shape[-1], p.axes[-1])]
                vc = tuple(self._dim_spec(d, n, used_c) for d, n in vc_dims)
                return {"vr": self._named(vr), "vc": self._named(vc)}
            return {"v": rep}

        return {"step": rep, "stats": map_spec(stats, spec_tree)}

    # ----------------------------------------------------------------- batch
    def _batch_dim(self, b: int):
        axes = _filter_axis(self.mesh, tuple(self.rules.batch))
        if axes and b % _axis_size(self.mesh, axes) == 0:
            return _entry(axes)
        return None

    def batch_shardings(self, batch_tree):
        """A ``NamedSharding`` per leaf of a dict of arrays (``(B, ...)``):
        the batch dim over the rule's batch axes where they divide it."""
        def leaf(x):
            nd = len(x.shape)
            b = x.shape[0] if nd else 1
            return self._named((self._batch_dim(b),) + (None,) * max(0,
                                                                     nd - 1))
        return {k: leaf(v) for k, v in batch_tree.items()}

    # ----------------------------------------------------------------- cache
    def cache_shardings(self, cache_tree):
        """KV/state cache shardings by leaf name: the tree of
        ``LanguageModel.init_cache`` (one dict per layer, a decoder
        layer's ``self`` nested; nothing is stacked)."""
        def walk(node, name):
            if isinstance(node, dict):
                return {k: walk(v, k) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [walk(v, i) for i, v in enumerate(node)]
            if node is None:
                return None
            return self._named(self._cache_leaf_spec(name, node, False))
        return walk(cache_tree, None)

    def _cache_leaf_spec(self, name, leaf, stacked: bool) -> Spec:
        ndim = len(leaf.shape)
        nd = ndim - (1 if stacked else 0)
        prefix = [None] if stacked else []
        if name in ("index", "block_table") or nd == 0:
            return (None,) * ndim
        used: set = set()

        def dim(d, cands):
            for c in cands:
                c = _filter_axis(self.mesh, c)
                if c is None:
                    continue
                axes = c if isinstance(c, tuple) else (c,)
                if any(a in used for a in axes):
                    continue
                if d % _axis_size(self.mesh, c) == 0:
                    used.update(axes)
                    return _entry(c)
            return None

        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        batch_c = [tuple(self.rules.batch), "data"]
        long_seq = self.shape_kind == "long_decode"
        if name in ("k", "v", "k_scale", "v_scale", "ck", "cv"):
            # (B, S, H, Dh)
            spec = [dim(shape[0], batch_c),
                    dim(shape[1], ["data"] if long_seq else []),
                    dim(shape[2], ["model"]),
                    dim(shape[3], ["model"])]
        elif name in ("ckv", "krope"):
            # (B, S, R)
            spec = [dim(shape[0], batch_c),
                    dim(shape[1], ["data"] if long_seq else []),
                    dim(shape[2], ["model"])]
        elif name == "ssm":
            # (B, H, P, N)
            spec = [dim(shape[0], batch_c), dim(shape[1], ["model"]),
                    None, None]
        elif name == "conv":
            # (B, W-1, C)
            spec = [dim(shape[0], batch_c), None, dim(shape[2], ["model"])]
        elif name == "h":
            # (B, D)
            spec = [dim(shape[0], batch_c), dim(shape[1], ["model"])]
        else:
            spec = [dim(shape[0], batch_c)] + [None] * (nd - 1)
        return tuple(prefix + spec)

    def local_caches(self, cache_tree):
        """This rank's slices of ``cache_tree`` (whole, the same on every
        rank) in the layout of :meth:`cache_shardings`, each layer's dict
        a :class:`LocalCache`: views, nothing communicated."""
        return _map_caches(lambda t, sh: layout.local_chunk(
            t, self.mesh, sh.placements()), cache_tree,
            self.cache_shardings(cache_tree))

    def whole_caches(self, local_tree, like):
        """The whole caches from every rank's slices ``local_tree`` of a
        tree shaped as ``like`` (whole tensors or meta ones of the whole
        shapes): a collective, every rank calls it."""
        whole = _map_caches(lambda t, sh: layout.gather_local(
            t, self.mesh, sh.placements()), local_tree,
            self.cache_shardings(like))
        return _plain(whole)

    # ---------------------------------------------------------------- output
    def logits_sharding(self, batch: int):
        return self._named((self._batch_dim(batch), None, None))

    def replicated(self):
        return self._named(())
