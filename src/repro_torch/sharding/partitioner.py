"""Logical-axis partitioner: the rule tables and the row-sharded SpMV route.

The PyTorch counterpart of ``repro.sharding.partitioner``, its routing half.
Every parameter dim carries a logical axis name (set in the layer specs); a
rules table maps names to mesh axes per *shape kind*:

* ``train``   — FSDP + TP: ``embed → data``, heads/mlp/vocab/experts →
  ``model``; batch over ``(pod, data)``.
* ``prefill/decode/long_decode`` — serving: TP only for dense params, MoE
  experts over the whole mesh (``(data, model)``), KV caches over
  batch/heads.

The tables use no framework and are copied from the reference (a test holds
them equal).  Both map ``sparse_rows → model``: that rule routes
row-sharded SpMV (DESIGN.md §11), which :meth:`Partitioner.spmv_shard_axis`
resolves on a ``torch.distributed.device_mesh.DeviceMesh``.  The parameter,
optimizer, batch, cache and logits shardings are DTensor work of sharded
training, not ported yet: those methods raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

__all__ = ["Partitioner", "ShardingRules", "TRAIN_RULES", "SERVE_RULES",
           "resolve_spmv_shard_axis", "mesh_signature"]

_NOT_PORTED = ("{} belongs to sharded training, not ported yet (ROADMAP "
               "queue 1, item 3: sharded training)")


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

    # --------------------------------------------- sharded training (raises)
    def param_specs(self, spec_tree):
        raise NotImplementedError(_NOT_PORTED.format("param_specs"))

    def param_shardings(self, spec_tree):
        raise NotImplementedError(_NOT_PORTED.format("param_shardings"))

    def opt_shardings(self, spec_tree, opt_name: str,
                      factored_min_dim: int = 2):
        raise NotImplementedError(_NOT_PORTED.format("opt_shardings"))

    def batch_shardings(self, batch_tree):
        raise NotImplementedError(_NOT_PORTED.format("batch_shardings"))

    def cache_shardings(self, cache_tree):
        raise NotImplementedError(_NOT_PORTED.format("cache_shardings"))

    def logits_sharding(self, batch: int):
        raise NotImplementedError(_NOT_PORTED.format("logits_sharding"))

    def replicated(self):
        raise NotImplementedError(_NOT_PORTED.format("replicated"))
