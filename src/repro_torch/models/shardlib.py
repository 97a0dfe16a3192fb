"""Activation-sharding constraints, resolved per cell.

The PyTorch counterpart of ``repro.models.shardlib``.  The reference
emits GSPMD hints (``with_sharding_constraint``) that never change a
value; here :func:`constrain` leaves ``x`` as it is: sharded training's
activations are plain local tensors, so every hint is the identity.

**Tensor-parallel compute** (``cfg.act_shard`` on a mesh whose ``model``
axis has more than one rank) places what the hints name by hand: inside
:func:`tensor_parallel` each *unit* — an attention layer, an FFN, a MoE
layer, the embedding, an untied head — runs in the mode the step's plan
gives it (:func:`unit`), on the slices of its parameters that the step
binds (:func:`gathered` gathers a block's parameters over the batch mesh
dims when the block runs), and data crosses ranks only through
``sharding.layout``'s region operators (``copy_in``, ``reduce_out``,
``gather_dim``, ``split_dim``): never through DTensor's redistribution,
which segfaults with gloo on CUDA tensors on the card's PyTorch
(``scripts/torch_gloo_probe.py``).  :func:`resolve_attn_shard_mode` is a
copy of the reference's (``repro.launch.dryrun``); :func:`attn_mode_for`
resolves ``"none"`` by it and checks an explicit mode.

**Serving on a mesh** runs the same units under :func:`tensor_parallel`
with two more facts of the step: ``caches`` (each cached unit's cache
leaves' placements, by ``id`` of the unit; the caches are this rank's
plain slices in the layout of ``Partitioner.cache_shardings``, read by
:func:`cache_layout`) and ``rows`` (the mesh dims that cut the batch's
rows, which whole-mesh expert parallelism gathers over).

The attention strategies (``cfg.attn_shard_mode``):

* ``heads``  — shard the kv-head dim of q/k/v,
* ``repeat`` — materialize repeated kv to Hq heads and shard those,
* ``seq``    — shard the query sequence dim over ``model``,
* ``none``   — no hint.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

__all__ = ["constrain", "batch_axes", "shard_attn_qkv",
           "resolve_attn_shard_mode", "attn_mode_for", "TensorParallel",
           "tensor_parallel", "unit", "gathered", "cache_layout",
           "batch_rows"]


def resolve_attn_shard_mode(cfg, model_axis: int) -> str:
    """Pick the attention TP strategy by divisibility (the reference's
    ``repro.launch.dryrun.resolve_attn_shard_mode``)."""
    if cfg.attn_kind == "mla":
        return "heads" if cfg.n_heads % model_axis == 0 else "seq"
    if cfg.n_kv_heads % model_axis == 0:
        return "heads"
    if cfg.n_heads % model_axis == 0:
        return "repeat"
    return "seq"


def attn_mode_for(cfg, model_axis: int) -> str:
    """``cfg.attn_shard_mode`` on a ``model`` axis of ``model_axis`` ranks:
    ``"none"`` resolved by :func:`resolve_attn_shard_mode`; an explicit
    mode whose head counts do not divide raises (``seq`` divides the
    query sequence, checked when it runs)."""
    mode = cfg.attn_shard_mode
    if mode == "none":
        return resolve_attn_shard_mode(cfg, model_axis)
    if mode not in ("heads", "repeat", "seq"):
        raise ValueError(f"unknown attn_shard_mode {mode!r}")
    if mode == "seq":
        return mode
    if mode == "heads" and cfg.attn_kind != "mla":
        count, what = cfg.n_kv_heads, "kv heads"
    else:                # repeat; MLA's heads (its k and v have every head)
        count, what = cfg.n_heads, "heads"
    if count % model_axis:
        raise ValueError(f"attn_shard_mode {mode!r}: {count} {what} do not "
                         f"divide over a model axis of {model_axis}")
    return mode


@dataclasses.dataclass
class TensorParallel:
    """One step's tensor-parallel compute: ``view`` (the partitioner's
    ``TensorParallelView``), ``modes`` (``id(unit module)`` → its mode:
    ``heads`` / ``repeat`` / ``seq`` for attention, ``split`` for an FFN,
    ``experts`` for a MoE layer, ``vocab`` for the embedding and an
    untied head) and ``bind`` (a module → a context in which its
    parameters are this step's gathered slices).  Serving adds
    ``caches`` (``id(unit)`` → cache leaf name → its placements) and
    ``rows`` (the mesh dims that cut the batch's rows)."""
    view: Any
    modes: Dict[int, str]
    bind: Callable[[Any], Any]
    caches: Dict[int, Dict[str, tuple]] = dataclasses.field(
        default_factory=dict)
    rows: Tuple[int, ...] = ()


_TP: Optional[TensorParallel] = None


@contextlib.contextmanager
def tensor_parallel(tp: Optional[TensorParallel]):
    """Model code inside the block computes tensor-parallel by ``tp``
    (None: as on one device)."""
    global _TP
    saved, _TP = _TP, tp
    try:
        yield tp
    finally:
        _TP = saved


def unit(module) -> Optional[Tuple[Any, str]]:
    """``(view, mode)`` of ``module`` when it computes tensor-parallel,
    else None."""
    if _TP is None:
        return None
    mode = _TP.modes.get(id(module))
    return None if mode is None else (_TP.view, mode)


def cache_layout(module) -> Optional[Dict[str, tuple]]:
    """The placements of ``module``'s cache leaves (by leaf name) when it
    serves tensor-parallel on a mesh, else None."""
    return None if _TP is None else _TP.caches.get(id(module))


def batch_rows() -> Tuple[int, ...]:
    """The mesh dims that cut the batch's rows in a serving step."""
    return () if _TP is None else _TP.rows


def gathered(module):
    """A context in which ``module``'s parameters are the step's slices
    (a no-op outside :func:`tensor_parallel`)."""
    return contextlib.nullcontext() if _TP is None else _TP.bind(module)


def batch_axes(cfg):
    return tuple(cfg.mesh_batch_axes) if cfg.shard_batch else None


def constrain(cfg, x, *names: Optional[object]):
    """``x`` as it is: the reference's hint that lays ``x`` out by
    ``names`` (one per dim: None / a mesh axis / ``'batch'``) marks where
    tensor-parallel compute places its activations, which the units do by
    hand (the module's note).  A DTensor activation is refused: the port
    never redistributes one."""
    if x is not None and cfg.act_shard:
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            raise TypeError("sharded training's activations are plain "
                            "local tensors; the port never redistributes "
                            "a DTensor (gloo on CUDA tensors segfaults in "
                            "DTensor's collectives)")
    return x


def shard_attn_qkv(cfg, q, k, v):
    """Apply the resolved attention TP strategy.  q: (B,S,Hq,D);
    k/v: (B,T,Hkv,D).  Returns (q, k, v) — possibly with kv repeated."""
    if not cfg.act_shard or cfg.attn_shard_mode == "none":
        return q, k, v
    mode = cfg.attn_shard_mode
    if mode == "repeat":
        g = q.shape[2] // k.shape[2]
        if g > 1:
            k = torch.repeat_interleave(k, g, dim=2)
            v = torch.repeat_interleave(v, g, dim=2)
        q = constrain(cfg, q, "batch", None, "model", None)
        k = constrain(cfg, k, "batch", None, "model", None)
        v = constrain(cfg, v, "batch", None, "model", None)
        return q, k, v
    if mode == "heads":
        q = constrain(cfg, q, "batch", None, "model", None)
        k = constrain(cfg, k, "batch", None, "model", None)
        v = constrain(cfg, v, "batch", None, "model", None)
        return q, k, v
    if mode == "seq":
        if q.shape[1] > 1:
            q = constrain(cfg, q, "batch", "model", None, None)
        k = constrain(cfg, k, "batch", None, None, None)
        v = constrain(cfg, v, "batch", None, None, None)
        return q, k, v
    raise ValueError(f"unknown attn_shard_mode {mode!r}")
