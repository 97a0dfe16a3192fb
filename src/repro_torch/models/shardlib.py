"""Activation-sharding constraints, resolved per cell.

The PyTorch counterpart of ``repro.models.shardlib``.  The reference
emits GSPMD hints (``with_sharding_constraint``) that never change a
value; here :func:`constrain` redistributes a DTensor activation to the
named placements and leaves a plain tensor as it is.  The sharded train
step gathers each parameter whole at its use, so its activations are
plain local tensors and every hint is the identity there; the hints mark
where tensor-parallel compute over ``model`` will place its activations.

The attention strategies (``cfg.attn_shard_mode``):

* ``heads``  — shard the kv-head dim of q/k/v,
* ``repeat`` — materialize repeated kv to Hq heads and shard those,
* ``seq``    — shard the query sequence dim over ``model``,
* ``none``   — no hint.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["constrain", "batch_axes", "shard_attn_qkv"]


def batch_axes(cfg):
    return tuple(cfg.mesh_batch_axes) if cfg.shard_batch else None


def _placements(mesh, names, ndim: int):
    """DTensor placements of a spec whose entries are mesh-axis names,
    tuples of them or None."""
    from repro_torch.sharding.partitioner import NamedSharding
    spec = tuple(n for n in names) + (None,) * (ndim - len(names))
    return NamedSharding(mesh, spec).placements()


def constrain(cfg, x, *names: Optional[object]):
    """``x`` laid out by ``names`` (one per dim: None / a mesh axis /
    ``'batch'``, resolved to the cell's batch axes) if ``cfg.act_shard``:
    a DTensor is redistributed, a plain tensor is returned as it is."""
    if not cfg.act_shard or x is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    parts = [batch_axes(cfg) if n == "batch" else n for n in names]
    mesh = x.device_mesh
    kept = []
    for n in parts:            # axes this mesh lacks ('pod') drop out
        if isinstance(n, tuple):
            n = tuple(a for a in n if a in mesh.mesh_dim_names) or None
        elif n is not None and n not in mesh.mesh_dim_names:
            n = None
        kept.append(n)
    return x.redistribute(mesh, _placements(mesh, kept, x.dim()))


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
