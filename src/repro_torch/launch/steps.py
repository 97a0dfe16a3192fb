"""Step functions of the launchers: train, prefill, decode.

The PyTorch counterpart of ``repro.launch.steps``.  ``make_train_step``
builds the whole training step — loss, backward, global-norm clip,
optimizer update — with **microbatch gradient accumulation** in float32.
A step works on a :class:`~repro_torch.models.LanguageModel`'s own tensors
(``model.tensors()``): it reads their gradients and writes the updated
parameters back into them, in place.  Integer buffers (the RgCSR structure
of a ``SparseLinear``) take no gradient and are never written.  A floating
parameter the loss does not reach (the MoE router's aux-free ``bias``,
which routing reads detached, as the reference's ``stop_gradient``) gets a
zero gradient, as in the reference, so the optimizer leaves it as it is
(no weight decay on 1-D parameters).

On a mesh (``make_train_step(..., partitioner=)``) the model's tensors
are DTensors laid out by the partitioner's rules, and the step **gathers
each parameter whole at its use** (``sharding.layout.gather_at_use``):
activations stay plain local tensors, so every op of the single-device
model runs unchanged, and the backward hands each rank its shard of the
gradient, summed over the mesh.  Microbatch ``i`` is the global batch's
``i``-th part, as on one device; each rank takes its rows of it by
``batch_shardings``.  Each rank divides its CE sums by the labelled
positions of the whole microbatch (``LanguageModel.token_totals``, read
from the global batch every rank holds), so the ranks' losses sum to the
microbatch's token-weighted mean, never a mean of per-shard means.  The
ranks along mesh dims that do not split the batch (``model``) repeat the
same work on the same rows: their gradients are scaled by one over their
count before the sum.  A MoE layer routes each rank's rows with the
whole microbatch's capacity, positions and aux terms
(``models.moe.row_shard``): the ranks' load-balance and z-loss shares sum
to the microbatch's terms as their CE parts do.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch

from repro_torch.models.moe import RowShard, row_shard
from repro_torch.sharding import layout
from repro_torch.train.optimizer import OptimizerConfig, global_norm, \
    make_optimizer

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "auto_microbatches", "routing_stats"]


def auto_microbatches(cfg, global_batch: int, seq: int, n_data_shards: int,
                      budget_bytes: float = 2.0e9) -> int:
    """A microbatch count that keeps each shard's residual-stream
    activations (``B/µ · S · d_model · 2 B · n_layers``) within the budget,
    clamped to divide the shard's batch evenly."""
    b_dev = max(1, global_batch // n_data_shards)
    per_layer = seq * cfg.d_model * 2
    total = b_dev * per_layer * cfg.n_layers
    mb = max(1, int(-(-total // budget_bytes)))
    while b_dev % mb:
        mb += 1
    return min(mb, b_dev)


def _on_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device) for k, v in batch.items()}


def _update_leafwise(opt_update, grads, state, params):
    """``opt_update`` one tensor at a time, each new parameter copied into
    its tensor at once: the same arithmetic as one call over the whole
    dict, without a second copy of every parameter and moment alive at
    once (granite-3-2b's are 8.1 GB each in float32; keeping the old
    moments to the end added 15.1 GiB to its peak).  Consumes ``grads``
    and the moments of ``state``; returns the new state."""
    new_state = {}
    for k, p in params.items():
        sub = {name: {k: v.pop(k)} if isinstance(v, dict) else v
               for name, v in state.items()}
        new_p, new_sub = opt_update({k: grads.pop(k, None)}, sub, {k: p})
        if new_p[k] is not p:
            if layout.is_dtensor(p):
                p.to_local().copy_(new_p[k].to_local())
            else:
                p.copy_(new_p[k])
        for name, v in new_sub.items():
            if isinstance(v, dict):
                new_state.setdefault(name, {}).update(v)
            else:
                new_state[name] = v
    return new_state


def make_train_step(model, opt_cfg: OptimizerConfig, microbatches: int = 1,
                    *, partitioner=None):
    """``(train_step, opt_init)``.  ``train_step(params, opt_state, batch)
    -> (params, opt_state, metrics)``: ``params`` is ``model.tensors()``
    (updated in place and returned), ``batch`` a dict of ``(B, S)`` arrays
    split into ``microbatches`` equal parts along B; metrics: every
    metric of ``model.loss`` (``ce``, ``loss``, and ``load_balance`` /
    ``mtp`` where the model has them), each the mean over microbatches,
    and ``grad_norm``, as float32 tensors on the model's device.
    ``opt_state`` is consumed: its moments move into the returned state
    one tensor at a time.  With ``partitioner`` the step runs on its mesh
    (the module's note): ``params`` and the moments are DTensors, and
    ``batch`` is the global batch, the same on every rank."""
    opt_init, opt_update = make_optimizer(opt_cfg)
    if partitioner is not None:
        return _sharded_train_step(model, opt_cfg, opt_update, microbatches,
                                   partitioner), opt_init

    def train_step(params, opt_state, batch):
        batch = _on_device(batch, model.device)
        trained = {k: p for k, p in params.items()
                   if p.is_floating_point() and p.requires_grad}
        if len(trained) != sum(p.is_floating_point()
                               for p in params.values()):
            raise ValueError("every floating parameter must take gradients "
                             "(model.requires_grad_(True))")
        parts = [{k: v.chunk(microbatches)[i] for k, v in batch.items()}
                 for i in range(microbatches)]
        acc, seen = None, {}
        for mb in parts:
            for p in trained.values():
                p.grad = None
            loss, metrics = model.loss(mb)
            loss.backward()
            grads = {k: p.grad if p.grad is not None
                     else torch.zeros_like(p) for k, p in trained.items()}
            acc = grads if acc is None else \
                {k: acc[k] + g for k, g in grads.items()}
            for k, v in metrics.items():
                seen.setdefault(k, []).append(v.detach())
        for p in trained.values():
            p.grad = None
        if microbatches > 1:
            acc = {k: (g.float() / microbatches).to(g.dtype)
                   for k, g in acc.items()}
        with torch.no_grad():
            # clip_by_global_norm in place: a copy of the gradients would
            # add 5.3 GiB to granite-3-2b's peak on the H100 (PERF.md §6)
            gnorm = global_norm(acc)
            scale = torch.clamp(opt_cfg.clip_norm / (gnorm + 1e-9), max=1.0)
            for g in acc.values():
                g.mul_(scale)
            opt_state = _update_leafwise(opt_update, acc, opt_state, params)
        metrics = {k: torch.stack(v).mean() for k, v in seen.items()}
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step, opt_init


@contextlib.contextmanager
def _bound(model, tensors: Dict[str, torch.Tensor]):
    """``model`` computing with ``tensors`` (keyed as ``model.tensors()``)
    in place of its own parameters and buffers, until the block ends."""
    saved = []
    for name, t in tensors.items():
        path, _, attr = name.replace("/", ".").rpartition(".")
        mod = model.get_submodule(path)
        table = mod._parameters if attr in mod._parameters else mod._buffers
        saved.append((table, attr, table[attr]))
        table[attr] = t
    try:
        yield model
    finally:
        for table, attr, old in saved:
            table[attr] = old


def _sharded_train_step(model, opt_cfg, opt_update, microbatches: int,
                        partitioner):
    mesh = partitioner.mesh

    def train_step(params, opt_state, batch):
        trained = {k: p for k, p in params.items()
                   if p.is_floating_point() and p.requires_grad}
        if len(trained) != sum(p.is_floating_point()
                               for p in params.values()):
            raise ValueError("every floating parameter must take gradients "
                             "(model.requires_grad_(True))")
        batch = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
                 else v.cpu() for k, v in batch.items()}
        parts = [{k: v.chunk(microbatches)[i] for k, v in batch.items()}
                 for i in range(microbatches)]
        shardings = partitioner.batch_shardings(parts[0])
        rows = shardings["tokens"]
        batch_dims = sorted({i for dims in layout.sharded_mesh_dims(
            rows.placements()).values() for i in dims})
        repeats = math.prod(mesh.size(i) for i in range(mesh.ndim)
                            if i not in batch_dims)
        dev = rows.device()
        shard = RowShard.on_mesh(mesh, rows.placements())
        # each parameter whole, its gradient routed back to its shard
        whole = {k: layout.gather_at_use(p) if k in trained
                 else layout.gather(p) for k, p in params.items()}
        leaves = {k: w.detach().requires_grad_(k in trained)
                  for k, w in whole.items()}
        seen = {}
        with _bound(model, leaves), row_shard(shard):
            for mb in parts:
                totals = model.token_totals(mb)
                local = {k: layout.local_chunk(v, mesh, shardings[k]
                                               .placements()).to(dev)
                         for k, v in mb.items()}
                loss, metrics = model.loss(local, token_totals=totals)
                loss.backward()
                for k, v in metrics.items():
                    seen.setdefault(k, []).append(v.detach())
        grads = []
        for k in trained:
            g = leaves[k].grad
            g = torch.zeros_like(leaves[k]) if g is None else g
            if microbatches > 1:
                g = (g.float() / microbatches).to(g.dtype)
            grads.append(g / repeats if repeats > 1 else g)
        for p in trained.values():
            p.grad = None
        torch.autograd.backward([whole[k] for k in trained], grads)
        del whole, leaves, grads
        acc = {k: p.grad for k, p in trained.items()}
        for p in trained.values():
            p.grad = None
        with torch.no_grad():
            gnorm = global_norm(acc)
            scale = torch.clamp(opt_cfg.clip_norm / (gnorm + 1e-9), max=1.0)
            for g in acc.values():
                g.to_local().mul_(scale)
            opt_state = _update_leafwise(opt_update, acc, opt_state, params)
        # each rank's parts of the microbatches' token-weighted means
        names = list(seen)
        stacked = torch.stack([torch.stack(seen[k]) for k in names])
        layout.all_reduce_over(stacked, mesh, batch_dims)
        metrics = {k: stacked[i].mean() for i, k in enumerate(names)}
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step


def routing_stats(model, batch, partitioner=None) -> Dict[str, torch.Tensor]:
    """The MoE layers' routing of ``model`` on ``batch`` in train mode,
    without gradient: ``expert_fraction`` (``(layers, E)``) and the
    ``load_balance`` and ``router_z`` terms summed over the layers.  With
    ``partitioner`` the model's tensors are DTensors on its mesh (a
    sharded trainer's) and ``batch`` is the global batch: each rank
    routes its rows, as the sharded step does, and the terms are the whole
    batch's (collective: every rank calls)."""
    batch = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
             else v.cpu() for k, v in batch.items()}
    with torch.no_grad():
        if partitioner is None:
            return model.forward({k: v.to(model.device) for k, v in
                                  batch.items()}, mode="train")[2]
        mesh = partitioner.mesh
        rows = partitioner.batch_shardings(batch)["tokens"].placements()
        local = {k: layout.local_chunk(v, mesh, rows).to(model.device)
                 for k, v in batch.items()}
        whole = {k: layout.gather(t) for k, t in model.tensors().items()}
        with _bound(model, whole), row_shard(RowShard.on_mesh(mesh, rows)):
            aux = model.forward(local, mode="train")[2]
        terms = torch.stack([aux["load_balance"], aux["router_z"]])
        layout.all_reduce_over(terms, mesh,
                               layout.sharded_mesh_dims(rows).get(0, []))
    return dict(aux, load_balance=terms[0], router_z=terms[1])


def make_prefill_step(model, s_max: int, shape_kind: str = "prefill"):
    def prefill_step(batch):
        return model.prefill(batch, s_max, shape_kind=shape_kind)
    return prefill_step


def make_decode_step(model, shape_kind: str = "decode"):
    """The serving engine's decode step (``serve/device_loop``), imported
    lazily so that the launcher stays importable without the serve
    stack."""
    from repro_torch.serve.device_loop import make_decode_step as _make
    return _make(model, shape_kind=shape_kind)
