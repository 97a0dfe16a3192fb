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

**Tensor-parallel** (``cfg.act_shard`` on a mesh whose ``model`` axis has
more than one rank, as ``launch/train.py --mesh`` sets it): nothing is
gathered whole at the start.  Each rank holds and computes its own
``model`` slice, as the partitioner's rules place it
(``LanguageModel.tensor_parallel_plan``; ``models.shardlib``): a block
gathers its parameters over the batch mesh dims when it runs, the
embedding, norms and head once per microbatch, and the activations stay
plain local tensors that cross ranks through ``sharding.layout``'s region
operators.  The gradient rule is per leaf: a leaf split over ``model``
reaches its shard summed over the batch dims alone, with no division by
the ``model`` ranks; so does a leaf replicated along ``model`` (every
``model`` rank computes the same gradient for it); a leaf a split unit
uses whole or in part (``seq`` attention, ``repeat``'s k and v where
``model`` leaves them whole, the Mamba-2 mixer's per-head leaves and
norm scale, of which a rank reads its heads) is summed over every mesh
dim; a cut leaf of a unit that computes whole (an FFN or MoE layer whose
dims ``model`` does not divide) takes this rank's slice of its own whole
gradient.

**Serving on a mesh** (``make_prefill_step`` / ``make_decode_step`` with
``partitioner=``, a ``Partitioner`` of the serving shape kind): the
model's tensors are DTensors laid out by its rules (``SERVE_RULES``: no
FSDP, MoE experts over the whole mesh; :func:`shard_for_serving`), and
the step computes tensor-parallel exactly as training does, without
gradients: each unit on its ``model`` slice, activations as plain local
tensors.  The caches are this rank's plain slices in the layout of
``Partitioner.cache_shardings`` (``sharding.partitioner.LocalCache``):
k/v cut over the batch, then kv heads or head-dim, or over the sequence
by ``data`` for ``long_decode``; MLA's latents over ``R``; ``ssm`` over
heads, ``conv`` over channels, ``h`` over ``d_rnn``.  Where a unit's
activations want another layout than its cache's, it moves the data
through ``sharding.layout``'s region operators (the models' notes), so
the collective log counts it.  Each rank takes its rows of the global
batch by ``batch_shardings``; the logits come back laid out by
``logits_sharding`` (the vocabulary gathered over ``model``).  A mode or
cut the rules do not divide raises: nothing falls back to gathering a
parameter whole at its use.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch

from repro_torch.models import shardlib
from repro_torch.models.moe import RowShard, row_shard
from repro_torch.sharding import layout
from repro_torch.train.optimizer import OptimizerConfig, global_norm, \
    make_optimizer

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "auto_microbatches", "routing_stats", "mixer_gaps",
           "shard_for_serving", "local_zeros"]


def auto_microbatches(cfg, global_batch: int, seq: int, n_data_shards: int,
                      budget_bytes: float = 2.0e9) -> int:
    """A microbatch count that keeps each shard's residual-stream
    activations (``B/µ · S · d_model · 2 B · n_layers``) within the budget,
    clamped to divide the shard's batch evenly: the smallest divisor of
    the shard's batch at or above the budget's count, the whole shard
    batch (one sequence a microbatch) when the count exceeds it.  (The
    reference's loop never ends there: qwen1.5-32b's and deepseek-v3's
    ``train_4k`` cells ask for 22 and 29 microbatches of 16 sequences.)"""
    b_dev = max(1, global_batch // n_data_shards)
    per_layer = seq * cfg.d_model * 2
    total = b_dev * per_layer * cfg.n_layers
    mb = max(1, int(-(-total // budget_bytes)))
    while mb < b_dev and b_dev % mb:
        mb += 1
    return min(mb, b_dev)


def _host_batch(batch) -> Dict[str, torch.Tensor]:
    """The global batch as host tensors (meta tensors, the dry run's, stay
    on meta: they hold no values to move)."""
    return {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
            else v if v.is_meta else v.cpu() for k, v in batch.items()}


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


class _Binding:
    """A model's tensors bound, while a block runs, to this step's
    tensor-parallel slices: each rank's plain local slice (``leaves``)
    gathered by the plan's class of the leaf (the module's note).  The
    embedding, norms and heads outside the blocks are bound per
    microbatch (:meth:`top`); a block binds its own when it runs
    (``shardlib.gathered``)."""

    def __init__(self, model, view, serving: bool = False):
        self.model, self.view = model, view
        self.modes, self.classes = model.tensor_parallel_plan(view, serving)
        names = list(model.tensors())
        if serving:
            # serving never gathers a parameter whole at its use
            stray = sorted(k for k in names if self.classes.get(k) is None
                           and (view.cuts.get(k) is not None
                                or k in view.wide))
            if stray:
                raise ValueError(
                    f"serving on a mesh: no tensor-parallel unit takes the "
                    f"cut leaves {stray} (their dims do not divide as the "
                    f"rules place them), and nothing is gathered whole at "
                    f"its use")
        self.members = {id(b): [k for k in names
                                if k.startswith(prefix + "/")]
                        for prefix, b in model.blocks()}
        inside = {k for ks in self.members.values() for k in ks}
        self.outside = [k for k in names if k not in inside]
        self.leaves = self.placements = None

    def gather(self, name: str) -> torch.Tensor:
        view, t = self.view, self.leaves[name]
        mesh, pl = view.mesh, self.placements[name]
        cls = self.classes.get(name)
        if cls == "local":          # whole-mesh experts: the rank's own
            return t
        if cls == "whole":
            return layout.gather_local_at_use(t, mesh, pl)
        g = layout.gather_local_at_use(t, mesh, pl, view.batch_dims)
        cut = view.cuts.get(name)
        if cls is None and cut is not None:     # gather-at-use over model
            g = layout.gather_dim(g, cut, mesh, view.mesh_dim)
        return g

    def bind(self, module):
        return _bound(self.model, {k: self.gather(k)
                                   for k in self.members[id(module)]})

    def top(self):
        return _bound(self.model, {k: self.gather(k) for k in self.outside})

    @contextlib.contextmanager
    def step(self, tensors, trained=(), caches=None, rows=()):
        """Model code computes tensor-parallel on the slices of
        ``tensors`` (the model's DTensors, keyed as ``model.tensors()``):
        yields each one's plain local slice, a leaf that takes gradients
        for the keys of ``trained``.  Serving passes its units' cache
        placements (``caches``) and the batch's row mesh dims (``rows``):
        ``shardlib.TensorParallel``."""
        self.placements = {k: tuple(t.placements) for k, t in
                           tensors.items()}
        self.leaves = {k: t.to_local().detach().requires_grad_(k in trained)
                       for k, t in tensors.items()}
        try:
            with shardlib.tensor_parallel(shardlib.TensorParallel(
                    self.view, self.modes, self.bind, caches or {},
                    tuple(rows))):
                yield self.leaves
        finally:
            self.leaves = self.placements = None


def _tensor_parallel(model, partitioner):
    """A :class:`_Binding` when ``model`` trains tensor-parallel on
    ``partitioner``'s mesh (``cfg.act_shard`` and a ``model`` axis of more
    than one rank), else None."""
    if not model.cfg.act_shard:
        return None
    view = partitioner.tensor_parallel(model.spec())
    return None if view is None else _Binding(model, view)


def _gathered_grads(model, params, trained, parts, place, microbatches,
                    repeats):
    """Gather-at-use: each parameter whole for the step, its gradient
    routed back to its shard (the module's note); ``(grads, metrics)``."""
    whole = {k: layout.gather_at_use(p) if k in trained
             else layout.gather(p) for k, p in params.items()}
    leaves = {k: w.detach().requires_grad_(k in trained)
              for k, w in whole.items()}
    seen = {}
    with _bound(model, leaves):
        for mb in parts:
            loss, metrics = model.loss(place(mb),
                                       token_totals=model.token_totals(mb))
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
    return acc, seen


def _parallel_grads(model, binding, params, trained, parts, place,
                    microbatches, repeats):
    """Tensor-parallel: each rank's slices, gathered per block as it runs
    (the module's note); ``(grads, metrics)``."""
    seen = {}
    with binding.step(params, trained) as leaves:
        for mb in parts:
            with binding.top():
                loss, metrics = model.loss(
                    place(mb), token_totals=model.token_totals(mb))
            loss.backward()
            for k, v in metrics.items():
                seen.setdefault(k, []).append(v.detach())
    acc = {}
    for k, p in trained.items():
        g = leaves[k].grad
        g = torch.zeros_like(leaves[k]) if g is None else g
        if microbatches > 1:
            g = (g.float() / microbatches).to(g.dtype)
        if repeats > 1:
            g = g / repeats
        acc[k] = layout.from_local(g, p.device_mesh, p.placements, p.shape)
    return acc, seen


def _sharded_train_step(model, opt_cfg, opt_update, microbatches: int,
                        partitioner):
    mesh = partitioner.mesh
    binding = _tensor_parallel(model, partitioner)

    def train_step(params, opt_state, batch):
        trained = {k: p for k, p in params.items()
                   if p.is_floating_point() and p.requires_grad}
        if len(trained) != sum(p.is_floating_point()
                               for p in params.values()):
            raise ValueError("every floating parameter must take gradients "
                             "(model.requires_grad_(True))")
        batch = _host_batch(batch)
        parts = [{k: v.chunk(microbatches)[i] for k, v in batch.items()}
                 for i in range(microbatches)]
        shardings = partitioner.batch_shardings(parts[0])
        rows = shardings["tokens"]
        batch_dims = sorted({i for dims in layout.sharded_mesh_dims(
            rows.placements()).values() for i in dims})
        # the ranks that repeat the same work on the same rows (model's
        # are not: tensor-parallel, each computes its slice)
        same = [i for i in range(mesh.ndim) if i not in batch_dims and (
            binding is None or i != binding.view.mesh_dim)]
        repeats = math.prod(mesh.size(i) for i in same)
        # the rank's device; a meta batch (the dry run) stays on meta
        dev = batch["tokens"].device if batch["tokens"].is_meta \
            else rows.device()

        def place(mb):
            return {k: layout.local_chunk(v, mesh, shardings[k]
                                          .placements()).to(dev)
                    for k, v in mb.items()}
        with row_shard(RowShard.on_mesh(mesh, rows.placements())):
            if binding is None:
                acc, seen = _gathered_grads(model, params, trained, parts,
                                            place, microbatches, repeats)
            else:
                acc, seen = _parallel_grads(model, binding, params, trained,
                                            parts, place, microbatches,
                                            repeats)
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
    routes its rows, as the sharded step does (tensor-parallel where the
    step is), and the terms are the whole batch's (collective: every rank
    calls)."""
    batch = _host_batch(batch)
    with torch.no_grad():
        if partitioner is None:
            return model.forward({k: v.to(model.device) for k, v in
                                  batch.items()}, mode="train")[2]
        mesh = partitioner.mesh
        rows = partitioner.batch_shardings(batch)["tokens"].placements()
        local = {k: layout.local_chunk(v, mesh, rows).to(model.device)
                 for k, v in batch.items()}
        binding = _tensor_parallel(model, partitioner)
        with row_shard(RowShard.on_mesh(mesh, rows)):
            if binding is None:
                whole = {k: layout.gather(t)
                         for k, t in model.tensors().items()}
                with _bound(model, whole):
                    aux = model.forward(local, mode="train")[2]
            else:
                with binding.step(model.tensors()), binding.top():
                    aux = model.forward(local, mode="train")[2]
        terms = torch.stack([aux["load_balance"], aux["router_z"]])
        layout.all_reduce_over(terms, mesh,
                               layout.sharded_mesh_dims(rows).get(0, []))
    return dict(aux, load_balance=terms[0], router_z=terms[1])


def mixer_gaps(model, partitioner, prefix: str, x, grad_out
               ) -> Dict[str, Dict[str, float]]:
    """The recurrent mixer of block ``prefix`` (its ``ssm`` mixer or its
    ``rec`` block) split, as the tensor-parallel step binds it, against
    the same mixer whole, on this rank (collective: every rank of the
    mesh calls it).  ``model``'s tensors are DTensors on
    ``partitioner``'s mesh; the mixer's leaves are gathered whole for
    this check alone.  Each run takes ``x`` (``(B, L, d)``, the same on
    every rank) and its backward ``grad_out``, split and whole, in
    float64 and in float32.  For the output, the gradient of ``x`` and
    each leaf's gradient (a cut leaf's: this rank's slice; a whole one's
    summed over the ``model`` ranks first, each computing its part), the
    largest ``|a − b|`` over the largest ``|b|`` with ``b`` the float64
    whole: ``exact`` of the float64 split (the same function, exactly),
    ``split`` and ``whole`` of the float32 runs (their rounding: Mamba-2's
    SSD takes differences of long cumulative sums of ``dt·a``, which
    float32 resolves to ~1e-5 of their size at full width)."""
    from repro_torch.models import recurrent as rec_mod
    binding = _tensor_parallel(model, partitioner)
    if binding is None:
        raise ValueError("mixer_gaps needs a tensor-parallel model: "
                         "cfg.act_shard on a mesh with a model axis")
    view = binding.view
    block = dict(model.blocks())[prefix]
    name, apply = ("mixer", rec_mod.mamba2_apply) if hasattr(block, "mixer") \
        else ("rec", rec_mod.rglru_apply)
    unit = getattr(block, name)
    tensors = model.tensors()
    keys = [k for k in tensors if k.startswith(f"{prefix}/{name}/")]
    whole = {k: layout.gather(tensors[k]) for k in keys}
    split = shardlib.TensorParallel(view, binding.modes,
                                    lambda module: contextlib.nullcontext())

    def run(tp, dtype):
        leaves = {k: (t if tp is None or view.cuts.get(k) is None
                      else t.chunk(view.size, view.cuts[k])[view.rank])
                  .detach().to(dtype).requires_grad_(True)
                  for k, t in whole.items()}
        xg = x.detach().to(dtype).requires_grad_(True)
        with _bound(model, leaves), shardlib.tensor_parallel(tp):
            y = apply(unit, model.cfg, xg)
        y.backward(grad_out.to(dtype))
        out = {"output": y.detach(), "x": xg.grad}
        for k, t in leaves.items():
            if tp is not None and view.cuts.get(k) is None:
                layout.all_reduce_over(t.grad, view.mesh, [view.mesh_dim])
            out[k[len(prefix) + 1:]] = t.grad
        return out
    truth = run(None, torch.float64)
    runs = {"exact": run(split, torch.float64),
            "split": run(split, torch.float32),
            "whole": run(None, torch.float32)}
    out = {}
    for k, want in truth.items():
        cut = view.cuts.get(f"{prefix}/{k}")
        if cut is not None:
            want = want.chunk(view.size, cut)[view.rank]
        scale = want.abs().max().clamp_min(1e-300)
        out[k] = {}
        for label, got in runs.items():
            g = got[k]
            if label == "whole" and cut is not None:
                g = g.chunk(view.size, cut)[view.rank]
            out[k][label] = float((g.double() - want).abs().max() / scale)
    return out


# ------------------------------------------------------------- serving


def make_prefill_step(model, s_max: int, shape_kind: str = "prefill",
                      partitioner=None):
    """``prefill_step(batch) -> (last-position logits, caches)``:
    ``model.prefill``.  With ``partitioner`` (a serving ``Partitioner``
    on a mesh; the model laid out by :func:`shard_for_serving`) the step
    runs on the mesh (the module's note): ``batch`` is the global batch,
    the same on every rank, the logits are this rank's rows (the whole
    vocabulary), and the caches are this rank's slices, each layer's a
    ``LocalCache``.  ``prefill_step(batch, caches=)`` fills the given
    fresh local caches (index 0) instead of allocating them."""
    if partitioner is None:
        def prefill_step(batch, caches=None):
            return model.prefill(batch, s_max, shape_kind=shape_kind,
                                 caches=caches)
        return prefill_step
    serving = _Serving(model, partitioner, shape_kind)

    def prefill_step(batch, caches=None):
        return serving.prefill(batch, s_max, caches)
    return prefill_step


def make_decode_step(model, shape_kind: str = "decode", partitioner=None):
    """The serving engine's decode step (``serve/device_loop``), imported
    lazily so that the launcher stays importable without the serve
    stack.  With ``partitioner`` the step runs on the mesh (the module's
    note): ``decode_step(caches, tokens)`` takes this rank's cache slices
    (``LocalCache``s, from the mesh prefill or
    ``Partitioner.local_caches``) and the global ``(B, 1)`` tokens, and
    returns this rank's rows of the logits and its new slices."""
    from repro_torch.serve.device_loop import make_decode_step as _make
    return _make(model, shape_kind=shape_kind, partitioner=partitioner)


def shard_for_serving(model, partitioner, device=None):
    """Lay ``model``'s tensors (the same whole values on every rank) out as
    DTensors by ``partitioner``'s rules, each rank keeping its slices
    (``device``: the sharding's by default, ``"meta"`` for the dry run);
    returns the model."""
    from repro_torch.train.trainer import _flat, distribute_model
    distribute_model(model, _flat(partitioner.param_shardings(model.spec())),
                     device=device)
    return model


def _cache_units(model, caches) -> Dict[int, dict]:
    """``id(unit)`` → its cache leaves' placements, from the layers'
    ``LocalCache``s (the attention layer's, a decoder layer's cross
    attention's ``ck``/``cv``, a recurrent mixer's state)."""
    from repro_torch.sharding.partitioner import LocalCache
    out = {}
    for block, cache in zip(model.layers, caches, strict=True):
        if not isinstance(cache, LocalCache):
            raise TypeError("a mesh step takes this rank's cache slices as "
                            "LocalCache dicts (the mesh prefill's, or "
                            "Partitioner.local_caches)")
        if "self" in cache:
            out[id(block.cross)] = {k: cache.placements[k]
                                    for k in ("ck", "cv")}
            out[id(block.attn)] = cache["self"].placements
        else:
            unit = next(getattr(block, n) for n in ("attn", "mixer", "rec")
                        if hasattr(block, n))
            out[id(unit)] = cache.placements
    return out


def _index_rows(cache, mesh, rows, whole=None):
    """``cache`` with its whole ``index`` replaced by this rank's rows
    (``whole`` None), or (``whole``: the old cache) a ``LocalCache`` of the
    new slices with the whole index advanced as the rank's rows were."""
    from repro_torch.sharding.partitioner import LocalCache
    if not isinstance(cache, dict):
        return cache
    out = {k: _index_rows(v, mesh, rows, None if whole is None
                          else whole[k]) for k, v in cache.items()}
    if "index" in cache:
        if whole is None:
            out["index"] = layout.local_chunk(cache["index"], mesh, rows)
        else:
            old = whole["index"]
            step = cache["index"][:1] - layout.local_chunk(old, mesh,
                                                           rows)[:1]
            out["index"] = old + step
    pl = (cache if whole is None else whole).placements
    return LocalCache(out, pl)


class _Serving:
    """One model's prefill and decode on a mesh (the module's note)."""

    def __init__(self, model, partitioner, shape_kind: str):
        if partitioner.shape_kind == "train":
            raise ValueError("serving on a mesh takes a serving partitioner "
                             "(shape kind prefill, decode or long_decode)")
        if not model.cfg.act_shard:
            raise ValueError("serving on a mesh computes tensor-parallel: "
                             "set cfg.act_shard (no gather-at-use forward)")
        view = partitioner.tensor_parallel(model.spec())
        if view is None:
            raise ValueError("serving on a mesh needs a model axis of more "
                             "than one rank")
        self.model, self.part, self.shape_kind = model, partitioner, \
            shape_kind
        self.mesh = partitioner.mesh
        self.binding = _Binding(model, view, serving=True)

    def _rows(self, n_rows: int):
        """Placements of a ``(B, ...)`` batch leaf by ``batch_shardings``."""
        return self.part.batch_shardings(
            {"x": torch.empty((n_rows,), device="meta")})["x"].placements()

    def _logits(self, logits):
        """The logits laid out as ``logits_sharding`` lays them: the
        vocabulary whole on every rank."""
        view = self.binding.view
        if self.binding.modes.get(id(self.model._head())) == "vocab":
            logits = layout.gather_dim(logits, -1, view.mesh, view.mesh_dim)
        return logits

    def _run(self, caches, rows, fn):
        """``fn`` of the caches with their index cut to this rank's rows,
        tensor-parallel; (logits laid out, the new ``LocalCache``s)."""
        tp = self.binding
        row_dims = tuple(layout.sharded_mesh_dims(rows).get(0, []))
        with torch.no_grad(), row_shard(RowShard.on_mesh(self.mesh, rows)), \
                tp.step(self.model.tensors(),
                        caches=_cache_units(self.model, caches),
                        rows=row_dims), tp.top():
            logits, new = fn([_index_rows(c, self.mesh, rows)
                              for c in caches])
        return self._logits(logits), [
            _index_rows(c, self.mesh, rows, old)
            for c, old in zip(new, caches, strict=True)]

    def prefill(self, batch, s_max: int, caches=None):
        batch = _host_batch(batch)
        n = batch["tokens"].shape[0]
        rows = self._rows(n)
        dev = batch["tokens"].device if batch["tokens"].is_meta \
            else self.part.replicated().device()
        local = {k: layout.local_chunk(v, self.mesh, rows).to(dev)
                 for k, v in batch.items()}
        if caches is None:       # fresh, this rank's slices
            enc_len = batch["frames"].shape[1] if self.model.cfg.enc_dec \
                else 0
            caches = local_zeros(self.part, self.model.init_cache(
                n, s_max, shape_kind=self.shape_kind, enc_len=enc_len,
                device="meta"), dev)
        return self._run(caches, rows, lambda inner: self.model.prefill(
            local, s_max, shape_kind=self.shape_kind, caches=inner))

    def decode(self, caches, tokens):
        tokens = torch.as_tensor(tokens)
        rows = self._rows(tokens.shape[0])
        dev = next(_cache_tensors(caches)).device
        local = layout.local_chunk(tokens, self.mesh, rows).to(dev)
        return self._run(caches, rows, lambda inner: self.model.decode_step(
            inner, local, shape_kind=self.shape_kind))


def local_zeros(partitioner, whole, device):
    """Zeroed tensors of this rank's slices of the cache tree ``whole``
    (whole shapes; meta tensors will do) on ``device``, each layer's a
    ``LocalCache``: each slice its own storage."""
    def alloc(node):
        if isinstance(node, dict):
            return type(node)({k: alloc(v) for k, v in node.items()},
                              node.placements)
        return torch.zeros(node.shape, dtype=node.dtype, device=device)
    return [alloc(c) for c in partitioner.local_caches(whole)]


def _cache_tensors(tree):
    """Every tensor of a cache tree, depth first."""
    for node in (tree.values() if isinstance(tree, dict) else tree):
        if torch.is_tensor(node):
            yield node
        else:
            yield from _cache_tensors(node)
