"""Optimizers (AdamW, Adafactor) + LR schedules + global-norm clipping.

The PyTorch counterpart of ``repro.train.optimizer``, without
``torch.optim``: plain functions over a dict of named tensors (a model's
parameters and integer buffers, ``LanguageModel.tensors()``), in the
reference's arithmetic order, in float32.

* **AdamW** — fp32 moments, decoupled weight decay with a mask (no decay on
  norms/biases/1-D params), bias correction.
* **Adafactor** — factored second moment (row/col RMS) for ≥2-D params.
* schedules: linear warmup → cosine/linear/constant decay.

State mirrors the parameter dict: ``{"step", "m", "v"}`` (AdamW) or
``{"step", "stats"}`` (Adafactor), every leaf float32 — an integer buffer
(the RgCSR structure of a ``SparseLinear``) gets a 0-d zero and is never
updated — so ``train/checkpoint.py`` stores it in the reference's layout.

Sharded training passes DTensors (``sharding/layout.py``): parameters,
gradients and moments laid out on one mesh.  Element-wise arithmetic runs
on each rank's slice, and every reduction counts each element once: the
global norm sums each leaf's squares over its replica count across all
ranks, and Adafactor's row, column and update means sum over the mesh
dims that shard the reduced dim.  ``init`` lays each moment out as its
parameter is (Adafactor's ``vr``/``vc`` drop the reduced dim); a state
leaf held on other placements (a replicated ``v`` of a sharded 1-D
parameter) is brought to the parameter's for the update and back.  The
step counter stays a plain tensor on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch.sharding import layout

__all__ = ["OptimizerConfig", "make_optimizer", "warmup_cosine",
           "warmup_linear", "constant", "global_norm", "clip_by_global_norm"]

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"                # adamw | adafactor
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    schedule: str = "cosine"           # cosine | linear | constant
    # adafactor
    decay_rate: float = 0.8
    factored_min_dim: int = 2


# ---------------------------------------------------------------------------
# schedules (step: an integer tensor or int; the rate: a float32 tensor)
# ---------------------------------------------------------------------------


def _warm_and_frac(cfg: OptimizerConfig, step):
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(1.0, cfg.decay_steps - cfg.warmup_steps),
                       0.0, 1.0)
    return step, warm, frac


def warmup_cosine(cfg: OptimizerConfig):
    def fn(step):
        step, warm, frac = _warm_and_frac(cfg, step)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)
    return fn


def warmup_linear(cfg: OptimizerConfig):
    def fn(step):
        step, warm, frac = _warm_and_frac(cfg, step)
        return cfg.lr * torch.where(step < cfg.warmup_steps, warm, 1.0 - frac)
    return fn


def constant(cfg: OptimizerConfig):
    return lambda step: torch.full((), cfg.lr, dtype=torch.float32)


def _schedule(cfg: OptimizerConfig):
    return {"cosine": warmup_cosine, "linear": warmup_linear,
            "constant": constant}[cfg.schedule](cfg)


# ---------------------------------------------------------------------------
# utilities
# ---------------------------------------------------------------------------


def _is_float(t) -> bool:
    return t is not None and t.is_floating_point()


def _local(t):
    """A DTensor's slice on this rank; a plain tensor as it is."""
    return t.to_local() if layout.is_dtensor(t) else t


def _like(local, ref):
    """``local`` as a DTensor laid out as ``ref`` is (plain if ``ref``
    is)."""
    if not layout.is_dtensor(ref):
        return local
    return layout.from_local(local, ref.device_mesh, ref.placements, ref.shape)


def _local_in(state, placements):
    """State leaf ``state``'s slice under ``placements`` (its own when they
    match, else relaid out)."""
    if not layout.is_dtensor(state):
        return state
    if tuple(state.placements) != tuple(placements):
        state = layout.relayout(state, placements)
    return state.to_local()


def _store(local, placements, state):
    """The new value of state leaf ``state`` from its slice ``local``
    under ``placements``, laid out as ``state`` is."""
    if not layout.is_dtensor(state):
        return local
    dt = layout.from_local(local, state.device_mesh, placements, state.shape)
    return layout.relayout(dt, state.placements)


def _drop_dim(placements, d: int):
    """The placements of a tensor reduced over dim ``d``: a mesh dim that
    sharded ``d`` now replicates, later dims shift down by one."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for pl in placements:
        if isinstance(pl, Shard) and pl.dim == d:
            out.append(Replicate())
        elif isinstance(pl, Shard) and pl.dim > d:
            out.append(Shard(pl.dim - 1))
        else:
            out.append(pl)
    return tuple(out)


def _mean(x, dim: int, ref, placements, keepdim: bool = False):
    """``x.mean(dim)`` of a slice ``x`` laid out on ``ref``'s mesh by
    ``placements``: summed over the mesh dims that shard ``dim`` when
    any do.  ``ref`` plain: ``x.mean(dim)``."""
    if not layout.is_dtensor(ref):
        return x.mean(dim, keepdim=keepdim)
    dim = dim % x.dim()
    over = layout.sharded_mesh_dims(placements).get(dim, [])
    if not over:
        return x.mean(dim, keepdim=keepdim)
    total = layout.all_reduce_over(x.sum(dim, keepdim=keepdim),
                                   ref.device_mesh, over)
    n = x.shape[dim]
    for i in over:
        n *= ref.device_mesh.size(i)
    return total / n


def _mean_all(x, ref):
    """``torch.mean(x)`` over the whole tensor whose slice under ``ref``'s
    placements is ``x``."""
    if not layout.is_dtensor(ref):
        return torch.mean(x)
    over = sorted({i for dims in layout.sharded_mesh_dims(
        ref.placements).values() for i in dims})
    if not over:
        return torch.mean(x)
    total = layout.all_reduce_over(torch.sum(x), ref.device_mesh, over)
    return total / ref.numel()


def global_norm(tree: Tensors) -> torch.Tensor:
    """The l2 norm over every floating leaf, accumulated in float32.  On
    DTensor leaves each element counts once: a leaf's local sum of squares
    over its replica count, summed over every rank of the mesh."""
    leaves = [x for x in tree.values() if _is_float(x)]
    sharded = [x for x in leaves if layout.is_dtensor(x)]
    if not sharded:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in leaves))
    if len(sharded) != len(leaves):
        raise ValueError("global_norm takes all DTensor leaves or none")
    mesh = sharded[0].device_mesh
    total = sum(torch.sum(torch.square(_local(x).float()))
                / layout.replicas(mesh, x.placements) for x in leaves)
    layout.all_reduce_over(total, mesh, range(mesh.ndim))
    return torch.sqrt(total)


def clip_by_global_norm(tree: Tensors, max_norm: float):
    """``(tree scaled to at most max_norm, its norm before)``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: _like((_local(g).float() * scale).to(g.dtype), g)
            if _is_float(g) else g for k, g in tree.items()}, norm


def _decay_mask(params: Tensors) -> Dict[str, bool]:
    """True = apply weight decay (2-D+ floating-point params only: the
    ``values2d`` of a ``SparseLinear`` is decayed, its integer structure
    is not a parameter)."""
    return {k: p.dim() >= 2 and p.is_floating_point()
            for k, p in params.items()}


def _zero(p: torch.Tensor) -> torch.Tensor:
    """A float32 zero moment laid out as ``p``; a 0-d (replicated) zero
    for an integer buffer."""
    if not layout.is_dtensor(p):
        return torch.zeros(p.shape if p.is_floating_point() else (),
                           dtype=torch.float32, device=p.device)
    if p.is_floating_point():
        return torch.zeros_like(p, dtype=torch.float32)
    return _zeros(p, (), ())


def _zeros(p, shape, placements):
    """Float32 zeros of global ``shape`` on ``p``'s mesh by ``placements``
    (``()``: replicated)."""
    from torch.distributed.tensor import Replicate
    mesh = p.device_mesh
    placements = tuple(placements) or (Replicate(),) * mesh.ndim
    local = torch.zeros(layout.local_chunk(
        torch.empty(shape, device="meta"), mesh, placements).shape,
        dtype=torch.float32, device=_local(p).device)
    return layout.from_local(local, mesh, placements, shape)


def _step0(params: Tensors) -> torch.Tensor:
    """The step counter: a plain int32 zero on the parameters' device."""
    dev = _local(next(iter(params.values()))).device
    return torch.zeros((), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _adamw(cfg: OptimizerConfig):
    sched = _schedule(cfg)

    def init(params: Tensors):
        return {"step": _step0(params),
                "m": {k: _zero(p) for k, p in params.items()},
                "v": {k: _zero(p) for k, p in params.items()}}

    def update(grads: Tensors, state, params: Tensors):
        step = _local(state["step"]) + 1
        lr = sched(step)
        b1, b2 = cfg.betas
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()
        mask = _decay_mask(params)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            m_s, v_s = state["m"][k], state["v"][k]
            if not p.is_floating_point():
                new_p[k], new_m[k], new_v[k] = p, m_s, v_s
                continue
            pl = getattr(p, "placements", None)
            g = _local(grads[k]).float()
            m = b1 * _local_in(m_s, pl) + (1 - b1) * g
            v = b2 * _local_in(v_s, pl) + (1 - b2) * torch.square(g)
            mh, vh = m / c1, v / c2
            delta = mh / (torch.sqrt(vh) + cfg.eps)
            if cfg.weight_decay:
                delta = delta + (cfg.weight_decay if mask[k] else 0.0) \
                    * _local(p).float()
            new_p[k] = _like((_local(p).float() - lr * delta).to(p.dtype), p)
            new_m[k], new_v[k] = _store(m, pl, m_s), _store(v, pl, v_s)
        return new_p, {"step": step, "m": new_m, "v": new_v}

    return init, update


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment)
# ---------------------------------------------------------------------------


def _adafactor(cfg: OptimizerConfig):
    sched = _schedule(cfg)

    def _factored(p):
        return p.is_floating_point() and p.dim() >= cfg.factored_min_dim

    def init(params: Tensors):
        def stats(p):
            if not _factored(p):
                return {"v": _zero(p)}
            n = p.dim()
            if layout.is_dtensor(p):
                return {"vr": _zeros(p, p.shape[:-1],
                                     _drop_dim(p.placements, n - 1)),
                        "vc": _zeros(p, p.shape[:-2] + p.shape[-1:],
                                     _drop_dim(p.placements, n - 2))}
            f32 = dict(dtype=torch.float32, device=p.device)
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"step": _step0(params),
                "stats": {k: stats(p) for k, p in params.items()}}

    def update(grads: Tensors, state, params: Tensors):
        step = _local(state["step"]) + 1
        lr = sched(step)
        beta2 = 1.0 - step.float() ** (-cfg.decay_rate)
        mask = _decay_mask(params)
        new_p, new_stats = {}, {}
        for k, p in params.items():
            st = state["stats"][k]
            if not p.is_floating_point():
                new_p[k], new_stats[k] = p, st
                continue
            pl = getattr(p, "placements", None)
            g = _local(grads[k]).float()
            g2 = torch.square(g) + 1e-30
            if "vr" in st:
                n = p.dim()
                pr = pc = None
                if pl is not None:
                    pr, pc = _drop_dim(pl, n - 1), _drop_dim(pl, n - 2)
                vr = beta2 * _local_in(st["vr"], pr) \
                    + (1 - beta2) * _mean(g2, -1, p, pl)
                vc = beta2 * _local_in(st["vc"], pc) \
                    + (1 - beta2) * _mean(g2, -2, p, pl)
                denom = torch.clamp(_mean(vr, -1, p, pr, keepdim=True),
                                    min=1e-30)
                v_est = (vr[..., None] * vc[..., None, :]) / denom[..., None]
                delta = g * torch.rsqrt(v_est + 1e-30)
                new_stats[k] = {"vr": _store(vr, pr, st["vr"]),
                                "vc": _store(vc, pc, st["vc"])}
            else:
                v = beta2 * _local_in(st["v"], pl) + (1 - beta2) * g2
                delta = g * torch.rsqrt(v + 1e-30)
                new_stats[k] = {"v": _store(v, pl, st["v"])}
            # update clipping (Adafactor's RMS-1 rule)
            rms = torch.sqrt(_mean_all(torch.square(delta), p) + 1e-30)
            delta = delta / torch.clamp(rms, min=1.0)
            if cfg.weight_decay:
                delta = delta + (cfg.weight_decay if mask[k] else 0.0) \
                    * _local(p).float()
            new_p[k] = _like((_local(p).float() - lr * delta).to(p.dtype), p)
        return new_p, {"step": step, "stats": new_stats}

    return init, update


def make_optimizer(cfg: OptimizerConfig):
    """Returns (init_fn, update_fn).

    ``update_fn(grads, state, params) -> (new_params, new_state)``, every
    dict keyed by parameter name (``grads`` needs the floating ones);
    gradient clipping is applied by the caller (the train step) so the
    norm can be logged.
    """
    if cfg.name == "adamw":
        return _adamw(cfg)
    if cfg.name == "adafactor":
        return _adafactor(cfg)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
