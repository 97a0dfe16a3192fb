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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

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


def global_norm(tree: Tensors) -> torch.Tensor:
    """The l2 norm over every floating leaf, accumulated in float32."""
    leaves = [x for x in tree.values() if _is_float(x)]
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def clip_by_global_norm(tree: Tensors, max_norm: float):
    """``(tree scaled to at most max_norm, its norm before)``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) if _is_float(g) else g
            for k, g in tree.items()}, norm


def _decay_mask(params: Tensors) -> Dict[str, bool]:
    """True = apply weight decay (2-D+ floating-point params only: the
    ``values2d`` of a ``SparseLinear`` is decayed, its integer structure
    is not a parameter)."""
    return {k: p.dim() >= 2 and p.is_floating_point()
            for k, p in params.items()}


def _zero(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape if p.is_floating_point() else (),
                       dtype=torch.float32, device=p.device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _adamw(cfg: OptimizerConfig):
    sched = _schedule(cfg)

    def init(params: Tensors):
        dev = next(iter(params.values())).device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": {k: _zero(p) for k, p in params.items()},
                "v": {k: _zero(p) for k, p in params.items()}}

    def update(grads: Tensors, state, params: Tensors):
        step = state["step"] + 1
        lr = sched(step)
        b1, b2 = cfg.betas
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()
        mask = _decay_mask(params)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            m, v = state["m"][k], state["v"][k]
            if not p.is_floating_point():
                new_p[k], new_m[k], new_v[k] = p, m, v
                continue
            g = grads[k].float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            mh, vh = m / c1, v / c2
            delta = mh / (torch.sqrt(vh) + cfg.eps)
            if cfg.weight_decay:
                delta = delta + (cfg.weight_decay if mask[k] else 0.0) \
                    * p.float()
            new_p[k] = (p.float() - lr * delta).to(p.dtype)
            new_m[k], new_v[k] = m, v
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
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": _zero(p)}
        dev = next(iter(params.values())).device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "stats": {k: stats(p) for k, p in params.items()}}

    def update(grads: Tensors, state, params: Tensors):
        step = state["step"] + 1
        lr = sched(step)
        beta2 = 1.0 - step.float() ** (-cfg.decay_rate)
        mask = _decay_mask(params)
        new_p, new_stats = {}, {}
        for k, p in params.items():
            st = state["stats"][k]
            if not p.is_floating_point():
                new_p[k], new_stats[k] = p, st
                continue
            g = grads[k].float()
            g2 = torch.square(g) + 1e-30
            if "vr" in st:
                vr = beta2 * st["vr"] + (1 - beta2) * g2.mean(-1)
                vc = beta2 * st["vc"] + (1 - beta2) * g2.mean(-2)
                denom = torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
                v_est = (vr[..., None] * vc[..., None, :]) / denom[..., None]
                delta = g * torch.rsqrt(v_est + 1e-30)
                new_stats[k] = {"vr": vr, "vc": vc}
            else:
                v = beta2 * st["v"] + (1 - beta2) * g2
                delta = g * torch.rsqrt(v + 1e-30)
                new_stats[k] = {"v": v}
            # update clipping (Adafactor's RMS-1 rule)
            rms = torch.sqrt(torch.mean(torch.square(delta)) + 1e-30)
            delta = delta / torch.clamp(rms, min=1.0)
            if cfg.weight_decay:
                delta = delta + (cfg.weight_decay if mask[k] else 0.0) \
                    * p.float()
            new_p[k] = (p.float() - lr * delta).to(p.dtype)
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
