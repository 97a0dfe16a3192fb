"""Primitive layers: norms, dense projections, embeddings, RoPE, masks.

The PyTorch counterpart of ``repro.models.layers``.  ``*_spec(...)``
returns a :class:`repro_torch.models.spec.P` tree as the reference's does;
the functions (``rmsnorm``, ``dense``, ...) do the reference's arithmetic
on tensors, and the modules (:class:`RMSNorm`, :class:`Dense`,
:class:`Embed`) hold one layer's parameters and call them.

Parameters are kept in ``param_dtype`` (float32); the compute dtype
(``cfg.dtype``, bfloat16 by default) is what activations carry.  The
reference casts each weight to the compute dtype at every use; the modules
hold that cast, made once per weight and dtype and remade only when the
weight is replaced or written in place (:meth:`ParamModule.cast`) — the
same numbers without a cast of every weight on every decode step.  A model
that trains (``requires_grad_(True)`` on its parameters, grad mode on)
casts at every use, as the reference does, so that gradients flow back to
the float32 weights.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.models.spec import P

__all__ = [
    "rmsnorm_spec", "rmsnorm", "layernorm_spec", "layernorm",
    "dense_spec", "dense", "embed_spec", "embed_lookup", "embed_logits",
    "rope", "rope_positions", "make_causal_mask", "make_window_mask",
    "ParamModule", "RMSNorm", "Dense", "Embed",
]

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int):
    return {"scale": P((d,), ("norm",), init="ones")}


def rmsnorm(scale, x, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layernorm_spec(d: int):
    return {"scale": P((d,), ("norm",), init="ones"),
            "bias": P((d,), ("norm",), init="zeros")}


def layernorm(scale, bias, x, eps: float = 1e-6):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------


def dense_spec(d_in: int, d_out: int, axes=("embed", "mlp"), bias: bool = False,
               scale: float = 1.0):
    spec = {"kernel": P((d_in, d_out), axes, init="fan_in", scale=scale)}
    if bias:
        spec["bias"] = P((d_out,), (axes[-1],), init="zeros")
    return spec


def dense(kernel, x, bias=None):
    """``x @ kernel`` with ``kernel`` in the reference's ``(d_in, d_out)``
    layout, both in ``x``'s dtype."""
    y = x @ kernel.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def embed_spec(vocab: int, d: int, scale: float = 1.0):
    return {"table": P((vocab, d), ("vocab", "embed"), init="embed",
                       scale=scale)}


def embed_lookup(table, tokens):
    return table[tokens.long()]


def embed_logits(table, x):
    """Tied output head: logits = x @ tableᵀ."""
    return x @ table.to(x.dtype).T


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope_positions(batch: int, seq: int, offset=0, device="cpu"):
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    return pos.expand(batch, seq).to(torch.int32)


def rope(x, positions, theta: float = 10_000.0):
    """x: (B, S, H, D) with D even; positions: (B, S).  Half-split
    rotation, angles in float32 as the reference computes them."""
    d = x.shape[-1]
    half = d // 2
    f32 = torch.float32
    # log(theta) / half rounded to float32, as the reference computes it
    step = float(torch.log(torch.tensor(theta, dtype=f32)) / half)
    freqs = torch.exp(-torch.arange(0, half, dtype=f32, device=x.device)
                      * step)
    angles = positions.to(f32)[..., None] * freqs            # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------


def make_causal_mask(q_len: int, kv_len: int, q_offset=0, device="cpu"):
    """bool (q_len, kv_len): True = attend."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos <= q_pos


def make_window_mask(q_len: int, kv_len: int, window: int, q_offset=0,
                     device="cpu"):
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return (kv_pos <= q_pos) & (kv_pos > q_pos - window)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class ParamModule(nn.Module):
    """A module built from one parameter subtree (a dict of tensors).

    Floating tensors become parameters (frozen until the caller trains:
    ``requires_grad_(True)``) and integer tensors buffers; both share
    storage with the tree's tensors.  :meth:`cast` keeps each weight's
    compute-dtype copy when no gradient is asked for.
    """

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        self._casts: Dict[tuple, tuple] = {}
        for name, t in params.items():
            if t.is_floating_point():
                self.register_parameter(
                    name, nn.Parameter(t, requires_grad=False))
            else:
                self.register_buffer(name, t)

    def cast(self, name: str, dtype) -> torch.Tensor:
        """Tensor ``name`` in ``dtype``: itself when it already is, else a
        copy made at the first call and kept until the tensor is replaced
        or written in place (its identity or version changes).  Under grad
        mode a parameter that takes gradients is cast anew at each call,
        differentiably, and nothing is kept."""
        t = getattr(self, name)
        if t.dtype == dtype:
            return t
        if t.requires_grad and torch.is_grad_enabled():
            return t.to(dtype)
        version = 0 if t.is_inference() else t._version
        hit = self._casts.get((name, dtype))
        if hit is not None and hit[0] is t and hit[1] == version:
            return hit[2]
        with torch.no_grad():
            copy = t.detach().to(dtype)
        self._casts[(name, dtype)] = (t, version, copy)
        return copy


class RMSNorm(ParamModule):
    def forward(self, x):
        return rmsnorm(self.scale, x)


class Dense(ParamModule):
    def forward(self, x):
        bias = self.cast("bias", x.dtype) if hasattr(self, "bias") else None
        return dense(self.cast("kernel", x.dtype), x, bias)


class Embed(ParamModule):
    def lookup(self, tokens, dtype):
        return embed_lookup(self.cast("table", dtype), tokens)

    def logits(self, x):
        return embed_logits(self.cast("table", x.dtype), x)
