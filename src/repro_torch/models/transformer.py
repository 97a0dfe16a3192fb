"""Residual blocks and the layer stack.

The PyTorch counterpart of ``repro.models.transformer`` for attention
blocks.  The layer list is ``prefix_pattern`` followed by ``layer_pattern``
repeated ``pattern_repeats`` times — the reference's order — and the port
holds one :class:`Block` module per layer, run by a plain loop
(:func:`stack_apply`), where the reference stacks each pattern position's
parameters on a leading axis and scans over them.

Kinds ported: ``attn`` (global attention + FFN), ``attn_local``
(sliding-window attention + FFN) and ``moe`` (global attention + the MoE
FFN, dropless whenever ``mode != "train"``), each with GQA or MLA
attention per ``cfg.attn_kind``; ``ssm`` (the Mamba-2 mixer alone — no
FFN) and ``rec`` (the RG-LRU block + FFN), whose caches are recurrent
states (``models/recurrent.py``): a prefill returns the state at the
prompt's end, and a decode step returns the next state, never writing
the one it was given; ``enc_attn`` (the encoder's bidirectional
attention + FFN) and ``dec_attn`` (causal self-attention, then
cross-attention to the encoder's output ``enc_out``, then the FFN).  A
serving ``dec_attn`` layer's cache is ``{"self": its KV cache, "ck",
"cv"}``: the cross-attention keys and values, made once per request from
the encoder's output (``LanguageModel.prefill``); without them the layer
needs ``enc_out``.

Remat (``cfg.remat``) wraps each repeat of ``layer_pattern`` in
``torch.utils.checkpoint``: ``"full"`` keeps only its input, as the
reference's ``jax.checkpoint``; ``"dots"`` keeps every matrix product's
output (``aten`` ``mm``, ``addmm``, ``bmm``, ``baddbmm`` and the like,
which ``matmul``, ``linear`` and ``einsum`` lower to) and recomputes the
rest, as ``jax.checkpoint_policies.checkpoint_dots``.  Whatever the
recomputed part runs (a MoE layer's collectives on a mesh) runs again in
the backward, in the same order on every rank.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models.ffn import FFN, ffn_apply, ffn_spec
from repro_torch.models.layers import RMSNorm, rmsnorm_spec
from repro_torch.models.moe import MoE, moe_apply, moe_spec

__all__ = ["layer_kinds", "block_spec", "block_apply", "stack_spec",
           "stack_apply", "init_block_cache", "Block"]

_KINDS = ("attn", "attn_local", "moe", "ssm", "rec", "enc_attn", "dec_attn")


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def layer_kinds(cfg) -> List[str]:
    """Every layer's kind, in the reference's order: the prefix, then the
    pattern repeated."""
    return list(cfg.prefix_pattern) + list(cfg.layer_pattern) \
        * cfg.pattern_repeats


def _attn_spec(cfg):
    return attn_mod.mla_spec(cfg) if cfg.attn_kind == "mla" \
        else attn_mod.gqa_spec(cfg)


def _attn_apply(layer, cfg, x, positions, *, mode, cache, window):
    fn = attn_mod.mla_apply if cfg.attn_kind == "mla" else attn_mod.gqa_apply
    return fn(layer, cfg, x, positions, mode=mode, cache=cache,
              window=window)


def block_spec(cfg, kind: str):
    _check_kind(kind)
    d = cfg.d_model
    if kind == "ssm":                    # no FFN in Mamba-2 stacks
        return {"ln1": rmsnorm_spec(d), "mixer": rec_mod.mamba2_spec(cfg)}
    spec = {"ln1": rmsnorm_spec(d),
            **({"rec": rec_mod.rglru_spec(cfg)} if kind == "rec"
               else {"attn": _attn_spec(cfg)})}
    if kind == "dec_attn":
        spec["ln_cross"] = rmsnorm_spec(d)
        spec["cross"] = attn_mod.gqa_spec(cfg)
    spec["ln2"] = rmsnorm_spec(d)
    spec["ffn"] = moe_spec(cfg) if kind == "moe" else ffn_spec(cfg)
    return spec


def stack_spec(cfg):
    """One block spec per layer (a list, in layer order)."""
    return [block_spec(cfg, kind) for kind in layer_kinds(cfg)]


def _effective_window(cfg, kind: str, shape_kind: str) -> Optional[int]:
    if kind == "attn_local":
        return cfg.window
    if shape_kind == "long_decode" and not cfg.is_subquadratic:
        # full-attention archs fall back to a sliding window at 500k
        return cfg.fallback_window
    return None


class Block(nn.Module):
    """One residual block: ``ln1``, then ``attn`` (GQA or MLA), ``rec``
    (an :class:`~repro_torch.models.recurrent.RGLRU`) or, for ``ssm``,
    ``mixer`` (a :class:`~repro_torch.models.recurrent.Mamba2`, and
    nothing after it); for ``dec_attn`` then ``ln_cross`` and ``cross``
    (a GQA); then ``ln2`` and ``ffn`` (an FFN, or an
    :class:`~repro_torch.models.moe.MoE` for ``moe``)."""

    def __init__(self, params, cfg, kind: str):
        super().__init__()
        _check_kind(kind)
        self.kind = kind
        self.ln1 = RMSNorm(params["ln1"])
        if kind == "ssm":
            self.mixer = rec_mod.Mamba2(params["mixer"])
            return
        if kind == "rec":
            self.rec = rec_mod.RGLRU(params["rec"])
        else:
            self.attn = attn_mod.MLA(params["attn"]) \
                if cfg.attn_kind == "mla" else attn_mod.GQA(params["attn"])
        if kind == "dec_attn":
            self.ln_cross = RMSNorm(params["ln_cross"])
            self.cross = attn_mod.GQA(params["cross"])
        self.ln2 = RMSNorm(params["ln2"])
        self.ffn = MoE(params["ffn"], cfg) if kind == "moe" \
            else FFN(params["ffn"], cfg)


def _recurrent_apply(block: Block, cfg, kind: str, h, *, mode: str, cache):
    """The mixer of an ``ssm`` or ``rec`` block: (y, new state).  Without
    a cache the full-sequence path; with one, ``decode`` steps the state
    one token and any other mode (prefill) returns the prompt's end
    state, as the reference's ``block_apply`` does."""
    if kind == "ssm":
        layer, apply, decode = block.mixer, rec_mod.mamba2_apply, \
            rec_mod.mamba2_decode
    else:
        layer, apply, decode = block.rec, rec_mod.rglru_apply, \
            rec_mod.rglru_decode
    if cache is None:
        return apply(layer, cfg, h), None
    if mode == "decode":
        y, state = decode(layer, cfg, cache, h[:, 0, :])
        return y[:, None, :], state
    return apply(layer, cfg, h, return_state=True)


def _cross_apply(block: Block, cfg, x, cache, enc_out):
    """A ``dec_attn`` block's cross-attention residual: against the kept
    ``ck``/``cv`` of its cache, else against ``enc_out``."""
    hc = block.ln_cross(x)
    if cache is not None and "ck" in cache:
        return x + attn_mod.cross_attend_cached(block.cross, cfg, hc,
                                                cache["ck"], cache["cv"])
    if enc_out is None:
        # the reference cross-attends to the layer's own input here
        raise ValueError("a dec_attn layer needs its cross cache (ck, cv) "
                         "or the encoder's output (enc_out)")
    y, _ = attn_mod.gqa_apply(block.cross, cfg, hc, None, mode="cross",
                              kv_x=enc_out)
    return x + y


def block_apply(block: Block, cfg, kind: str, x, positions, *,
                mode: str = "train", shape_kind: str = "train", cache=None,
                enc_out=None):
    """One residual block.  Returns (x, new_cache, aux); ``aux`` holds an
    MoE block's routing terms.  A ``dec_attn`` block's cache is
    ``{"self", "ck", "cv"}`` (or its self-attention cache alone, with
    ``enc_out``)."""
    h = block.ln1(x)
    if kind in ("ssm", "rec"):
        y, new_cache = _recurrent_apply(block, cfg, kind, h, mode=mode,
                                        cache=cache)
        if kind == "ssm":
            return x + y, new_cache, {}
        x = x + y
    else:
        window = _effective_window(cfg, kind, shape_kind)
        crossed = isinstance(cache, dict) and "ck" in cache
        y, new_cache = _attn_apply(
            block.attn, cfg, h, positions,
            mode="full" if kind == "enc_attn" else "causal",
            cache=cache["self"] if crossed else cache, window=window)
        x = x + y
        if kind == "dec_attn":
            x = _cross_apply(block, cfg, x, cache, enc_out)
            if crossed:
                new_cache = {"self": new_cache, "ck": cache["ck"],
                             "cv": cache["cv"]}
    h2 = block.ln2(x)
    if kind == "moe":
        y2, aux = moe_apply(block.ffn, cfg, h2, dropless=mode != "train")
    else:
        y2, aux = ffn_apply(block.ffn, cfg, h2), {}
    return x + y2, new_cache, aux


def init_block_cache(cfg, kind: str, batch: int, s_max: int,
                     shape_kind: str = "decode", device="cuda", paging=None,
                     enc_len: int = 0):
    """``paging``: an :class:`attn_mod.PageGeometry` — full-attention KV
    caches become shared page pools addressed per slot through block
    tables.  Windowed layers keep their dense rings (already O(window)
    residency), recurrent states are position-free: per slot, in any
    layout, and a ``dec_attn`` layer's self cache is never paged.  With
    ``enc_len`` a ``dec_attn`` layer's cache is ``{"self", "ck", "cv"}``,
    the cross keys and values zeros of (batch, enc_len, Hkv, Dh) in
    ``cfg.dtype``, filled by ``LanguageModel.prefill``."""
    _check_kind(kind)
    if kind == "ssm":
        return rec_mod.init_mamba2_state(cfg, batch, device=device)
    if kind == "rec":
        return rec_mod.init_rglru_state(cfg, batch, device=device)
    window = _effective_window(cfg, kind, shape_kind)
    paged = paging is not None and not window and kind != "dec_attn"
    if cfg.attn_kind == "mla":
        if paged:
            return attn_mod.init_mla_paged_cache(cfg, batch, paging,
                                                 device=device)
        return attn_mod.init_mla_cache(cfg, batch, s_max, window,
                                       device=device)
    if paged:
        return attn_mod.init_gqa_paged_cache(cfg, batch, paging,
                                             device=device)
    cache = attn_mod.init_gqa_cache(cfg, batch, s_max, window, device=device)
    if kind == "dec_attn" and enc_len:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
        dt = getattr(torch, cfg.dtype)
        cache = {"self": cache,
                 "ck": torch.zeros(shape, dtype=dt, device=device),
                 "cv": torch.zeros(shape, dtype=dt, device=device)}
    return cache


_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
                   torch.ops.aten.mv.default, torch.ops.aten.addmv.default,
                   torch.ops.aten.dot.default))


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy of ``"dots"``: keep a matrix
    product's output, recompute anything else."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg, fn):
    """``fn`` under ``cfg.remat`` while gradients are recorded (the
    module's note): ``"full"`` keeps only each period's input and
    recomputes the rest in the backward; ``"dots"`` also keeps the matrix
    products' outputs."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        context = functools.partial(create_selective_checkpoint_contexts,
                                    _dots_policy)
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        context_fn=context)
    raise ValueError(f"unknown remat {cfg.remat!r}")


def stack_apply(layers, cfg, x, positions, *, mode: str = "train",
                shape_kind: str = "train",
                caches: Optional[List[Dict[str, Any]]] = None, enc_out=None):
    """Run every layer in order.  Returns (x, new_caches, aux_sums):
    ``aux_sums`` holds ``load_balance`` and ``router_z`` summed over the
    MoE layers, in layer order, as the reference sums them (never
    averaged), and without caches, where the stack has MoE layers,
    ``expert_fraction``: each MoE layer's, stacked ``(layers, E)``,
    without gradient.  ``caches`` is one cache
    per layer (or None).  Without caches, each repeat of ``layer_pattern``
    after the prefix runs under ``cfg.remat`` (the reference's scanned
    period body).  ``enc_out``: the encoder's output, which the
    ``dec_attn`` layers without a cross cache attend to."""
    keys = ("load_balance", "router_z")
    new_caches = [] if caches is not None else None
    n_prefix, period = len(cfg.prefix_pattern), len(cfg.layer_pattern)

    def add(sums, aux):
        return tuple(a + aux[k] if k in aux else a
                     for a, k in zip(sums, keys))

    def run(lo, hi):
        def body(x, *sums):
            fracs = []
            for i in range(lo, hi):
                x, _, aux = block_apply(layers[i], cfg, layers[i].kind, x,
                                        positions, mode=mode,
                                        shape_kind=shape_kind,
                                        enc_out=enc_out)
                sums = add(sums, aux)
                if "expert_fraction" in aux:
                    fracs.append(aux["expert_fraction"].detach())
            return (x, *sums, *fracs)
        return body

    sums = tuple(torch.zeros((), device=x.device) for _ in keys)
    if caches is None:
        fracs = []
        x, *out = run(0, n_prefix)(x, *sums)
        sums, fracs = out[:len(keys)], fracs + out[len(keys):]
        for lo in range(n_prefix, len(layers), period):
            x, *out = _remat(cfg, run(lo, lo + period))(x, *sums)
            sums, fracs = out[:len(keys)], fracs + out[len(keys):]
        aux = dict(zip(keys, sums))
        if fracs:
            aux["expert_fraction"] = torch.stack(fracs)
        return x, None, aux
    for i, block in enumerate(layers):
        x, new_cache, aux = block_apply(
            block, cfg, block.kind, x, positions, mode=mode,
            shape_kind=shape_kind, cache=caches[i], enc_out=enc_out)
        sums = add(sums, aux)
        new_caches.append(new_cache)
    return x, new_caches, dict(zip(keys, sums))
