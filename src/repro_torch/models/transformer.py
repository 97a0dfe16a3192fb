"""Residual blocks and the layer stack.

The PyTorch counterpart of ``repro.models.transformer`` for attention
blocks.  The layer list is ``prefix_pattern`` followed by ``layer_pattern``
repeated ``pattern_repeats`` times — the reference's order — and the port
holds one :class:`Block` module per layer, run by a plain loop
(:func:`stack_apply`), where the reference stacks each pattern position's
parameters on a leading axis and scans over them.

Kinds ported: ``attn`` (global GQA attention + FFN) and ``attn_local``
(sliding-window GQA + FFN).  The others raise ``NotImplementedError``
naming their ROADMAP item; so does ``attn_kind="mla"``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models.ffn import FFN, ffn_apply, ffn_spec
from repro_torch.models.layers import RMSNorm, rmsnorm_spec

__all__ = ["layer_kinds", "block_spec", "block_apply", "stack_spec",
           "stack_apply", "init_block_cache", "Block"]

# Layer kinds that are not ported yet, and the ROADMAP item that brings them.
_LM_ITEM = "ROADMAP queue 1, item 1: the other LM families"
_NOT_PORTED = {
    "moe": "the MoE family",
    "ssm": "the Mamba-2 / SSM family",
    "rec": "the RG-LRU recurrent family",
    "enc_attn": "the encoder-decoder family",
    "dec_attn": "the encoder-decoder family",
}
_KINDS = ("attn", "attn_local")


def _check_kind(cfg, kind: str) -> None:
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet: {_NOT_PORTED[kind]} "
            f"({_LM_ITEM})")
    if kind not in _KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    if cfg.attn_kind == "mla":
        raise NotImplementedError(
            "attn_kind 'mla' is not ported yet: multi-head latent "
            f"attention ({_LM_ITEM})")


def layer_kinds(cfg) -> List[str]:
    """Every layer's kind, in the reference's order: the prefix, then the
    pattern repeated."""
    return list(cfg.prefix_pattern) + list(cfg.layer_pattern) \
        * cfg.pattern_repeats


def block_spec(cfg, kind: str):
    _check_kind(cfg, kind)
    d = cfg.d_model
    return {"ln1": rmsnorm_spec(d), "attn": attn_mod.gqa_spec(cfg),
            "ln2": rmsnorm_spec(d), "ffn": ffn_spec(cfg)}


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
    """One residual block: ``ln1``, ``attn``, ``ln2``, ``ffn``."""

    def __init__(self, params, cfg, kind: str):
        super().__init__()
        _check_kind(cfg, kind)
        self.kind = kind
        self.ln1 = RMSNorm(params["ln1"])
        self.attn = attn_mod.GQA(params["attn"])
        self.ln2 = RMSNorm(params["ln2"])
        self.ffn = FFN(params["ffn"], cfg)


def block_apply(block: Block, cfg, kind: str, x, positions, *,
                mode: str = "train", shape_kind: str = "train", cache=None):
    """One residual block.  Returns (x, new_cache, aux)."""
    h = block.ln1(x)
    window = _effective_window(cfg, kind, shape_kind)
    y, new_cache = attn_mod.gqa_apply(block.attn, cfg, h, positions,
                                      mode="causal", cache=cache,
                                      window=window)
    x = x + y
    y2 = ffn_apply(block.ffn, cfg, block.ln2(x))
    return x + y2, new_cache, {}


def init_block_cache(cfg, kind: str, batch: int, s_max: int,
                     shape_kind: str = "decode", device="cuda", paging=None):
    """``paging``: an :class:`attn_mod.PageGeometry` — full-attention KV
    caches become shared page pools addressed per slot through block
    tables.  Windowed layers keep their dense rings (already O(window)
    residency)."""
    _check_kind(cfg, kind)
    window = _effective_window(cfg, kind, shape_kind)
    if paging is not None and not window:
        return attn_mod.init_gqa_paged_cache(cfg, batch, paging,
                                             device=device)
    return attn_mod.init_gqa_cache(cfg, batch, s_max, window, device=device)


def _remat(cfg, fn):
    """``fn`` under ``cfg.remat`` while gradients are recorded: ``"full"``
    keeps only each period's input and recomputes the rest in the
    backward (``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint``)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "full":
        return lambda x: checkpoint(fn, x, use_reentrant=False)
    if cfg.remat == "dots":
        raise NotImplementedError(
            "remat 'dots' (keep the matmul outputs, recompute the rest) is "
            "not ported yet (ROADMAP queue 1, item 5: training's "
            "leftovers)")
    raise ValueError(f"unknown remat {cfg.remat!r}")


def stack_apply(layers, cfg, x, positions, *, mode: str = "train",
                shape_kind: str = "train",
                caches: Optional[List[Dict[str, Any]]] = None):
    """Run every layer in order.  Returns (x, new_caches, aux_sums);
    ``caches`` is one cache per layer (or None).  Without caches, each
    repeat of ``layer_pattern`` after the prefix runs under
    ``cfg.remat`` (the reference's scanned period body)."""
    aux_sum = {"load_balance": torch.zeros((), device=x.device),
               "router_z": torch.zeros((), device=x.device)}
    new_caches = [] if caches is not None else None
    n_prefix, period = len(cfg.prefix_pattern), len(cfg.layer_pattern)

    def run(lo, hi):
        def body(x):
            for i in range(lo, hi):
                x, _, _ = block_apply(layers[i], cfg, layers[i].kind, x,
                                      positions, mode=mode,
                                      shape_kind=shape_kind)
            return x
        return body

    if caches is None:
        x = run(0, n_prefix)(x)
        for lo in range(n_prefix, len(layers), period):
            x = _remat(cfg, run(lo, lo + period))(x)
        return x, None, aux_sum
    for i, block in enumerate(layers):
        x, new_cache, _ = block_apply(
            block, cfg, block.kind, x, positions, mode=mode,
            shape_kind=shape_kind, cache=caches[i])
        new_caches.append(new_cache)
    return x, new_caches, aux_sum
