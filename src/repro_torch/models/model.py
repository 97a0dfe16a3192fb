"""LanguageModel: the public model API over the layer stack.

The PyTorch counterpart of ``repro.models.model``.  Families
(``cfg.family``):

* decoder-only text (dense, MoE, SSM, hybrid): ``batch = {tokens,
  labels}``;
* ``vlm``: + ``patch_embeds (B, frontend_tokens, d_frontend)`` — the ViT
  frontend is a stub (precomputed patch embeddings); patches are
  projected (``frontend_proj``) and prepended to the text, and the loss
  skips their positions;
* ``audio``: encoder-decoder — + ``frames (B, S, d_frontend)``, the
  (stubbed) speech frontend's output, projected and run through the
  encoder stack; every decoder layer cross-attends to its output.

A :class:`LanguageModel` holds its parameters (the reference passes a
parameter tree to every call):

* ``spec()`` / ``init(generator)`` — the parameter spec and a tree of
  tensors drawn from it (also :func:`model_spec` / :func:`init_params`,
  which need no model); ``n_params()``.
* ``forward(batch)``                — logits for a full sequence.
* ``loss(batch)``                   — masked CE plus the MoE load-balance
  and router-z terms and the multi-token-prediction (MTP) loss, with the
  reference's coefficients; differentiable once the parameters take
  gradients (``requires_grad_(True)``).
* ``tensors()``                     — every parameter and buffer by name.
* ``prefill(batch, s_max)``         — last-position logits + filled caches
  (a decoder layer's cache also holds its cross keys and values).
* ``decode_step(caches, tokens)``   — one token; the serving step.

Parameter tree (the port's layout)::

    {"embed": {"table"}, "final_norm": {"scale"},
     "layers": [block tree, one per layer], ["lm_head": {"kernel"}],
     ["frontend_proj": {"kernel"}],
     ["encoder": [block tree, one per encoder layer], "enc_norm"],
     ["mtp": {"proj", "norm_h", "norm_e", "block"}]}

:func:`params_from_numpy` builds it from the reference's tree, which stacks
the body layers (the encoder's too) on a leading axis;
:func:`reference_layout` and :func:`port_layout` carry any tree of
per-tensor leaves (parameters, optimizer moments) between ``tensors()``'s
names and that layout, for checkpoints both packages read; a recurrent
layer's subtree (``mixer`` for ``ssm``, ``rec`` for ``rec``) and a decoder
layer's ``ln_cross`` and ``cross`` ride along as any other.

Tensor-parallel training (``models.shardlib``): the embedding and an
untied head are vocabulary-parallel (each rank holds ``padded_vocab / n``
rows of the table, or columns of the head): a lookup sums the ranks'
lookups of the tokens each holds, the logits are this rank's vocabulary
columns with the padding masked at its global indices, and the CE takes
the row maximum, the sum of exponentials and the target's logit each
over the ranks (``all_reduce`` over ``model``).
:meth:`LanguageModel.tensor_parallel_plan` gives each unit's mode and
each leaf's gather.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from repro_torch.core.formats import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import shardlib
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import _NEG
from repro_torch.models.layers import (Dense, Embed, RMSNorm, dense_spec,
                                       embed_spec, rmsnorm_spec,
                                       rope_positions)
from repro_torch.models.spec import count_params, init_from_spec, \
    meta_from_spec
from repro_torch.sharding import layout

__all__ = ["LanguageModel", "model_spec", "init_params", "params_from_numpy",
           "reference_layout", "port_layout"]

# the loss's coefficients, the reference's
_MTP_WEIGHT = 0.3
_LB_COEF = 0.01
_Z_COEF = 1e-4


def encoder_cfg(cfg):
    """The encoder stack's config: ``cfg.n_enc_layers`` ``enc_attn``
    layers, no prefix."""
    return dataclasses.replace(cfg, layer_pattern=("enc_attn",),
                               prefix_pattern=(), n_layers=cfg.n_enc_layers)


def model_spec(cfg) -> Dict[str, Any]:
    """The parameter spec of the whole model, in the port's layout."""
    spec: Dict[str, Any] = {
        # 1/sqrt(d) embedding init keeps tied-head logits O(1); rows padded
        # to cfg.padded_vocab (logits past cfg.vocab are masked)
        "embed": embed_spec(cfg.padded_vocab, cfg.d_model,
                            scale=cfg.d_model ** -0.5),
        "final_norm": rmsnorm_spec(cfg.d_model),
        "layers": tfm.stack_spec(cfg),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = dense_spec(cfg.d_model, cfg.padded_vocab,
                                     ("embed", "vocab"))
    if cfg.enc_dec:
        spec["encoder"] = tfm.stack_spec(encoder_cfg(cfg))
        spec["enc_norm"] = rmsnorm_spec(cfg.d_model)
    if cfg.frontend != "none" or cfg.enc_dec:
        spec["frontend_proj"] = dense_spec(cfg.d_frontend, cfg.d_model,
                                           ("frontend", "embed"))
    if cfg.mtp_depth:
        spec["mtp"] = {
            "proj": dense_spec(2 * cfg.d_model, cfg.d_model,
                               ("embed", "embed2")),
            "norm_h": rmsnorm_spec(cfg.d_model),
            "norm_e": rmsnorm_spec(cfg.d_model),
            "block": tfm.block_spec(cfg, "attn"),
        }
    return spec


def init_params(cfg, generator: torch.Generator):
    """A parameter tree for ``cfg`` drawn from ``generator``, on its
    device, in ``cfg.param_dtype``."""
    return init_from_spec(model_spec(cfg), generator,
                          dtype=getattr(torch, cfg.param_dtype),
                          device=generator.device)


class LanguageModel(nn.Module):
    """An LM holding its parameters (the encoder's too, for ``enc_dec``).

    ``params``: a parameter tree (see the module's note), e.g. from
    :func:`params_from_numpy`; its tensors are used as they are, on their
    device.  Without one, parameters are drawn from ``init`` with a
    generator seeded ``seed`` on ``device``; on ``"meta"`` they are shapes
    alone, nothing drawn (the dry run, ``launch/dryrun.py``).
    """

    def __init__(self, cfg, params=None, *, device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.dtype)
        if params is None:
            dev = resolve_device(device)
            if dev.type == "meta":
                params = meta_from_spec(model_spec(cfg),
                                        getattr(torch, cfg.param_dtype))
            else:
                gen = torch.Generator(device=dev)
                params = init_params(cfg, gen.manual_seed(seed))
        self.embed = Embed(params["embed"])
        self.final_norm = RMSNorm(params["final_norm"])
        self.layers = nn.ModuleList(
            tfm.Block(p, cfg, kind)
            for p, kind in zip(params["layers"], tfm.layer_kinds(cfg),
                               strict=True))
        self.lm_head = None if cfg.tie_embeddings else Dense(params["lm_head"])
        self.frontend_proj = Dense(params["frontend_proj"]) \
            if "frontend_proj" in params else None
        self.encoder = self.enc_norm = None
        if cfg.enc_dec:
            self.encoder = nn.ModuleList(
                tfm.Block(p, cfg, "enc_attn") for p in params["encoder"])
            self.enc_norm = RMSNorm(params["enc_norm"])
        self.mtp = MTP(params["mtp"], cfg) if cfg.mtp_depth else None

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    # ------------------------------------------------------------------ spec
    def spec(self) -> Dict[str, Any]:
        return model_spec(self.cfg)

    def init(self, generator: torch.Generator):
        """A parameter tree drawn from ``generator``, on its device."""
        return init_params(self.cfg, generator)

    def n_params(self) -> int:
        return count_params(self.spec())

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: routed top-k + shared only)."""
        cfg = self.cfg
        if not cfg.moe.n_experts:
            return self.n_params()
        m = cfg.moe
        per_expert = 3 * cfg.d_model * m.d_ff_expert
        n_moe_layers = sum(k == "moe" for k in tfm.layer_kinds(cfg))
        return self.n_params() - n_moe_layers * (m.n_experts - m.top_k) \
            * per_expert

    # ------------------------------------------------------------- embedding
    def _vocab_view(self, module):
        """The tensor-parallel view when ``module`` (the embedding or the
        head) is vocabulary-parallel, else None."""
        tp = shardlib.unit(module)
        return None if tp is None else tp[0]

    def _head(self):
        return self.embed if self.lm_head is None else self.lm_head

    def _embed_sequence(self, batch):
        """The decoder's input: the tokens' embeddings, after the projected
        patches for ``vlm``."""
        x = self.embed.lookup(batch["tokens"], self.compute_dtype,
                              self._vocab_view(self.embed))
        if self.cfg.frontend == "vision":
            patches = self.frontend_proj(
                batch["patch_embeds"].to(x.device, self.compute_dtype))
            x = torch.cat([patches, x], dim=1)
        return x

    def _encode(self, frames):
        """The encoder's output: projected frames through the encoder stack
        (every position sees every other; train mode, as the reference
        runs it), then ``enc_norm``."""
        h = self.frontend_proj(frames.to(self.device, self.compute_dtype))
        pos = rope_positions(h.shape[0], h.shape[1], device=h.device)
        h, _, _ = tfm.stack_apply(self.encoder, encoder_cfg(self.cfg), h,
                                  pos, mode="train", shape_kind="train")
        return self.enc_norm(h)

    def _logits(self, h):
        """The logits of ``h``; vocabulary-parallel, this rank's columns
        (the padding masked at its global indices)."""
        view = self._vocab_view(self._head())
        lo = 0
        if view is None:
            logits = self.embed.logits(h) if self.lm_head is None \
                else self.lm_head(h)
        elif self.lm_head is None:
            logits = self.embed.logits(layout.copy_in(h, view.mesh,
                                                      view.mesh_dim))
            lo = view.rank * logits.shape[-1]
        else:
            logits = self.lm_head.column(h, view)
            lo = view.rank * logits.shape[-1]
        first_pad = self.cfg.vocab - lo
        if first_pad < logits.shape[-1]:
            logits[..., max(first_pad, 0):] = _NEG      # padding rows out
        return logits

    # ---------------------------------------------------------------- forward
    def forward(self, batch, *, shape_kind: str = "train", mode: str = "eval"):
        """Full-sequence forward: (logits, final hidden, aux)."""
        enc_out = self._encode(batch["frames"]) if self.cfg.enc_dec \
            else None
        x = self._embed_sequence(batch)
        pos = rope_positions(x.shape[0], x.shape[1], device=x.device)
        x, _, aux = tfm.stack_apply(self.layers, self.cfg, x, pos, mode=mode,
                                    shape_kind=shape_kind, enc_out=enc_out)
        h = self.final_norm(x)
        return self._logits(h), h, aux

    # ------------------------------------------------------------------ loss
    def loss(self, batch, *, shape_kind: str = "train", token_totals=None):
        """(loss, metrics): masked CE (``batch["labels"][t]`` is the token
        after position ``t``; labels below 0 are masked out), plus for MoE
        models ``_LB_COEF`` · load-balance + ``_Z_COEF`` · router-z (summed
        over the MoE layers) and with MTP ``_MTP_WEIGHT`` · the MTP loss.
        For ``vlm`` the patches' positions carry no label.  Metrics:
        ``ce``, ``load_balance`` and ``mtp`` where they apply, ``loss``.

        ``token_totals`` (:meth:`token_totals` of a larger batch that this
        one is a part of) divides each CE's sum by that batch's labelled
        positions instead of this one's: the parts' losses then sum to the
        whole batch's (sharded training's token-weighted mean)."""
        cfg = self.cfg
        totals = token_totals or {}
        logits, h, aux = self.forward(batch, shape_kind=shape_kind,
                                      mode="train")
        labels = _ce_labels(cfg, batch["labels"].to(logits.device))
        loss = _masked_ce(logits, labels, totals.get("ce"),
                          self._vocab_view(self._head()))
        metrics = {"ce": loss}
        if cfg.moe.n_experts:
            loss = loss + _LB_COEF * aux["load_balance"] \
                + _Z_COEF * aux["router_z"]
            metrics["load_balance"] = aux["load_balance"]
        if cfg.mtp_depth:
            mtp_loss = self._mtp_loss(h, batch, totals.get("mtp"))
            loss = loss + _MTP_WEIGHT * mtp_loss
            metrics["mtp"] = mtp_loss
        metrics["loss"] = loss
        return loss, metrics

    def token_totals(self, batch):
        """The labelled positions of ``batch`` that each CE term divides
        by: ``{"ce"}``, and ``"mtp"`` with MTP (floats, at least 1)."""
        labels = torch.as_tensor(batch["labels"])
        # the step's one host read; the dry run's meta labels have no
        # values: every text position counts, as the data stream labels
        # them all (a vlm's patch positions never are)
        meta = labels.is_meta
        parts = {"ce": labels if meta else _ce_labels(self.cfg, labels)}
        if self.cfg.mtp_depth:
            parts["mtp"] = labels[:, 1:]
        return {k: max(float(t.numel() if meta else (t >= 0).sum()), 1.0)
                for k, t in parts.items()}

    def _mtp_loss(self, h, batch, total=None):
        """DeepSeek-V3 multi-token prediction (depth 1): predict token
        t+2 from [norm(h_t); norm(emb(tok_{t+1}))] through one extra
        ``attn`` block, the main model's final norm and head.  Zero for
        ``vlm``, as the reference's."""
        if self.cfg.frontend == "vision":
            return torch.zeros((), device=h.device)
        mtp = self.mtp
        tokens, labels = batch["tokens"], batch["labels"]
        emb_next = self.embed.lookup(tokens[:, 1:], self.compute_dtype,
                                     self._vocab_view(self.embed))
        merged = mtp.proj(torch.cat([mtp.norm_h(h[:, :-1, :]),
                                     mtp.norm_e(emb_next)], dim=-1))
        pos = rope_positions(merged.shape[0], merged.shape[1],
                             device=merged.device)
        out, _, _ = tfm.block_apply(mtp.block, self.cfg, "attn", merged, pos,
                                    mode="train")
        logits = self._logits(self.final_norm(out))
        # the target at merged position t is labels[t+1] (the t+2 token)
        return _masked_ce(logits, labels[:, 1:], total,
                          self._vocab_view(self._head()))

    def blocks(self):
        """``(key prefix, Block)`` of every residual block: the decoder's
        layers, the encoder's and the MTP module's."""
        out = [(f"layers/{i}", b) for i, b in enumerate(self.layers)]
        if self.encoder is not None:
            out += [(f"encoder/{i}", b) for i, b in enumerate(self.encoder)]
        if self.mtp is not None:
            out.append(("mtp/block", self.mtp.block))
        return out

    def tensor_parallel_plan(self, view, serving: bool = False):
        """``(modes, classes)`` of tensor-parallel training (or, with
        ``serving``, of a serving step) on ``view`` (the partitioner's
        ``TensorParallelView``): each unit's mode by ``id(module)`` and
        each leaf's gather by key (``split`` / ``whole`` / ``local``;
        ``models.transformer.block_tp_plan``).  The attention mode is
        ``cfg.attn_shard_mode``, ``"none"`` resolved by divisibility."""
        attn_mode = shardlib.attn_mode_for(self.cfg, view.size)
        modes: Dict[int, str] = {}
        classes: Dict[str, str] = {}
        if view.cuts.get("embed/table") == 0:
            modes[id(self.embed)] = "vocab"
            classes["embed/table"] = "split"
        if self.lm_head is not None \
                and view.cuts.get("lm_head/kernel") == 1:
            modes[id(self.lm_head)] = "vocab"
            classes["lm_head/kernel"] = "split"
        for prefix, block in self.blocks():
            tfm.block_tp_plan(block, view, prefix, attn_mode, modes,
                              classes, serving)
        return modes, classes

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every parameter and buffer, keyed by its path in the parameter
        tree (``"layers/0/ffn/w_out/values2d"``); the tensors themselves."""
        named = list(self.named_parameters()) + list(self.named_buffers())
        return {name.replace(".", "/"): t for name, t in named}

    # -------------------------------------------------------------- serving
    def init_cache(self, batch_size: int, s_max: int, *,
                   shape_kind: str = "decode", enc_len: int = 0,
                   paging=None, device=None) -> List[Dict[str, Any]]:
        """One cache per layer: KV (dense slab, ring or pages) for
        attention, the recurrent state for ``ssm`` and ``rec``, and with
        ``enc_len`` ``{"self", "ck", "cv"}`` for ``dec_attn`` (cross keys
        and values zeros until :meth:`prefill` fills them).  ``paging``:
        optional :class:`~repro_torch.models.attention.PageGeometry` —
        full-attention layers get paged (page-pool + block-table) caches
        instead of dense per-slot slabs.  ``device``: the model's by
        default (``"meta"``: the shapes alone)."""
        dev = self.device if device is None else device
        return [tfm.init_block_cache(self.cfg, block.kind, batch_size, s_max,
                                     shape_kind, device=dev,
                                     paging=paging, enc_len=enc_len)
                for block in self.layers]

    def prefill(self, batch, s_max: int, *, shape_kind: str = "prefill",
                caches=None):
        """Run the prompt (after its patches, for ``vlm``) through the
        stack, filling fresh caches (``caches``: fresh ones given, at
        index 0 — a mesh step's local slices); for ``enc_dec`` the frames
        through the encoder first, and each decoder layer's cross keys
        and values from its output.  Returns (last-position logits
        (B, 1, V), caches)."""
        enc_out, enc_len = None, 0
        if self.cfg.enc_dec:
            enc_out = self._encode(batch["frames"])
            enc_len = enc_out.shape[1]
        x = self._embed_sequence(batch)
        if caches is None:
            caches = self.init_cache(x.shape[0], s_max,
                                     shape_kind=shape_kind, enc_len=enc_len)
        if enc_out is not None:
            caches = self._fill_cross_caches(caches, enc_out)
        pos = rope_positions(x.shape[0], x.shape[1], device=x.device)
        x, caches, _ = tfm.stack_apply(self.layers, self.cfg, x, pos,
                                       mode="prefill", shape_kind=shape_kind,
                                       caches=caches, enc_out=enc_out)
        h = self.final_norm(x)
        return self._logits(h[:, -1:, :]), caches

    def _fill_cross_caches(self, caches, enc_out):
        """Each decoder layer's cache with its cross keys and values made
        from ``enc_out`` (``attention.make_cross_cache``, one layer at a
        time where the reference maps over the stacked body); other
        caches as they are."""
        out = []
        for block, cache in zip(self.layers, caches, strict=True):
            if isinstance(cache, dict) and "ck" in cache:
                with shardlib.gathered(block):
                    ck, cv = attn_mod.make_cross_cache(block.cross,
                                                       self.cfg, enc_out)
                cache = {"self": cache["self"], "ck": ck.to(cache["ck"].dtype),
                         "cv": cv.to(cache["cv"].dtype)}
            out.append(cache)
        return out

    def decode_step(self, caches, tokens, *, shape_kind: str = "decode"):
        """One-token serve step. tokens: (B, 1). Returns (logits, caches);
        the caches' kv tensors are written in place."""
        x = self.embed.lookup(tokens, self.compute_dtype,
                              self._vocab_view(self.embed))
        index = _cache_index(caches)               # (B,) per-slot positions
        pos = index[:, None].expand(tokens.shape).to(torch.int32)
        x, caches, _ = tfm.stack_apply(self.layers, self.cfg, x, pos,
                                       mode="decode", shape_kind=shape_kind,
                                       caches=caches)
        return self._logits(self.final_norm(x)), caches


def _ce_labels(cfg, labels):
    """The labels of every position the decoder sees: for ``vlm`` the
    patches' positions first, unlabelled (-1)."""
    if cfg.frontend == "vision":
        pad = labels.new_full((labels.shape[0], cfg.frontend_tokens), -1)
        labels = torch.cat([pad, labels], dim=1)
    return labels


def _masked_ce(logits, labels, total=None, view=None):
    """Cross-entropy over positions with label >= 0, in float32: predicts
    ``labels[t]`` from position ``t``.  The sum is divided by ``total``
    when given, else by the labelled positions here.  With ``view``
    (vocabulary-parallel) ``logits`` are this rank's columns: the row
    maximum, the sum of exponentials and the target's logit are each
    taken over the ``model`` ranks."""
    mask = (labels >= 0).float()
    safe = labels.clamp_min(0).long()
    logits32 = logits.float()
    if view is None:
        logz = torch.logsumexp(logits32, dim=-1)
        gold = logits32.gather(-1, safe[..., None])[..., 0]
    else:
        cols = logits32.shape[-1]
        top = layout.all_reduce_max(logits32.amax(-1), view.mesh,
                                    view.mesh_dim)
        local = safe - view.rank * cols
        held = (local >= 0) & (local < cols)
        mine = logits32.gather(-1, local.clamp(0, cols - 1)[..., None])
        sums = layout.reduce_out(torch.stack([
            torch.exp(logits32 - top[..., None]).sum(-1),
            mine[..., 0] * held]), view.mesh, view.mesh_dim)
        logz = torch.log(sums[0]) + top
        gold = sums[1]
    nll = (logz - gold) * mask
    if total is not None:
        return nll.sum() / total
    return nll.sum() / mask.sum().clamp_min(1.0)


class MTP(nn.Module):
    """The multi-token-prediction module: ``proj`` (2·d → d), ``norm_h``,
    ``norm_e`` and one ``attn`` block."""

    def __init__(self, params, cfg):
        super().__init__()
        self.proj = Dense(params["proj"])
        self.norm_h = RMSNorm(params["norm_h"])
        self.norm_e = RMSNorm(params["norm_e"])
        self.block = tfm.Block(params["block"], cfg, "attn")


def _cache_index(caches):
    """The first ``index`` (B,) among the layers' caches (a decoder
    layer's is its ``self`` cache's): all layers advance in lockstep.  A
    stack with none (every layer recurrent, as mamba2's) reads no
    position: zeros, as the reference's."""
    for cache in caches:
        if isinstance(cache, dict):
            if "index" in cache:
                return cache["index"]
            if "index" in cache.get("self", ()):
                return cache["self"]["index"]
    state = next(iter(caches[0].values()))
    return torch.zeros((state.shape[0],), dtype=torch.int32,
                       device=state.device)


# ---------------------------------------------------------------------------
# weights carried across from the reference
# ---------------------------------------------------------------------------


def _tensors(node, device, pick=lambda a: a):
    if isinstance(node, dict):
        return {k: _tensors(v, device, pick) for k, v in node.items()}
    arr = np.array(pick(np.asarray(node)))       # a writable copy
    return torch.from_numpy(arr).to(device)


def _unstack(cfg, stack, dev):
    """One tree per layer of a stack of the reference's tree (``{"prefix",
    "body"}``, each body leaf stacked on a leading axis of
    ``cfg.pattern_repeats``), in its scan order."""
    layers = [_tensors(stack["prefix"][f"{i}_{kind}"], dev)
              for i, kind in enumerate(cfg.prefix_pattern)]
    for r in range(cfg.pattern_repeats):
        for i, kind in enumerate(cfg.layer_pattern):
            layers.append(_tensors(stack["body"][f"{i}_{kind}"], dev,
                                   lambda a, r=r: a[r]))
    return layers


def params_from_numpy(cfg, tree, *, device="cuda"):
    """The port's parameter tree from the reference's, as
    ``LanguageModel.init`` returns it and ``jax.device_get`` brings it to
    numpy: ``{"embed", "final_norm", "stack": {"prefix", "body"}}`` (and
    ``encoder`` of the same form, ``enc_norm``, ``frontend_proj``,
    ``lm_head``, ``mtp`` where the config has them), with each body
    layer's arrays stacked on a leading axis of ``cfg.pattern_repeats``.
    The only change of layout in the port: each stack's body is unstacked
    into one tree per layer, in the reference's scan order (repeat-major,
    then pattern position).  Dense kernels keep the reference's ``(d_in,
    d_out)`` layout, and the MTP subtree and the MoE router's bias keep
    their places."""
    dev = resolve_device(device)
    want = set(model_spec(cfg)) - {"layers"} | {"stack"}
    if set(tree) != want:
        raise ValueError(f"{cfg.name}: the reference's tree holds "
                         f"{sorted(tree)}, the config asks for "
                         f"{sorted(want)}")
    out = {k: _tensors(v, dev) for k, v in tree.items()
           if k not in ("stack", "encoder")}
    out["layers"] = _unstack(cfg, tree["stack"], dev)
    if cfg.enc_dec:
        out["encoder"] = _unstack(encoder_cfg(cfg), tree["encoder"], dev)
    return out


def _stacks(cfg):
    """Each layer stack: (its key in the port's tree, its key in the
    reference's, its config)."""
    out = [("layers", "stack", cfg)]
    if cfg.enc_dec:
        out.append(("encoder", "encoder", encoder_cfg(cfg)))
    return out


def _layer_places(cfg, root: str = "stack"):
    """Each layer's place in the reference's tree under ``root``: (path,
    body repeat or None for a prefix layer), in layer order."""
    places = [((root, "prefix", f"{i}_{kind}"), None)
              for i, kind in enumerate(cfg.prefix_pattern)]
    for r in range(cfg.pattern_repeats):
        for i, kind in enumerate(cfg.layer_pattern):
            places.append(((root, "body", f"{i}_{kind}"), r))
    return places


def _put(tree, path, leaf):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def _np_stack(leaves):
    """One stacked leaf from the body layers' leaves; a leaf that is 0-d
    in every layer stays one 0-d leaf."""
    return leaves[0] if np.ndim(leaves[0]) == 0 else np.stack(leaves)


def _np_pick(node, r):
    """Body repeat ``r``'s leaf of a stacked leaf (a 0-d leaf is every
    layer's; ``r`` None: a prefix layer's own leaf)."""
    return node if r is None or np.ndim(node) == 0 else node[r]


def reference_layout(cfg, flat: Dict[str, Any], stack=_np_stack
                     ) -> Dict[str, Any]:
    """The reference's tree from numpy leaves keyed like
    :meth:`LanguageModel.tensors` (a deeper key — ``".../kernel/vr"`` —
    is a subtree of that tensor's place).  Body layers are stacked on a
    leading axis by ``stack`` (a list of the layers' leaves → one leaf);
    by default a leaf that is 0-d in every body layer (an optimizer's zero
    for an integer buffer) stays one 0-d leaf, as the reference's
    optimizer makes it for the stacked buffer."""
    places = {port: _layer_places(scfg, ref)
              for port, ref, scfg in _stacks(cfg)}
    tree: Dict[str, Any] = {}
    stacked: Dict[tuple, Dict[int, Any]] = {}
    for key, leaf in flat.items():
        parts = tuple(key.split("/"))
        if parts[0] not in places:
            _put(tree, parts, leaf)
            continue
        path, r = places[parts[0]][int(parts[1])]
        if r is None:
            _put(tree, path + parts[2:], leaf)
        else:
            stacked.setdefault(path + parts[2:], {})[r] = leaf
    for path, per in stacked.items():
        _put(tree, path, stack([per[r] for r in range(len(per))]))
    return tree


def port_layout(cfg, tree, pick=_np_pick) -> Dict[str, Any]:
    """The inverse of :func:`reference_layout`: leaves keyed like
    :meth:`LanguageModel.tensors`, the body unstacked by ``pick(leaf,
    repeat)``."""
    where = {}
    for port, ref, scfg in _stacks(cfg):
        for layer, (path, r) in enumerate(_layer_places(scfg, ref)):
            where.setdefault(path, []).append((port, layer, r))
    roots = {ref for _, ref, _ in _stacks(cfg)}
    flat: Dict[str, Any] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        if path[0] not in roots:
            flat["/".join(path)] = node
            return
        for port, layer, r in where[path[:3]]:
            flat["/".join((port, str(layer)) + path[3:])] = pick(node, r)

    walk(tree, ())
    return flat
