"""Attention: grouped-query (GQA/MHA/MQA) and multi-head latent (MLA),
with dense and paged KV caches, and cross-attention.

The PyTorch counterpart of ``repro.models.attention``.
Attention is plain tensor code in the reference (no Pallas kernel), and
plain torch here but for one path; the arithmetic mirrors the
reference's — logits in float32, masked positions set to ``-1e30`` before
the softmax, probabilities cast to v's dtype — so that parity stays
tight.  The one path: a GQA decode step (one token) on a paged cache of
bf16, fp16 or fp32 with no window goes to
``kernels.paged_attention``, which reads each slot's live rows in place
(the CUDA kernel on the card, its plain version on the CPU) with the
same arithmetic, instead of gathering every slot's whole table.

Cache protocol.  **Dense** layout::

    cache = {"k": (B, S_max, H_kv, Dh), "v": ..., "index": int32[B]}

**Paged** layout — K/V live in a shared page pool and each batch slot
addresses its pages through a block table::

    cache = {"k": (n_pages, page_size, H_kv, Dh), "v": ...,
             "block_table": int32[B, pages_per_slot], "index": int32[B]}

``index`` is a per-slot vector: entry ``b`` counts the tokens already
written for slot ``b``.  Token ``t`` of slot ``b`` lives at page
``block_table[b, t // page_size]``, offset ``t % page_size``; page 0 is the
null page that free slots point at.  Windowed layers use a ring of
``window`` slots (position ``p`` at slot ``p % window``) and keep it under
paging.  With ``kv_cache_dtype="int8"`` the cache stores int8 values with
per-token/head absmax scales (``k_scale``/``v_scale``).

The reference's caches are immutable and every step returns new ones; here
:func:`_cache_write` writes the new tokens into the cache's tensors in place
(one slab or pool per layer, never copied) and returns the dict with the
advanced index.  A decode write past the end of a cache follows the
reference's out-of-range rules, which JAX applies implicitly and torch
would refuse (an ``IndexError`` on the CPU, a device assert on the card):
the block-table lookup clamps its column, and a dense one-token write
clamps its position to the slab's last row — the serving session's dense
slabs hold ``S_max + 1`` rows, so a write at ``>= S_max`` lands in a spare
row, where the reference drops it; rows ``[0, S_max)`` stay the
reference's, and only a slot past the end (whose tokens the session
discards) attends to the spare row.  The serving
session needs both: a slot that is free, or finished inside a fused
chunk, keeps decoding, and its index grows past ``S_max``.

**MLA** caches hold the normalised latent and the shared rope key instead
of per-head K/V — ``{"ckv": (B, S_max, r_kv), "krope": (B, S_max, Dr),
"index"}`` dense, or page pools ``(n_pages, page_size, r_kv / Dr)`` with
the block table — in ``cfg.dtype`` (the int8 KV path is GQA-only, as in
the reference).  The same out-of-range rules hold for their writes; a
multi-token dense write drops the positions past the slab, as JAX's
scatter does.

**Cross-attention** (the encoder-decoder family's decoder) reads keys and
values projected from the encoder's output, never roped and never
written to a self-attention cache: :func:`gqa_apply` with
``mode="cross"`` projects them at every call, and a serving decoder
keeps them per layer in ``cfg.dtype`` (:func:`make_cross_cache`, once
per request) and attends to them with :func:`cross_attend_cached`.

**Tensor-parallel training** (``models.shardlib.unit`` gives the layer a
mode; no cache): the input is copied in over ``model`` and

* ``heads``  — q, k and v are this rank's column slices: ``Hq/n`` query
  and ``Hkv/n`` kv heads (contiguous, so each query head keeps its kv
  head), and ``o`` is row-parallel (a reduce-out);
* ``repeat`` — q is this rank's ``Hq/n`` heads, k and v are whole (every
  kv head: where ``model`` cuts their weights, the products with the
  rank's columns are gathered, their gradient reduce-scattered) and each
  local query head takes its own kv head (the repeat,
  sliced); ``o`` row-parallel;
* ``seq``    — the four weights are whole: the rank computes its slice of
  the query sequence against every key, and the output is gathered along
  the sequence.

MLA follows the same pattern: ``heads`` splits the columns of ``q_up``
(or ``q_proj``), ``k_up`` and ``v_up`` and the rows of ``o``, while the
latents stay replicated, copied in where they enter the split heads; its
``repeat`` is ``heads`` (every head has its own k and v).

**Serving on a mesh** (a mode from ``shardlib.unit`` and a cache: the
serving step's, this rank's plain slice in the layout of
``Partitioner.cache_shardings``, read by ``shardlib.cache_layout``).  A
prefill (a fresh cache, index 0) writes the rank's slice of the new k/v
and attends over the in-flight k/v, rounded as the cache stores them (a
windowed prefill reads them unrounded, as on one device); a decode step
writes the rank's slice and reads the cache:

* ``heads``  — the cache is cut over kv heads: the rank's heads are its
  slice, read as they are;
* ``repeat`` — k and v are computed whole; the cache (cut over head-dim
  where ``model`` does not divide the kv heads) is gathered whole over
  ``model`` at decode and each local query head takes its kv head;
* ``seq``    — the prefill's query sequence is split as in training; at
  decode the one query is not, every rank computes the whole layer on
  the cache gathered whole;
* a cache cut over the sequence by ``data`` (``long_decode`` at batch 1)
  holds the rank's span of the slab or ring: the decode write lands on
  the rank that owns the slot, and the ranks' partial softmaxes combine
  by log-sum-exp (an ``all_reduce_max`` of the row maxima, then the
  numerators and denominators summed).

MLA's latent cache is cut over ``R`` (``ckv``, and ``krope`` where its
width divides): the rank writes its ``R`` slice, and a decode step
gathers the latents whole over ``model`` before the up-projections (a
gather, not partial scores).  A decoder's cross keys and values
(``ck``/``cv``) follow the k/v rule.  The paged pool serves on one device
only: a paged cache on a mesh raises, as does an int8 cache whose scales
are not cut as its values.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import shardlib
from repro_torch.models.layers import Dense, RMSNorm, dense_spec, rope
from repro_torch.models.shardlib import shard_attn_qkv
from repro_torch.models.spec import P
from repro_torch.sharding import layout

__all__ = ["MaskInfo", "attend", "gqa_spec", "init_gqa_cache",
           "init_gqa_paged_cache", "PageGeometry", "gqa_apply",
           "shard_attn_qkv", "GQA", "mla_spec", "init_mla_cache",
           "init_mla_paged_cache", "mla_apply", "MLA", "make_cross_cache",
           "cross_attend_cached"]

# At/above this many kv positions a multi-token attend takes the chunked
# online-softmax path — the same math with O(chunk²) live scores instead of
# O(S·T).
_FLASH_KV_THRESHOLD = 4096
_Q_CHUNK = 512
_K_CHUNK = 1024

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class PageGeometry:
    """Static shape of a paged KV cache (shared by every attention layer).

    ``n_pages`` counts the *total* pool including the reserved null page 0;
    ``pages_per_slot`` is the block-table width — the most pages one slot
    can ever address (``ceil(s_max / page_size)``).
    """
    n_pages: int
    page_size: int
    pages_per_slot: int

    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1          # page 0 is the null page

    def pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_size)


def _as_tensor(v, device):
    return v if isinstance(v, torch.Tensor) else torch.tensor(v, device=device)


@dataclasses.dataclass(frozen=True)
class MaskInfo:
    """Lazy attention-mask description: the mask is computed per block.

    ``q_offset`` and ``valid_len`` are either scalars (all slots at the
    same position) or ``(B,)`` tensors (per-slot positions); with a vector
    the masks gain a leading batch dim.
    """
    causal: bool = True
    window: Optional[int] = None
    q_offset: object = 0            # scalar or (B,)
    valid_len: object = None        # kv positions >= valid_len are masked
    kv_len: Optional[int] = None    # true kv length (for padding)

    def q_positions(self, base):
        """Absolute query positions: base (qc,) + q_offset -> (qc,) or
        (B, qc) when the offset is per-slot."""
        off = _as_tensor(self.q_offset, base.device)
        return base + (off[:, None] if off.dim() else off)

    def block(self, q_pos, k_pos):
        """q_pos: (qc,) or (B, qc); k_pos: (kc,) ->
        bool (qc, kc) or (B, qc, kc)."""
        qp = q_pos[..., :, None]
        kp = k_pos[None, :]
        m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                       dtype=torch.bool, device=k_pos.device)
        if self.causal:
            m &= kp <= qp
        if self.window is not None:
            m &= kp > qp - self.window
        if self.valid_len is not None:
            vl = _as_tensor(self.valid_len, k_pos.device)
            m &= kp < (vl[:, None, None] if vl.dim() else vl)
        if self.kv_len is not None:
            m &= kp < self.kv_len
        return m


def attend(q, k, v, mask=None, *, mask_info: Optional[MaskInfo] = None,
           scale: Optional[float] = None):
    """q: (B,S,Hq,D)  k/v: (B,T,Hkv,D|Dv).

    Pass either an explicit (S,T) / per-slot (B,S,T) bool ``mask`` or a
    :class:`MaskInfo`.  Grouped heads: Hq = G·Hkv — q is viewed as
    (B,S,Hkv,G,D) so each kv head serves G query heads without repeating
    k/v.
    """
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, d)
    scale = scale if scale is not None else d ** -0.5
    if s > 1 and t >= _FLASH_KV_THRESHOLD:
        if mask_info is None:
            raise ValueError("long-sequence attend() needs a MaskInfo "
                             "(explicit masks would materialize S×T)")
        out = _flash_attend(qg, k, v, mask_info, scale)
        return out.reshape(b, s, hq, v.shape[-1])
    if mask is None:
        dev = q.device
        mask = mask_info.block(
            mask_info.q_positions(torch.arange(s, device=dev)),
            torch.arange(t, device=dev))
    maskb = mask[None, None, None] if mask.dim() == 2 \
        else mask[:, None, None]                    # (B?,1,1,S,T)
    logits = torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float()) * scale
    logits = torch.where(maskb, logits, logits.new_full((), _NEG))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs.to(v.dtype), v)
    return out.reshape(b, s, hq, v.shape[-1])


def _flash_attend(qg, k, v, mi: MaskInfo, scale,
                  q_chunk=_Q_CHUNK, k_chunk=_K_CHUNK):
    """Exact chunked attention (the FlashAttention recurrence in plain
    torch): a loop over query chunks, an inner loop over kv chunks with the
    online (m, l, acc) softmax carry in float32.

    qg: (B,S,Hkv,G,D); k/v: (B,T,Hkv,D/Dv).
    """
    b, s, hkv, g, d = qg.shape
    t = k.shape[1]
    dv = v.shape[-1]
    dev = qg.device
    qc, kc = min(q_chunk, s), k_chunk
    s_pad, t_pad = (-s) % qc, (-t) % kc
    if t_pad and mi.kv_len is None:
        mi = dataclasses.replace(mi, kv_len=t)
    if s_pad:
        qg = torch.nn.functional.pad(qg, (0, 0, 0, 0, 0, 0, 0, s_pad))
    if t_pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, t_pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, t_pad))
    nq, nk = (s + s_pad) // qc, (t + t_pad) // kc
    neg_inf = torch.tensor(float("-inf"), device=dev)

    outs = []
    for qi in range(nq):
        q_blk = qg[:, qi * qc:(qi + 1) * qc].float()       # (B,qc,hkv,g,d)
        q_pos = mi.q_positions(qi * qc + torch.arange(qc, device=dev))
        m = torch.full((b, hkv, g, qc), float("-inf"), device=dev)
        l = torch.zeros((b, hkv, g, qc), device=dev)
        acc = torch.zeros((b, hkv, g, qc, dv), device=dev)
        for kj in range(nk):
            k_blk = k[:, kj * kc:(kj + 1) * kc].float()
            v_blk = v[:, kj * kc:(kj + 1) * kc].float()
            k_pos = kj * kc + torch.arange(kc, device=dev)
            mask_blk = mi.block(q_pos, k_pos)
            mask_b = mask_blk[None, None, None] if mask_blk.dim() == 2 \
                else mask_blk[:, None, None]
            logits = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk) * scale
            logits = torch.where(mask_b, logits, neg_inf)
            m_new = torch.maximum(m, logits.amax(-1))
            # guard -inf rows (fully masked so far): exp(-inf - -inf)
            m_safe = torch.where(torch.isfinite(m_new), m_new,
                                 m_new.new_zeros(()))
            p = torch.exp(logits - m_safe[..., None])
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                m.new_zeros(()))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v_blk)
            m = m_new
        out = torch.where(l[..., None] > 0,
                          acc / torch.clamp(l[..., None], min=1e-30),
                          acc.new_zeros(()))               # (B,hkv,g,qc,dv)
        outs.append(out.permute(0, 3, 1, 2, 4))            # (B,qc,hkv,g,dv)
    out = torch.cat(outs, dim=1)
    return out[:, :s].to(v.dtype)


def _ring_mask(s: int, window: int, index):
    """Decode-time mask over a ring of ``window`` slots: slot j holds the
    newest position p ≡ j (mod window) with p <= index; valid iff written
    (p >= 0).  ``index`` (B,) -> (B, 1, window)."""
    assert s == 1
    slots = torch.arange(window, device=index.device)
    newest = index[:, None].long()
    pos = newest - torch.remainder(newest - slots, window)
    return (pos >= 0)[:, None, :]


# ---------------------------------------------------------------------------
# KV quantization helpers (int8 cache)
# ---------------------------------------------------------------------------


def _quantize(x):
    amax = x.abs().amax(-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    return torch.round(x / scale).to(torch.int8), scale.float()


def _maybe_store(x, dtype: str):
    if dtype == "int8":
        return _quantize(x)
    return x.to(getattr(torch, dtype)), None


def _maybe_load(stored, scale, dtype):
    if scale is not None:
        return stored.to(dtype) * scale.to(dtype)
    return stored.to(dtype)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def gqa_spec(cfg):
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "q": dense_spec(d, hq * dh, ("embed", "q_heads_x_dim"), bias=cfg.qkv_bias),
        "k": dense_spec(d, hkv * dh, ("embed", "kv_heads_x_dim"), bias=cfg.qkv_bias),
        "v": dense_spec(d, hkv * dh, ("embed", "kv_heads_x_dim"), bias=cfg.qkv_bias),
        "o": dense_spec(hq * dh, d, ("q_heads_x_dim", "embed")),
    }


def init_gqa_cache(cfg, batch: int, s_max: int, window: Optional[int] = None,
                   device="cuda") -> Dict[str, torch.Tensor]:
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    size = min(s_max, window) if window else s_max
    kv_dtype = cfg.kv_cache_dtype
    store = torch.int8 if kv_dtype == "int8" else getattr(torch, kv_dtype)
    cache = {
        "k": torch.zeros((batch, size, hkv, dh), dtype=store, device=device),
        "v": torch.zeros((batch, size, hkv, dh), dtype=store, device=device),
        "index": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if kv_dtype == "int8":
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros((batch, size, hkv, 1),
                                      dtype=torch.float32, device=device)
    return cache


def init_gqa_paged_cache(cfg, n_slots: int, geom: PageGeometry,
                         device="cuda") -> Dict[str, torch.Tensor]:
    """Paged GQA cache: shared page pool + per-slot block table/index."""
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    kv_dtype = cfg.kv_cache_dtype
    store = torch.int8 if kv_dtype == "int8" else getattr(torch, kv_dtype)
    pool = (geom.n_pages, geom.page_size, hkv)
    cache = {
        "k": torch.zeros(pool + (dh,), dtype=store, device=device),
        "v": torch.zeros(pool + (dh,), dtype=store, device=device),
        "block_table": torch.zeros((n_slots, geom.pages_per_slot),
                                   dtype=torch.int32, device=device),
        "index": torch.zeros((n_slots,), dtype=torch.int32, device=device),
    }
    if kv_dtype == "int8":
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(pool + (1,), dtype=torch.float32,
                                      device=device)
    return cache


def _paged_write(pool, new, page, off):
    """Scatter this step's per-slot token into its (page, offset) cell, in
    place.  pool: (P, ps, ...); new: (B, 1, ...); page/off: (B,) int64.
    Free slots point at the null page 0, so their writes land there."""
    pool[page, off] = new[:, 0]


def _paged_view(pool, block_table):
    """Gather a slot-major dense view (B, pages_per_slot·ps, ...) of the
    pool through the block table (B, pages_per_slot) int64."""
    b, p_max = block_table.shape
    v = pool[block_table]                    # (B, p_max, ps, ...)
    return v.reshape((b, p_max * pool.shape[1]) + tuple(pool.shape[2:]))


def _cache_write(cache, k_new, v_new, kv_dtype: str, window: Optional[int]):
    """Write this call's kv (B, s, Hkv, Dh) at each slot's index, in place;
    returns the dict with the index advanced by s."""
    index = cache["index"]                   # (B,)
    b, s = k_new.shape[:2]
    ks, k_scale = _maybe_store(k_new, kv_dtype)
    vs, v_scale = _maybe_store(v_new, kv_dtype)
    cache = dict(cache)
    new = {"k": ks, "v": vs}
    if k_scale is not None:
        new.update(k_scale=k_scale, v_scale=v_scale)
    if "block_table" in cache:
        # paged decode write (prefill goes through the dense slab and the
        # serving layer's commit_prefill — see serve/paging.py).  The
        # reference's gather clamps an index past the table's width.
        assert s == 1, "paged caches are decode-only; prefill is dense"
        table = cache["block_table"]
        ps = cache["k"].shape[1]
        col = torch.clamp(torch.div(index, ps, rounding_mode="floor"),
                          max=table.shape[1] - 1).long()
        page = table[torch.arange(b, device=index.device), col].long()
        off = torch.remainder(index, ps).long()
        for name, t in new.items():
            _paged_write(cache[name], t, page, off)
        cache["index"] = index + s
        return cache
    size = cache["k"].shape[1]
    if window and s >= size:
        # prefill longer than the ring: keep the last `size` tokens, rolled
        # so that absolute position p lands at slot p % size.  Prefill rows
        # share one length, so the shift is the same for every row.
        shift = (s - size) % size
        for name, t in new.items():
            cache[name].copy_(torch.roll(t[:, -size:], shift, dims=1))
    elif window and s == 1:
        rows = torch.arange(b, device=index.device)
        slot = torch.remainder(index.long(), size)    # per-slot ring position
        for name, t in new.items():
            cache[name][rows, slot] = t[:, 0]
    elif s == 1:
        # one token per slot at its index.  A slot whose index has run past
        # the slab writes into its last row: a serving session's slabs keep
        # one spare row past max_seq for those writes, which the reference
        # drops (generate never writes past the end)
        rows = torch.arange(b, device=index.device)
        pos = torch.clamp(index.long(), max=size - 1)
        for name, t in new.items():
            cache[name][rows, pos] = t[:, 0]
    else:
        # per-slot start positions: row b writes index[b] .. index[b]+s-1
        rows = torch.arange(b, device=index.device)[:, None]
        pos = index.long()[:, None] + torch.arange(s, device=index.device)
        for name, t in new.items():
            cache[name][rows, pos] = t
    cache["index"] = index + s
    return cache


def _parallel(layer, cache):
    """``(view, mode)`` of a layer computing tensor-parallel, or None.
    With a cache, the serving step's layout must be known, and the cache
    dense (the module's note)."""
    tp = shardlib.unit(layer)
    if tp is not None and cache is not None:
        if "block_table" in cache:
            raise ValueError("paged caches serve on one device: a mesh "
                             "step takes dense caches (the reference's dry "
                             "run never pages)")
        if shardlib.cache_layout(layer) is None:
            raise ValueError("tensor-parallel attention with a cache runs "
                             "in a serving step on a mesh "
                             "(launch.steps.make_prefill_step / "
                             "make_decode_step with partitioner=)")
    return tp


# ------------------------------------------------ serving on a mesh


def _cache_cuts(placements, view):
    """``(tensor dim that model cuts or None, mesh dims that cut the
    sequence dim 1)`` of a cache leaf's placements."""
    dims = layout.sharded_mesh_dims(placements)
    cut = next((d for d, ms in dims.items() if view.mesh_dim in ms), None)
    return cut, tuple(dims.get(1, ()))


def _cache_part(t, dim, view):
    """This rank's chunk along ``dim`` of ``t``, whole there (None: all)."""
    return t if dim is None else t.chunk(view.size, dim)[view.rank]


def _cache_whole(t, dim, view):
    """``t`` gathered whole over ``model`` along the cut ``dim``."""
    return t if dim is None else layout.gather_dim(t, dim, view.mesh,
                                                   view.mesh_dim)


def _seq_span(view, seq_dims, size_local: int):
    """``(first global slot, global slots)`` of a sequence cut over
    ``seq_dims``."""
    n, i = view.piece(seq_dims)
    return i * size_local, n * size_local


def _split_write(cache, write, names, seq_dims, view, window, new_one):
    """Write this call's tokens into a cache cut over the sequence:
    ``write(temp)`` (the one-device write) on a zeroed slab of the whole
    length for a prefill, whose rank's span is then kept; for one token,
    only the rank that holds its slot writes it (``new_one``: the stored
    leaves, (B, 1, ...))."""
    index = cache["index"]
    size_l = cache[names[0]].shape[1]
    lo, size_g = _seq_span(view, seq_dims, size_l)
    cache = dict(cache)
    if new_one is None:
        temp = {name: cache[name].new_zeros(
            (cache[name].shape[0], size_g) + tuple(cache[name].shape[2:]))
            for name in names}
        temp["index"] = index
        temp = write(temp)
        for name in names:
            cache[name].copy_(temp[name][:, lo:lo + size_l])
        cache["index"] = temp["index"]
        return cache
    p = index.long()
    slot = torch.remainder(p, size_g) if window \
        else torch.clamp(p, max=size_g - 1)
    loc = slot - lo
    keep = (loc >= 0) & (loc < size_l)
    loc = loc.clamp(0, size_l - 1)
    rows = torch.arange(index.shape[0], device=index.device)
    for name, t in new_one.items():
        cur = cache[name][rows, loc]
        k = keep.reshape((-1,) + (1,) * (cur.dim() - 1))
        cache[name][rows, loc] = torch.where(k, t[:, 0].to(cur.dtype), cur)
    cache["index"] = index + 1
    return cache


def _decode_mask(index, window, lo: int, size_l: int, size_g: int):
    """The decode mask (B, 1, size_l) of the rank's slots ``[lo, lo +
    size_l)`` of a slab or ring of ``size_g``."""
    if window:
        return _ring_mask(1, size_g, index)[..., lo:lo + size_l]
    k_pos = lo + torch.arange(size_l, device=index.device)
    mi = MaskInfo(causal=True, q_offset=index, valid_len=index + 1)
    return mi.block(mi.q_positions(torch.zeros(1, dtype=torch.long,
                                               device=index.device)), k_pos)


def _attend_split(q, k, v, mask, view, seq_dims, scale=None):
    """Attention of one query over this rank's span of the keys, the
    ranks' partial softmaxes combined over ``seq_dims`` by log-sum-exp:
    the row maxima's ``all_reduce_max``, then the numerators and
    denominators summed.  q (B, 1, Hq, D); k/v (B, T_rank, Hkv, ·); mask
    (B, 1, T_rank)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float()) * scale
    logits = torch.where(mask[:, None, None], logits,
                         logits.new_full((), _NEG))
    top = logits.amax(-1, keepdim=True)
    for i in seq_dims:
        top = layout.all_reduce_max(top, view.mesh, i)
    p = torch.exp(logits - top)
    parts = torch.cat([torch.einsum("bhgst,bthd->bhgsd", p, v.float()),
                       p.sum(-1, keepdim=True)], dim=-1)
    for i in seq_dims:
        parts = layout.reduce_out(parts, view.mesh, i)
    out = parts[..., :-1] / parts[..., -1:]                # (B,h,g,s,dv)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, -1).to(v.dtype)


def _own_kv_heads(k, v, q_heads: int, hq: int, hkv: int, view):
    """Whole k/v's kv head of each of this rank's ``q_heads`` query heads
    (``repeat``)."""
    heads = q_heads * view.rank + torch.arange(q_heads, device=k.device)
    kv = torch.div(heads, hq // hkv, rounding_mode="floor")
    return k.index_select(2, kv), v.index_select(2, kv)


def _serve_out(o: Dense, y, tp, split_q: bool):
    """The output projection of a serving layer: row-parallel (``heads``,
    ``repeat``), gathered along the sequence (``seq`` with its query
    split) or whole (``seq`` at decode)."""
    view, how = tp
    if how != "seq":
        return o.row(y, view)
    y = o(y)
    return layout.gather_dim(y, 1, view.mesh, view.mesh_dim) if split_q \
        else y


def _gqa_serve(layer, cfg, x, positions, cache, window, tp):
    """:func:`gqa_apply` with a cache on a mesh (the module's note)."""
    view, how = tp
    pl = shardlib.cache_layout(layer)
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cut, seq_dims = _cache_cuts(pl["k"], view)
    if how == "heads" and cut != 2:
        raise ValueError("attn_shard_mode 'heads' serves from a cache cut "
                         "over kv heads")
    if "k_scale" in pl and _cache_cuts(pl["k_scale"], view)[0] != cut:
        raise ValueError("an int8 cache whose scales are not cut as its "
                         "values does not serve on this mesh")
    x = layout.copy_in(x, view.mesh, view.mesh_dim)
    split_q = how == "seq" and s > 1
    first, q_src, q_pos = 0, x, positions
    if split_q:
        sl, first = _query_part(s, view)
        q_src, q_pos = x[:, first:first + sl], positions[:, first:first + sl]
    q = layer.q(q_src).reshape(b, q_src.shape[1], -1, dh)
    k, v = layer.k(x), layer.v(x)
    if how == "repeat" and k.shape[-1] < hkv * dh:
        k, v = (layout.gather_dim(u, -1, view.mesh, view.mesh_dim)
                for u in (k, v))
    k, v = k.reshape(b, s, -1, dh), v.reshape(b, s, -1, dh)
    q = rope(q, q_pos, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    kp, vp = (k, v) if how == "heads" else \
        (_cache_part(t, cut, view) for t in (k, v))
    kv_dtype = cfg.kv_cache_dtype
    names = [n for n in ("k", "v", "k_scale", "v_scale") if n in cache]

    def write(c):
        return _cache_write(c, kp, vp, kv_dtype, window)
    if not seq_dims:
        new_cache = write(cache)
    else:
        one = None
        if s == 1:
            ks, k_sc = _maybe_store(kp, kv_dtype)
            vs, v_sc = _maybe_store(vp, kv_dtype)
            one = {"k": ks, "v": vs}
            if k_sc is not None:
                one.update(k_scale=k_sc, v_scale=v_sc)
        new_cache = _split_write(cache, write, names, seq_dims, view, window,
                                 one)
    if s > 1:
        # a fresh cache: the in-flight k/v, as the cache holds them
        if not window:
            k, v = (_maybe_load(*_maybe_store(t, kv_dtype), x.dtype)
                    for t in (k, v))
        if how == "repeat":
            k, v = _own_kv_heads(k, v, q.shape[2], hq, hkv, view)
        y = attend(q, k, v, mask_info=MaskInfo(causal=True, window=window,
                                               q_offset=first))
    else:
        index = cache["index"]
        kc = _maybe_load(new_cache["k"], new_cache.get("k_scale"), x.dtype)
        vc = _maybe_load(new_cache["v"], new_cache.get("v_scale"), x.dtype)
        if how != "heads":
            kc, vc = (_cache_whole(t, cut, view) for t in (kc, vc))
        if how == "repeat":
            kc, vc = _own_kv_heads(kc, vc, q.shape[2], hq, hkv, view)
        size_l = kc.shape[1]
        if seq_dims:
            lo, size_g = _seq_span(view, seq_dims, size_l)
            y = _attend_split(q, kc, vc, _decode_mask(index, window, lo,
                                                      size_l, size_g),
                              view, seq_dims)
        elif window:
            y = attend(q, kc, vc, _ring_mask(1, size_l, index))
        else:
            y = attend(q, kc, vc, mask_info=MaskInfo(
                causal=True, q_offset=index, valid_len=index + 1))
    y = _serve_out(layer.o, y.reshape(b, y.shape[1], -1), tp, split_q)
    return y, new_cache


def _query_part(s: int, view):
    """``(rows, first)`` of this rank's part of a query sequence of ``s``
    positions under ``seq``."""
    if s % view.size:
        raise ValueError(f"attn_shard_mode 'seq': a query sequence of {s} "
                         f"does not split over {view.size} model ranks")
    rows = s // view.size
    return rows, view.rank * rows


def _attn_out(o: Dense, y, tp):
    """The output projection: whole, row-parallel (``heads``, ``repeat``)
    or on this rank's query positions, gathered along the sequence
    (``seq``)."""
    if tp is None:
        return o(y)
    view, how = tp
    if how == "seq":
        return layout.gather_dim(o(y), 1, view.mesh, view.mesh_dim)
    return o.row(y, view)


def gqa_apply(layer: "GQA", cfg, x, positions, *, mode: str = "causal",
              cache=None, window: Optional[int] = None, kv_x=None):
    """mode: causal | full (the encoder: no mask) | cross (keys and values
    from ``kv_x``, the encoder's output; no rope, no cache).  ``causal``
    and ``full`` rope q and k at ``positions``.  With ``cache``: writes
    the new kv at cache["index"] and attends over the whole (ring)
    buffer.  Returns (y, new_cache) — new_cache is None when no cache was
    passed."""
    if mode not in ("causal", "full", "cross"):
        raise ValueError(f"unknown attention mode {mode!r}")
    if (mode == "cross") != (kv_x is not None):
        # the reference attends to x itself in "cross" mode without kv_x,
        # and fails on a rope at no positions with kv_x in another mode
        raise ValueError(f"attention mode {mode!r} "
                         f"{'needs' if mode == 'cross' else 'takes no'} "
                         f"kv_x (the encoder's output)")
    b, s, d = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tp = _parallel(layer, cache)
    if tp is not None and cache is not None:
        return _gqa_serve(layer, cfg, x, positions, cache, window, tp)
    if tp is not None:          # every use below is split over the ranks
        view = tp[0]
        x = layout.copy_in(x, view.mesh, view.mesh_dim)
        if kv_x is not None:
            kv_x = layout.copy_in(kv_x, view.mesh, view.mesh_dim)
    kv_src = x if kv_x is None else kv_x
    t = kv_src.shape[1]
    first, q_src, q_pos = 0, x, positions
    if tp is not None and tp[1] == "seq":
        s, first = _query_part(s, tp[0])
        q_src = x[:, first:first + s]
        q_pos = None if positions is None else positions[:, first:first + s]
    q = layer.q(q_src).reshape(b, s, -1, dh)
    k, v = layer.k(kv_src), layer.v(kv_src)
    if tp is not None and tp[1] == "repeat" and k.shape[-1] < hkv * dh:
        # k and v bound to this rank's columns: every rank reads the whole
        k, v = (layout.gather_dim(u, -1, tp[0].mesh, tp[0].mesh_dim,
                                  grad="sum") for u in (k, v))
    k = k.reshape(b, t, -1, dh)
    v = v.reshape(b, t, -1, dh)
    if mode != "cross":
        q = rope(q, q_pos, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        index = cache["index"]
        new_cache = _cache_write(cache, k, v, cfg.kv_cache_dtype, window)
        if window and s > 1:
            # windowed prefill: attend over the in-flight (full-length) k/v
            # with the window mask — the ring holds a rolled layout that
            # only the s == 1 decode mask understands
            q, k, v = shard_attn_qkv(cfg, q, k, v)
            mi = MaskInfo(causal=True, window=window, q_offset=index)
            y = attend(q, k, v, mask_info=mi)
        elif ("block_table" in new_cache and s == 1 and not window
              and cfg.kv_cache_dtype != "int8"):
            # paged decode: each slot's live rows, read in place from the
            # pool (the kernel on the card, its plain version on the CPU);
            # the positions it reads are the ones the mask below admits
            y = paged_attention(q, new_cache["k"], new_cache["v"],
                                new_cache["block_table"], index)
        else:
            if "block_table" in new_cache:
                # paged: gather each slot's pages into a slot-major dense
                # view; view position t IS absolute token position t, so
                # the same per-slot causal/valid masks apply unchanged
                bt = new_cache["block_table"].long()
                view = {name: _paged_view(new_cache[name], bt)
                        for name in ("k", "v", "k_scale", "v_scale")
                        if name in new_cache}
            else:
                view = new_cache
            k = _maybe_load(view["k"], view.get("k_scale"), x.dtype)
            v = _maybe_load(view["v"], view.get("v_scale"), x.dtype)
            q, k, v = shard_attn_qkv(cfg, q, k, v)
            t = k.shape[1]
            if window and s == 1:
                y = attend(q, k, v, _ring_mask(s, t, index))
            else:
                # prefill into an empty/partial cache: causal over written
                mi = MaskInfo(causal=True, q_offset=index,
                              valid_len=index + s)
                y = attend(q, k, v, mask_info=mi)
    else:
        if tp is None:
            q, k, v = shard_attn_qkv(cfg, q, k, v)
        elif tp[1] == "repeat":
            # this rank's query heads, each with its own kv head
            heads = q.shape[2] * tp[0].rank + torch.arange(
                q.shape[2], device=q.device)
            kv = torch.div(heads, hq // hkv, rounding_mode="floor")
            k, v = k.index_select(2, kv), v.index_select(2, kv)
        mi = MaskInfo(causal=mode == "causal", window=window,
                      q_offset=first)
        y = attend(q, k, v, mask_info=mi)
    y = _attn_out(layer.o, y.reshape(b, s, -1), tp)
    return y, new_cache


def make_cross_cache(layer: "GQA", cfg, enc_out):
    """A decoder layer's cross-attention keys and values from the encoder's
    output ``enc_out`` (B, T, d), in its dtype (``cfg.dtype``), unroped:
    (ck, cv), each (B, T, Hkv, Dh).  Made once per request, so that no
    decode step projects the encoder's output again."""
    b, t, _ = enc_out.shape
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    tp = shardlib.unit(layer)
    if tp is None:
        return (layer.k(enc_out).reshape(b, t, hkv, dh),
                layer.v(enc_out).reshape(b, t, hkv, dh))
    # on a mesh: this rank's slice of the ck/cv cache layout
    view, how = tp
    cut = _cache_cuts(shardlib.cache_layout(layer)["ck"], view)[0]
    k, v = layer.k(enc_out), layer.v(enc_out)
    if how == "heads":
        if cut != 2:
            raise ValueError("attn_shard_mode 'heads' serves from a cache "
                             "cut over kv heads")
        return k.reshape(b, t, -1, dh), v.reshape(b, t, -1, dh)
    if how == "repeat" and k.shape[-1] < hkv * dh:
        k, v = (layout.gather_dim(u, -1, view.mesh, view.mesh_dim)
                for u in (k, v))
    return tuple(_cache_part(u.reshape(b, t, hkv, dh), cut, view)
                 for u in (k, v))


def cross_attend_cached(layer: "GQA", cfg, x, ck, cv):
    """Cross-attention of ``x`` (B, S, d) against the kept keys and values
    of :func:`make_cross_cache`: every encoder position visible."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tp = shardlib.unit(layer)
    if tp is None:
        q = layer.q(x).reshape(b, s, hq, dh)
        y = attend(q, ck, cv, mask_info=MaskInfo(causal=False))
        return layer.o(y.reshape(b, s, hq * dh))
    # on a mesh (this rank's ck/cv slices): the query is never split
    view, how = tp
    cut = _cache_cuts(shardlib.cache_layout(layer)["ck"], view)[0]
    x = layout.copy_in(x, view.mesh, view.mesh_dim)
    q = layer.q(x).reshape(b, s, -1, dh)
    if how != "heads":
        ck, cv = (_cache_whole(t, cut, view) for t in (ck, cv))
    if how == "repeat":
        ck, cv = _own_kv_heads(ck, cv, q.shape[2], hq, hkv, view)
    y = attend(q, ck, cv, mask_info=MaskInfo(causal=False))
    return _serve_out(layer.o, y.reshape(b, s, -1), tp, False)


class GQA(nn.Module):
    """One attention layer's projections (``q``, ``k``, ``v``, ``o``, each
    a :class:`~repro_torch.models.layers.Dense`)."""

    def __init__(self, params):
        super().__init__()
        for name in ("q", "k", "v", "o"):
            setattr(self, name, Dense(params[name]))


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V2/V3, MiniCPM3)
# ---------------------------------------------------------------------------


def mla_spec(cfg):
    d, h = cfg.d_model, cfg.n_heads
    m = cfg.mla
    spec = {
        "kv_down": dense_spec(d, m.kv_lora_rank + m.qk_rope_head_dim,
                              ("embed", "mla_latent")),
        "kv_norm": {"scale": P((m.kv_lora_rank,), ("norm",), init="ones")},
        "k_up": dense_spec(m.kv_lora_rank, h * m.qk_nope_head_dim,
                           ("mla_latent", "q_heads_x_dim")),
        "v_up": dense_spec(m.kv_lora_rank, h * m.v_head_dim,
                           ("mla_latent", "q_heads_x_dim")),
        "o": dense_spec(h * m.v_head_dim, d, ("q_heads_x_dim", "embed")),
    }
    q_dim = h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
    if m.q_lora_rank:
        spec["q_down"] = dense_spec(d, m.q_lora_rank, ("embed", "mla_latent"))
        spec["q_norm"] = {"scale": P((m.q_lora_rank,), ("norm",), init="ones")}
        spec["q_up"] = dense_spec(m.q_lora_rank, q_dim,
                                  ("mla_latent", "q_heads_x_dim"))
    else:
        spec["q_proj"] = dense_spec(d, q_dim, ("embed", "q_heads_x_dim"))
    return spec


def init_mla_cache(cfg, batch: int, s_max: int, window: Optional[int] = None,
                   device="cuda") -> Dict[str, torch.Tensor]:
    m = cfg.mla
    size = min(s_max, window) if window else s_max
    dt = getattr(torch, cfg.dtype)
    return {
        "ckv": torch.zeros((batch, size, m.kv_lora_rank), dtype=dt,
                           device=device),
        "krope": torch.zeros((batch, size, m.qk_rope_head_dim), dtype=dt,
                             device=device),
        "index": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def init_mla_paged_cache(cfg, n_slots: int, geom: PageGeometry,
                         device="cuda") -> Dict[str, torch.Tensor]:
    """Paged MLA cache: latent / rope-key page pools + block table."""
    m = cfg.mla
    dt = getattr(torch, cfg.dtype)
    pool = (geom.n_pages, geom.page_size)
    return {
        "ckv": torch.zeros(pool + (m.kv_lora_rank,), dtype=dt,
                           device=device),
        "krope": torch.zeros(pool + (m.qk_rope_head_dim,), dtype=dt,
                             device=device),
        "block_table": torch.zeros((n_slots, geom.pages_per_slot),
                                   dtype=torch.int32, device=device),
        "index": torch.zeros((n_slots,), dtype=torch.int32, device=device),
    }


def _mla_cache_write(cache, new: Dict[str, torch.Tensor],
                     window: Optional[int]):
    """Write this call's latent and rope key (B, s, ·) at each slot's index,
    in place, under the GQA path's out-of-range rules; returns the dict
    with the index advanced by s."""
    index = cache["index"]                   # (B,)
    b, s = new["ckv"].shape[:2]
    rows = torch.arange(b, device=index.device)
    cache = dict(cache)
    if "block_table" in cache:
        assert s == 1, "paged caches are decode-only; prefill is dense"
        table = cache["block_table"]
        ps = cache["ckv"].shape[1]
        col = torch.clamp(torch.div(index, ps, rounding_mode="floor"),
                          max=table.shape[1] - 1).long()
        page = table[rows, col].long()
        off = torch.remainder(index, ps).long()
        for name, t in new.items():
            _paged_write(cache[name], t, page, off)
    else:
        size = cache["ckv"].shape[1]
        if window and s == 1:
            pos = torch.remainder(index.long(), size)[:, None]
        elif s == 1:
            # past the slab: its last (spare) row, as _cache_write
            pos = torch.clamp(index.long(), max=size - 1)[:, None]
        else:
            pos = index.long()[:, None] + torch.arange(s,
                                                       device=index.device)
        r = rows[:, None].expand(b, s)
        if s > 1 and not bool((pos < size).all()):
            # positions past the slab are dropped, as JAX's scatter drops
            # them (a prefill longer than a window's ring)
            keep = pos < size
            r, pos = r[keep], pos[keep]
            new = {name: t[keep] for name, t in new.items()}
        for name, t in new.items():
            cache[name][r, pos] = t
    cache["index"] = index + s
    return cache


def mla_apply(layer: "MLA", cfg, x, positions, *, mode: str = "causal",
              cache=None, window: Optional[int] = None):
    """MLA: the cache holds only the normalised latent (r_kv) and the
    shared rope key (Dr) per token; keys and values are up-projected from
    it at every call.  Causal whatever ``mode`` says, as the reference's.
    Returns (y, new_cache)."""
    b, s, d = x.shape
    m = cfg.mla
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    tp = _parallel(layer, cache)
    if tp is not None and cache is not None:
        return _mla_serve(layer, cfg, x, positions, cache, window, tp)
    # heads: the latents are replicated, copied in where they enter the
    # split heads; seq: every use of x is this rank's part
    split = tp is not None and tp[1] != "seq"

    def part(t):
        return layout.copy_in(t, tp[0].mesh, tp[0].mesh_dim) if split else t
    first, xq, q_pos = 0, x, positions
    if tp is not None and tp[1] == "seq":
        x = layout.copy_in(x, tp[0].mesh, tp[0].mesh_dim)
        s, first = _query_part(s, tp[0])
        xq, q_pos = x[:, first:first + s], positions[:, first:first + s]

    if m.q_lora_rank:
        q = layer.q_up(part(layer.q_norm(layer.q_down(xq))))
    else:
        q = layer.q_proj(part(xq))
    q = q.reshape(b, s, -1, dn + dr)
    h = q.shape[2]
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, q_pos, cfg.rope_theta)

    down = layer.kv_down(x)
    ckv, k_rope = down[..., :m.kv_lora_rank], down[..., m.kv_lora_rank:]
    ckv = layer.kv_norm(ckv)
    # the rope key is one head, broadcast over the heads below
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    if split:
        ckv, k_rope = part(torch.cat([ckv, k_rope], dim=-1)).split(
            [m.kv_lora_rank, dr], dim=-1)

    new_cache = None
    if cache is not None:
        index = cache["index"]               # (B,)
        new_cache = _mla_cache_write(
            cache, {"ckv": ckv.to(cache["ckv"].dtype),
                    "krope": k_rope.to(cache["krope"].dtype)}, window)
        if "block_table" in cache:
            bt = cache["block_table"].long()
            ckv = _paged_view(new_cache["ckv"], bt).to(x.dtype)
            k_rope = _paged_view(new_cache["krope"], bt).to(x.dtype)
        else:
            ckv = new_cache["ckv"].to(x.dtype)
            k_rope = new_cache["krope"].to(x.dtype)

    t = ckv.shape[1]
    # up-project the latent to per-head keys and values (recomputed each
    # call, the MLA trade)
    k_nope = layer.k_up(ckv).reshape(b, t, h, dn)
    v = layer.v_up(ckv).reshape(b, t, h, dv)
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, t, h, dr)],
                      dim=-1)
    if tp is None:
        q_cat, k_cat, v = shard_attn_qkv(cfg, q_cat, k_cat, v)

    scale = (dn + dr) ** -0.5
    if cache is not None and window and s == 1:
        out = attend(q_cat, k_cat, v, _ring_mask(s, t, index), scale=scale)
    elif cache is not None:
        mi = MaskInfo(causal=True, window=window, q_offset=index,
                      valid_len=index + s)
        out = attend(q_cat, k_cat, v, mask_info=mi, scale=scale)
    else:
        out = attend(q_cat, k_cat, v,
                     mask_info=MaskInfo(causal=True, window=window,
                                        q_offset=first),
                     scale=scale)
    y = _attn_out(layer.o, out.reshape(b, s, h * dv), tp)
    return y, new_cache


def _mla_serve(layer, cfg, x, positions, cache, window, tp):
    """:func:`mla_apply` with a cache on a mesh (the module's note): the
    latents computed whole, the rank's ``R`` slice written, and gathered
    whole over ``model`` at decode."""
    view, how = tp
    pl = shardlib.cache_layout(layer)
    b, s, _ = x.shape
    m = cfg.mla
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    cut, seq_dims = _cache_cuts(pl["ckv"], view)
    rope_cut, _ = _cache_cuts(pl["krope"], view)
    split = how != "seq"

    def part(t):
        return layout.copy_in(t, view.mesh, view.mesh_dim) if split else t
    split_q = how == "seq" and s > 1
    first, xq, q_pos = 0, x, positions
    if how == "seq":
        x = layout.copy_in(x, view.mesh, view.mesh_dim)
        if split_q:
            sl, first = _query_part(s, view)
            xq, q_pos = x[:, first:first + sl], positions[:, first:first + sl]
    if m.q_lora_rank:
        q = layer.q_up(part(layer.q_norm(layer.q_down(xq))))
    else:
        q = layer.q_proj(part(xq))
    q = q.reshape(b, xq.shape[1], -1, dn + dr)
    h = q.shape[2]
    q_cat = torch.cat([q[..., :dn], rope(q[..., dn:], q_pos, cfg.rope_theta)],
                      dim=-1)
    down = layer.kv_down(x)
    ckv = layer.kv_norm(down[..., :m.kv_lora_rank])
    k_rope = rope(down[..., m.kv_lora_rank:][:, :, None, :], positions,
                  cfg.rope_theta)[:, :, 0]
    dt = cache["ckv"].dtype
    new = {"ckv": _cache_part(ckv, cut, view).to(dt),
           "krope": _cache_part(k_rope, rope_cut, view).to(dt)}

    def write(c):
        if s == 1:
            return _mla_cache_write(c, new, window)
        # a fresh cache (index 0): its first positions, the rest dropped
        # as one device drops them, with no host read of the positions
        c = dict(c)
        n = min(s, c["ckv"].shape[1])
        for name, t in new.items():
            c[name][:, :n] = t[:, :n]
        c["index"] = c["index"] + s
        return c
    if not seq_dims:
        new_cache = write(cache)
    else:
        new_cache = _split_write(cache, write, ["ckv", "krope"], seq_dims,
                                 view, window, new if s == 1 else None)
    index = cache["index"]
    if s > 1:
        # a fresh cache: the in-flight latents, as the cache holds them —
        # the slab's first positions alone, as one device reads them
        # back (a prefill past a window's ring drops the rest)
        size = cache["ckv"].shape[1] * (view.piece(seq_dims)[0]
                                         if seq_dims else 1)
        lat = ckv[:, :size].to(dt).to(x.dtype)
        kr = k_rope[:, :size].to(dt).to(x.dtype)
    else:
        lat = _cache_whole(new_cache["ckv"], cut, view).to(x.dtype)
        kr = _cache_whole(new_cache["krope"], rope_cut, view).to(x.dtype)
    if split:
        lat, kr = part(torch.cat([lat, kr], dim=-1)).split(
            [m.kv_lora_rank, dr], dim=-1)
    t = lat.shape[1]
    k_nope = layer.k_up(lat).reshape(b, t, h, dn)
    v = layer.v_up(lat).reshape(b, t, h, dv)
    k_cat = torch.cat([k_nope, kr[:, :, None, :].expand(b, t, h, dr)],
                      dim=-1)
    scale = (dn + dr) ** -0.5
    if s > 1:
        out = attend(q_cat, k_cat, v, mask_info=MaskInfo(
            causal=True, window=window, q_offset=first), scale=scale)
    elif seq_dims:
        lo, size_g = _seq_span(view, seq_dims, t)
        out = _attend_split(q_cat, k_cat, v,
                            _decode_mask(index, window, lo, t, size_g),
                            view, seq_dims, scale)
    elif window:
        out = attend(q_cat, k_cat, v, _ring_mask(1, t, index), scale=scale)
    else:
        out = attend(q_cat, k_cat, v, mask_info=MaskInfo(
            causal=True, q_offset=index, valid_len=index + 1), scale=scale)
    y = _serve_out(layer.o, out.reshape(b, out.shape[1], h * dv), tp,
                   split_q)
    return y, new_cache


class MLA(nn.Module):
    """One MLA layer: ``kv_down``, ``kv_norm``, ``k_up``, ``v_up``, ``o``
    and either ``q_down``/``q_norm``/``q_up`` (a low-rank query) or
    ``q_proj``."""

    def __init__(self, params):
        super().__init__()
        for name in ("kv_down", "k_up", "v_up", "o", "q_down", "q_up",
                     "q_proj"):
            if name in params:
                setattr(self, name, Dense(params[name]))
        for name in ("kv_norm", "q_norm"):
            if name in params:
                setattr(self, name, RMSNorm(params[name]))
