"""Mixture-of-Experts: top-k routing, shared experts, two dispatches.

The PyTorch counterpart of ``repro.models.moe``.  Two dispatch
implementations, selected by ``cfg.moe.dispatch``:

* ``einsum``  — the GShard/Switch one-hot dispatch and combine tensors
  ``(T, E, C)``, contracted with x and with the experts' outputs;
* ``scatter`` — tokens sorted by expert (a stable sort) and moved with
  gathers and ``index_add_`` into a dense ``(E, C, d)`` buffer.

Both drop, in train mode, the same routed copies as the reference: a copy
is kept while its position in its expert — counted over the ``(T·k, E)``
one-hot in token-major order — is below the capacity.  Inference passes
``dropless=True`` (capacity = token count, which drops nothing).

DeepSeek-V3 specifics: sigmoid scoring with the aux-loss-free ``bias``
(added to the scores for the selection only, never for the weights, and
never updated: its gradient is zero in the reference and its tree keeps
it as a zero buffer), a shared expert always on, and top-k combine
weights normalised to sum to one.

Everything here runs inside the serving engine's captured decode step on
the card, so nothing asks the host for a value: one-hot tensors are
comparisons against an ``arange``, and capacities come from shapes.  On a
CUDA card ``index_add_`` (the scatter dispatch) sums with atomics and is
not bitwise repeatable.  The reference's expert-parallel hint
(``shardlib.constrain`` of the ``(E, C, d)`` buffer over ``model``) sits
where it does; on plain tensors it is the identity.

**Rows split across ranks** (sharded training, :func:`row_shard`): each
rank routes its own rows, yet capacity, positions and the aux terms are
the whole batch's, as the reference computes them over the global
flattened batch.  Each rank all-gathers its per-expert routed-copy counts
(``(E,)`` int32); its offset in an expert is the sum over the ranks whose
rows come first in the batch (token-major) order, and a copy is kept iff
``offset[e] + local position < capacity(T_global)``, ``T_global`` from
shapes.  The expert buffer holds only the positions the rank owns.
``expert_fraction`` comes from the summed counts; the load-balance and
z-loss terms are each rank's share (its rows' sums over ``T_global``), so
the shares sum over the ranks to the reference's terms.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.ffn import FFN, ffn_apply_stacked, gated_ffn_apply
from repro_torch.models.layers import ParamModule, dense_spec
from repro_torch.models.shardlib import constrain
from repro_torch.models.spec import P

__all__ = ["moe_spec", "moe_apply", "MoE", "RowShard", "row_shard"]

# dropless einsum dispatch/combine tensors are (T, E, cap≈T); above this
# element budget (~256 MB fp32 for the pair) moe_apply reroutes to scatter
_DROPLESS_EINSUM_BUDGET = 1 << 25


def moe_spec(cfg):
    d, m = cfg.d_model, cfg.moe
    spec = {
        "router": {"kernel": P((d, m.n_experts), ("embed", "experts"),
                               init="fan_in")},
        "experts": {
            "w_in": P((m.n_experts, d, m.d_ff_expert),
                      ("experts", "embed", "mlp"), init="fan_in"),
            "w_gate": P((m.n_experts, d, m.d_ff_expert),
                        ("experts", "embed", "mlp"), init="fan_in"),
            "w_out": P((m.n_experts, m.d_ff_expert, d),
                       ("experts", "mlp", "embed"), init="fan_in"),
        },
    }
    if m.aux_free_bias:
        # selection-bias buffer (DeepSeek-V3); the reference never updates it
        spec["router"]["bias"] = P((m.n_experts,), ("experts",), init="zeros")
    if m.n_shared:
        spec["shared"] = {
            "w_in": dense_spec(d, m.n_shared * m.d_ff_expert, ("embed", "mlp")),
            "w_gate": dense_spec(d, m.n_shared * m.d_ff_expert,
                                 ("embed", "mlp")),
            "w_out": dense_spec(m.n_shared * m.d_ff_expert, d,
                                ("mlp", "embed")),
        }
    return spec


def _one_hot(idx, n: int, dtype):
    """``idx (...) -> (..., n)`` in ``dtype``; an index outside ``[0, n)``
    gives a zero row (as ``jax.nn.one_hot``).  A comparison, so no host
    sync."""
    classes = torch.arange(n, device=idx.device)
    return (idx[..., None] == classes).to(dtype)


def _top_k(select, k: int):
    """Indices of the ``k`` largest entries of each row, largest first,
    equal values toward the lower index — ``lax.top_k``'s order, which
    ``torch.topk`` does not promise: a stable descending sort."""
    order = torch.sort(select, dim=-1, descending=True, stable=True).indices
    return order[..., :k]


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's rows of a batch split by rows across ``n_pieces``
    ranks: ``piece`` is its place in the batch order, and ``gather`` maps
    its ``(E,)`` int32 counts to every piece's, ``(n_pieces, E)`` in
    batch order (a collective on a mesh; a test may simulate it)."""
    n_pieces: int
    piece: int
    gather: Callable[[torch.Tensor], torch.Tensor]

    @classmethod
    def on_mesh(cls, mesh, placements) -> "RowShard":
        """The rows of a ``(B, ...)`` batch laid out by ``placements``
        (``Partitioner.batch_shardings``): dim 0 cut by each sharding mesh
        dim in mesh-dim order, as ``layout.local_chunk`` cuts it."""
        from repro_torch.sharding import layout
        dims = layout.sharded_mesh_dims(placements).get(0, [])
        coord = mesh.get_coordinate()
        n, piece = 1, 0
        for i in dims:
            n *= mesh.size(i)
            piece = piece * mesh.size(i) + coord[i]

        def gather(counts):
            return layout.gather_rows(counts[None], mesh, placements)
        return cls(n, piece, gather)


_ROW_SHARD: Optional[RowShard] = None


@contextlib.contextmanager
def row_shard(shard: Optional[RowShard]):
    """MoE layers inside the block route this rank's rows of the batch
    that ``shard`` describes (the module's note); None: the rows are the
    whole batch."""
    global _ROW_SHARD
    saved, _ROW_SHARD = _ROW_SHARD, shard
    try:
        yield shard
    finally:
        _ROW_SHARD = saved


def _select(layer: "MoE", cfg, x_flat):
    """(router logits, scores, expert_idx (T,k), combine_w (T,k) in x's
    dtype); routing runs in float32."""
    m = cfg.moe
    logits = x_flat.float() @ layer.router.kernel.float()
    if m.score_fn == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    select = scores
    bias = getattr(layer.router, "bias", None)
    if m.aux_free_bias and bias is not None:
        select = scores + bias.detach().float()[None, :]
    idx = _top_k(select, m.top_k)                                 # (T, k)
    gathered = torch.gather(scores, -1, idx)                      # (T, k)
    w = gathered / (gathered.sum(-1, keepdim=True) + 1e-9)
    return logits, scores, idx, w.to(x_flat.dtype)


def _routing(layer: "MoE", cfg, x_flat):
    """Returns (expert_idx (T,k), combine_w (T,k) in x's dtype, aux).
    Routing runs in float32."""
    m = cfg.moe
    logits, scores, idx, w = _select(layer, cfg, x_flat)
    # Switch-style load-balance aux (also a balance metric for aux-free
    # models), and the router z-loss for logit drift
    probs_mean = (scores / (scores.sum(-1, keepdim=True) + 1e-9)).mean(0)
    onehot = _one_hot(idx, m.n_experts, torch.float32)            # (T,k,E)
    frac = onehot.sum(1).mean(0) / m.top_k
    lb_loss = m.n_experts * (frac * probs_mean).sum()
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    aux = {"load_balance": lb_loss, "router_z": z_loss,
           "expert_fraction": frac}
    return idx, w, aux


def _routing_shard(layer: "MoE", cfg, x_flat, shard: RowShard):
    """:func:`_routing` of this rank's rows of a split batch: (idx, w,
    aux, offset).  ``aux`` holds the whole batch's ``expert_fraction`` and
    this rank's shares of the load-balance and z-loss terms; ``offset``
    (E,) int32 counts the routed copies of the ranks before this one."""
    m = cfg.moe
    logits, scores, idx, w = _select(layer, cfg, x_flat)
    n_tokens = x_flat.shape[0] * shard.n_pieces
    counts = _one_hot(idx, m.n_experts, torch.int32).sum((0, 1),
                                                         dtype=torch.int32)
    every = shard.gather(counts)                                  # (P, E)
    offset = every[:shard.piece].sum(0, dtype=torch.int32)
    frac = every.sum(0).float() / n_tokens / m.top_k
    probs = scores / (scores.sum(-1, keepdim=True) + 1e-9)
    lb_loss = m.n_experts * (frac * probs.sum(0)).sum() / n_tokens
    z_loss = torch.logsumexp(logits, dim=-1).square().sum() / n_tokens
    aux = {"load_balance": lb_loss, "router_z": z_loss,
           "expert_fraction": frac}
    return idx, w, aux, offset


def _capacity(cfg, n_tokens: int, dropless: bool = False) -> int:
    m = cfg.moe
    if dropless:
        # each token lands on top_k distinct experts, so no expert receives
        # more than n_tokens copies: cap = n_tokens drops nothing
        return max(8, -(-n_tokens // 8) * 8)
    c = int(m.capacity_factor * m.top_k * n_tokens / m.n_experts)
    return max(8, -(-c // 8) * 8)


def _positions(cfg, idx, cap: int, offset=None):
    """(pos, keep), each (T,k,E): a routed copy's position in its expert
    counted over the ``(T·k, E)`` one-hot in token-major order, and
    whether it is kept, ``offset[e] + pos < cap`` (offset: the copies of
    the ranks before this one, None for none)."""
    m = cfg.moe
    t = idx.shape[0]
    onehot = _one_hot(idx, m.n_experts, torch.int32)              # (T,k,E)
    pos = (torch.cumsum(onehot.reshape(t * m.top_k, m.n_experts),
                        dim=0).reshape(t, m.top_k, m.n_experts)
           - onehot)
    ahead = pos if offset is None else pos + offset
    return pos, (ahead < cap) & (onehot > 0)


def _buffer_rows(cfg, t: int, cap: int, offset) -> int:
    """Positions of an expert's buffer: ``cap``, or with an offset (a
    split batch) the positions this rank can own — fewer than its ``t``
    tokens, each of which routes to an expert at most once."""
    return cap if offset is None else min(cap, _capacity(cfg, t, True))


def _dispatch_einsum(layer: "MoE", cfg, x_flat, idx, w, *, dropless=False,
                     n_tokens=None, offset=None):
    """GShard dense dispatch: (T,E,C) one-hot dispatch/combine tensors,
    built with a loop over the k routing slots.  ``n_tokens`` (the whole
    batch's, for the capacity) and ``offset`` describe a split batch."""
    m = cfg.moe
    t = x_flat.shape[0]
    cap = _capacity(cfg, n_tokens or t, dropless)
    pos_in_expert, keep = _positions(cfg, idx, cap, offset)
    c = _buffer_rows(cfg, t, cap, offset)
    dispatch = x_flat.new_zeros((t, m.n_experts, c))
    combine = x_flat.new_zeros((t, m.n_experts, c))
    for kk in range(m.top_k):
        pos = torch.where(keep[:, kk], pos_in_expert[:, kk], c)
        pos_oh = _one_hot(pos, c, x_flat.dtype)                   # (T,E,C)
        dispatch = dispatch + pos_oh
        combine = combine + pos_oh * w[:, kk][:, None, None]
    expert_in = torch.einsum("tec,td->ecd", dispatch, x_flat)     # (E,C,d)
    expert_in = constrain(cfg, expert_in, "model", None, None)    # EP
    expert_out = ffn_apply_stacked(layer.experts, cfg, expert_in)
    return torch.einsum("tec,ecd->td", combine, expert_out)


def _dispatch_scatter(layer: "MoE", cfg, x_flat, idx, w, *, dropless=False,
                      n_tokens=None, offset=None):
    """Sort-based dispatch: tokens ordered by target expert with a stable
    sort; each expert's first ``cap`` copies gathered into a dense
    (E, C, d) buffer, processed, and summed back into their tokens weighted
    by the router weights.  ``n_tokens`` and ``offset`` as in
    :func:`_dispatch_einsum`."""
    m = cfg.moe
    t, d = x_flat.shape
    cap = _capacity(cfg, n_tokens or t, dropless)
    c = _buffer_rows(cfg, t, cap, offset)
    dev = x_flat.device
    flat_e = idx.reshape(-1)                                      # (T*k,)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    # position of each routed copy within its expert
    pos_sorted = torch.arange(t * m.top_k, device=dev)
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(m.n_experts, device=dev, dtype=sorted_e.dtype))
    pos_within = pos_sorted - seg_start[sorted_e]
    ahead = pos_within if offset is None else pos_within + offset[sorted_e]
    keep = ahead < cap
    slot = sorted_e * c + torch.where(keep, pos_within, 0)        # (T*k,)

    token_of_copy = torch.div(order, m.top_k, rounding_mode="floor")
    gathered = x_flat[token_of_copy]                              # (T*k, d)
    buf = x_flat.new_zeros((m.n_experts * c, d))
    buf.index_add_(0, slot, torch.where(keep[:, None], gathered,
                                        gathered.new_zeros(())))
    expert_in = constrain(cfg, buf.reshape(m.n_experts, c, d), "model",
                          None, None)                              # EP
    expert_out = ffn_apply_stacked(layer.experts, cfg, expert_in)
    out_flat = expert_out.reshape(m.n_experts * c, d)

    w_copy = w.reshape(-1)[order]                                 # (T*k,)
    contrib = out_flat[slot] * torch.where(keep, w_copy,
                                           w_copy.new_zeros(()))[:, None]
    return torch.zeros_like(x_flat).index_add_(0, token_of_copy, contrib)


def moe_apply(layer: "MoE", cfg, x, *, dropless: bool = False
              ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (y, aux); the shared expert added on top.

    ``dropless``: no capacity drops — what inference passes (eval forward,
    prefill and decode), so that a token's output does not depend on what
    else shares its batch.  A dropless einsum dispatch past
    ``_DROPLESS_EINSUM_BUDGET`` elements of ``(T, E, cap)`` reroutes to the
    scatter dispatch (the same math), as the reference does: the same
    sizes take the same path in both packages.

    Inside :func:`row_shard` the rows are this rank's part of a split
    batch (the module's note); dropless, a token's output depends on no
    other token, so only the aux terms are the whole batch's.
    """
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    t = b * s
    shard = _ROW_SHARD
    if shard is None:
        idx, w, aux = _routing(layer, cfg, x_flat)
        split = {}
    else:
        idx, w, aux, offset = _routing_shard(layer, cfg, x_flat, shard)
        split = {} if dropless else dict(n_tokens=t * shard.n_pieces,
                                         offset=offset)
    use_scatter = cfg.moe.dispatch == "scatter"
    if dropless and not use_scatter:
        cap = _capacity(cfg, t, dropless=True)
        use_scatter = t * cfg.moe.n_experts * cap > _DROPLESS_EINSUM_BUDGET
    if use_scatter:
        y = _dispatch_scatter(layer, cfg, x_flat, idx, w, dropless=dropless,
                              **split)
    else:
        y = _dispatch_einsum(layer, cfg, x_flat, idx, w, dropless=dropless,
                             **split)
    if layer.shared is not None:
        y = y + gated_ffn_apply(layer.shared, cfg, x_flat)
    return y.reshape(b, s, d), aux


class MoE(nn.Module):
    """One MoE FFN: ``router`` (``kernel`` and DeepSeek-V3's ``bias``),
    ``experts`` (``w_in``, ``w_gate``, ``w_out`` stacked on the expert
    axis) and the optional ``shared`` expert (an
    :class:`~repro_torch.models.ffn.FFN`)."""

    def __init__(self, params, cfg):
        super().__init__()
        self.router = ParamModule(params["router"])
        self.experts = ParamModule(params["experts"])
        self.shared = FFN(params["shared"], cfg) if "shared" in params \
            else None
