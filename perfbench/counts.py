"""The yardstick: bytes, operations and roofline times of the work the
inputs need, and the card's published peaks.

Every rule is written once here, and none reads a field of the program's
format or plan: a sparse product is counted from its nonzeros, and a model
from its configuration's shapes.  So a later change to the format (its
padding, its slot rows, its split pieces) or to the kernels cannot move
the yardstick, and a roofline share cannot pass 100 % by counting padding.

A sparse product ``Y = A · X`` of ``nnz`` nonzeros, ``n_rows`` rows,
``n_cols`` columns and ``d`` vectors needs

- bytes: each nonzero's value and a 4-byte column index once, the
  ``n_rows + 1`` 4-byte row pointers once, ``X`` read once and ``Y``
  written once;
- operations: ``2 · nnz · d``;

and its least time on the card is the larger of the bytes over the HBM
bandwidth and the operations over the peak of the inputs' dtype.
"""
from __future__ import annotations

# NVIDIA H100 SXM (H100 80GB HBM3), the data sheet's dense rates without
# sparsity, at the card's full 700 W.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {
    "float32": 67e12,       # CUDA cores, no TF32
    "bfloat16": 989e12,
}

DTYPE_BYTES = {"float32": 4, "bfloat16": 2}
INDEX_BYTES = 4


def product_bytes(nnz: int, n_rows: int, n_cols: int, d: int,
                  dtype: str) -> int:
    """Bytes a sparse product needs: values and column indices once, row
    pointers once, ``X`` (``n_cols × d``) read once, ``Y`` (``n_rows × d``)
    written once, values, ``X`` and ``Y`` in ``dtype``."""
    e = DTYPE_BYTES[dtype]
    return (nnz * (e + INDEX_BYTES) + (n_rows + 1) * INDEX_BYTES
            + n_cols * d * e + n_rows * d * e)


def product_flops(nnz: int, d: int) -> int:
    """Operations of a sparse product: a multiply and an add a nonzero and
    vector."""
    return 2 * nnz * d


def bound_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The least time for ``nbytes`` of HBM traffic and ``flops``
    operations in ``dtype``: the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS_PER_S[dtype])


def product_bound_seconds(nnz: int, n_rows: int, n_cols: int, d: int,
                          dtype: str) -> float:
    return bound_seconds(product_bytes(nnz, n_rows, n_cols, d, dtype),
                         product_flops(nnz, d), dtype)


# ------------------------------------------------------------------ models


def sparse_nnz_per_row(density: float, d_in: int) -> int:
    """Nonzeros kept in each row of a pruned ``d_in``-wide weight: the
    density's share of ``d_in``, rounded to whole 8-entry chunks (the
    configuration's rule for a pruned FFN down-projection)."""
    k = max(8, int(round(density * d_in)))
    return -(-k // 8) * 8


def lm_shapes(model: dict) -> dict:
    """The shapes the counts need, from a model configuration file
    (Hugging Face key names, and its ``sparse_ffn`` group)."""
    d = model["hidden_size"]
    heads = model["num_attention_heads"]
    head_dim = model.get("head_dim") or d // heads
    sparse = model.get("sparse_ffn") or {}
    d_ff = model["intermediate_size"]
    return dict(layers=model["num_hidden_layers"], d=d, heads=heads,
                kv_heads=model["num_key_value_heads"], head_dim=head_dim,
                d_ff=d_ff, vocab=model["vocab_size"],
                w_out_nnz_per_row=(sparse_nnz_per_row(sparse["density"], d_ff)
                                   if sparse.get("enabled") else d_ff))


def w_out_nnz(model: dict) -> int:
    """Nonzeros of one layer's FFN down-projection (``d`` rows)."""
    s = lm_shapes(model)
    return s["d"] * s["w_out_nnz_per_row"]


def token_weight_flops(model: dict) -> int:
    """Operations one token makes through the weights, the head excepted:
    2 × each parameter it multiplies (the attention projections, the gate
    and up projections, and the down-projection at its nonzeros)."""
    s = lm_shapes(model)
    d, hd = s["d"], s["head_dim"]
    attn = d * s["heads"] * hd * 2 + d * s["kv_heads"] * hd * 2
    ffn = 2 * d * s["d_ff"] + d * s["w_out_nnz_per_row"]
    return 2 * s["layers"] * (attn + ffn)


def head_flops(model: dict) -> int:
    """Operations of one token's logits: 2 × d × vocabulary."""
    s = lm_shapes(model)
    return 2 * s["d"] * s["vocab"]


def attention_flops(model: dict, context: int) -> int:
    """Operations of one token's attention over ``context`` keys: scores
    and values, 4 · layers · context · heads · head_dim."""
    s = lm_shapes(model)
    return 4 * s["layers"] * context * s["heads"] * s["head_dim"]


def prefill_flops(model: dict, prompt: int) -> int:
    """Model operations of a prefill of ``prompt`` tokens: every token
    through the weights and over its causal context, and the logits of
    the last position only (the one a prefill samples from)."""
    return (prompt * token_weight_flops(model) + head_flops(model)
            + attention_flops(model, prompt * (prompt + 1) // 2))


def decode_flops(model: dict, context: int) -> int:
    """Model operations of one decoded token whose attention reads
    ``context`` keys (itself included)."""
    return (token_weight_flops(model) + head_flops(model)
            + attention_flops(model, context))


def w_out_bound_seconds(model: dict, d: int, dtype: str) -> float:
    """The least time of one layer's down-projection product at width
    ``d`` (the tokens it multiplies), counted from its nonzeros."""
    s = lm_shapes(model)
    return product_bound_seconds(w_out_nnz(model), s["d"], s["d_ff"], d,
                                 dtype)
