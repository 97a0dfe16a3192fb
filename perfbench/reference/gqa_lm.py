"""The plain reference of the generic GQA decoder: a full causal forward
pass in float32 with TF32 off.

Frozen: the benchmark judges the tokens the program served against it.
It is plain PyTorch and reads only the weight tree the benchmark made
(``makers/gqa_lm.py``'s layout) and the configuration file.  Each
layer's pruned down-projection is scattered from its nonzeros into a
dense ``(d, d_ff)`` matrix here, from the slot-major arrays alone: slot
row ``s`` of ``values2d``/``columns2d`` belongs to group ``s // k`` (``k``
kept columns a row), lane ``l`` of it to row ``group · G + l``.

The arithmetic is the generic pre-norm decoder the configuration states:
token embedding; per layer RMSNorm (eps from the file), grouped-query
attention with rotary positions (half-split, ``rope_theta``) and scale
``attention_multiplier``, a residual add, RMSNorm, a SiLU-gated FFN, a
residual add; a final RMSNorm and the tied embedding as the head.  It
runs layer by layer over a batch of sequences (each its own length), so
that each layer's weights are made float32 once.

``quant="fp8"`` computes every projection (the head included) from
weights and inputs rounded to float8 e4m3 with one scale a tensor, as an
fp8 deployment would: the control, a precision below the bfloat16 the
configuration serves in, which the comparison has to find wrong.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

F8_MAX = 448.0
Q_CHUNK = 512


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32: TF32 off while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (its largest magnitude
    maps to 448), back in float32."""
    s = t.abs().amax().clamp_min(1e-30) / F8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _linear(x, w, quant):
    if quant == "fp8":
        return fp8(x) @ fp8(w)
    return x @ w


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def _rope(x, theta: float):
    """``x`` (T, H, D) rotated at positions 0..T-1, angles in float64."""
    t, _, d = x.shape
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] \
        * freqs
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, scale):
    """Causal grouped-query attention: q (T, Hq, D), k/v (T, Hkv, D)."""
    t, hq, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(t, hkv, hq // hkv, d)
    out = torch.empty_like(q)
    for a in range(0, t, Q_CHUNK):
        b = min(t, a + Q_CHUNK)
        s = torch.einsum("qhgd,khd->hgqk", qg[a:b], k[:b]) * scale
        mask = torch.arange(b, device=q.device)[None, :] \
            <= torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(~mask, -math.inf)
        p = torch.softmax(s, dim=-1)
        out[a:b] = torch.einsum("hgqk,khd->qhgd", p, v[:b]).reshape(
            b - a, hq, d)
    return out


def dense_w_out(w_out: dict, d_out: int, d_in: int) -> torch.Tensor:
    """``(d_out, d_in)`` float32 from the down-projection's nonzeros."""
    vals, cols = w_out["values2d"], w_out["columns2d"]
    s, g = vals.shape
    n_groups = -(-d_out // g)
    k = s // n_groups
    rows = (torch.arange(s, device=vals.device) // k)[:, None] * g \
        + torch.arange(g, device=vals.device)[None, :]
    w = torch.zeros((n_groups * g, d_in), dtype=torch.float32,
                    device=vals.device)
    w.index_put_((rows.reshape(-1), cols.reshape(-1).long()),
                  vals.reshape(-1).float(), accumulate=True)
    return w[:d_out]


def logits_at(weights: dict, config: dict,
              sequences: Sequence[torch.Tensor],
              positions: Sequence[torch.Tensor],
              quant: Optional[str] = None) -> List[torch.Tensor]:
    """For each sequence (int64 tokens on the weights' device), the
    float32 logits ``(len(positions), vocab)`` at ``positions``: what the
    model predicts for the token after each of those positions."""
    d = config["hidden_size"]
    heads = config["num_attention_heads"]
    kv_heads = config["num_key_value_heads"]
    head_dim = config.get("head_dim") or d // heads
    d_ff = config["intermediate_size"]
    eps = float(config["rms_norm_eps"])
    theta = float(config["rope_theta"])
    scale = float(config["attention_multiplier"])
    vocab = config["vocab_size"]
    table = weights["embed"]["table"]
    with no_tf32(), torch.no_grad():
        hs = [table[s.long()].float() for s in sequences]
        for lay in weights["layers"]:
            a, f = lay["attn"], lay["ffn"]
            wq, wk, wv, wo = (a[n]["kernel"].float()
                              for n in ("q", "k", "v", "o"))
            w_in = f["w_in"]["kernel"].float()
            w_gate = f["w_gate"]["kernel"].float()
            w_out = dense_w_out(f["w_out"], d, d_ff).T
            for i, h in enumerate(hs):
                t = h.shape[0]
                x = _rms(h, lay["ln1"]["scale"], eps)
                q = _rope(_linear(x, wq, quant).reshape(t, heads, head_dim),
                          theta)
                k = _rope(_linear(x, wk, quant).reshape(t, kv_heads,
                                                        head_dim), theta)
                v = _linear(x, wv, quant).reshape(t, kv_heads, head_dim)
                att = _attend(q, k, v, scale).reshape(t, heads * head_dim)
                h = h + _linear(att, wo, quant)
                x = _rms(h, lay["ln2"]["scale"], eps)
                y = F.silu(_linear(x, w_gate, quant)) * _linear(x, w_in,
                                                                 quant)
                hs[i] = h + _linear(y, w_out, quant)
            del wq, wk, wv, wo, w_in, w_gate, w_out
        head = table[:vocab].float().T
        out = []
        for h, pos in zip(hs, positions):
            x = _rms(h[pos.long()], weights["final_norm"]["scale"], eps)
            out.append(_linear(x, head, quant))
        return out
