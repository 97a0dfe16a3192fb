"""A generic GQA decoder with an RgCSR FFN down-projection: its weights,
drawn from the seed on the card, and the port's configuration of it.

The weights are a tree of tensors in the layout the port's
``LanguageModel`` takes (``{"embed", "final_norm", "layers": [...]}``, each
layer's down-projection as its nonzeros in the slot-major arrays the port
stores: ``values2d``, ``columns2d``, ``chunk_group``, ``chunk_first``).
The benchmark makes them; the program and the plain reference are each
handed the same tensors.  They are drawn in a few large calls, one per
kind of weight over all layers, in the dtype they are served in.
"""
from __future__ import annotations

import torch

from perfbench import counts

SUBLANES = 8        # slot rows of one chunk of the slot-major layout
COLUMN_LAYERS = 8   # layers whose kept columns are drawn in one call


def check_generic(config: dict) -> None:
    """Refuse a configuration the port's generic decoder would not run as
    stated: unit multipliers, RMSNorm eps 1e-6, SiLU, no biases."""
    s = counts.lm_shapes(config)
    want = {"attention_multiplier": s["head_dim"] ** -0.5,
            "embedding_multiplier": 1.0, "residual_multiplier": 1.0,
            "logits_scaling": 1.0, "rms_norm_eps": 1e-6}
    off = {k: config.get(k) for k, v in want.items()
           if abs(float(config.get(k, v)) - v) > 1e-12 * max(1.0, v)}
    if config.get("hidden_act", "silu") != "silu":
        off["hidden_act"] = config["hidden_act"]
    for key in ("attention_bias", "mlp_bias"):
        if config.get(key):
            off[key] = config[key]
    if not config.get("tie_word_embeddings", True):
        off["tie_word_embeddings"] = False
    if off:
        raise ValueError(f"{config['name']}: the port's decoder cannot run "
                         f"{off} as stated")


def model_config(config: dict):
    """The port's ``ModelConfig`` of the configuration file."""
    from repro_torch.configs.base import ModelConfig, SparsityConfig
    check_generic(config)
    s = counts.lm_shapes(config)
    sp = config["sparse_ffn"]
    serving = config["serving"]
    return ModelConfig(
        name=config["name"], family="dense", n_layers=s["layers"],
        d_model=s["d"], n_heads=s["heads"], n_kv_heads=s["kv_heads"],
        d_head=s["head_dim"], d_ff=s["d_ff"], vocab=s["vocab"],
        attn_kind="gqa", rope_theta=float(config["rope_theta"]),
        layer_pattern=("attn",), activation="silu", gated_ffn=True,
        tie_embeddings=True,
        sparsity=SparsityConfig(enabled=bool(sp["enabled"]),
                                density=float(sp["density"]),
                                group_size=int(sp["group_size"]),
                                impl="kernel"),
        dtype=serving["dtype"], param_dtype=serving["dtype"],
        kv_cache_dtype=serving["kv_cache_dtype"], source=config["source"])


def padded_vocab(config: dict, multiple: int = 256) -> int:
    """Rows of the embedding table: the vocabulary padded to a multiple of
    256, as the port lays it out (the padding rows' logits are masked)."""
    v = config["vocab_size"]
    return -(-v // multiple) * multiple


def _kept_columns(gen, layers: int, n_lanes: int, d_in: int, k: int,
                  device) -> torch.Tensor:
    """``(layers, n_lanes, k)`` int32: each lane's ``k`` kept columns of
    ``d_in``, a uniform draw, ascending."""
    out = []
    for lo in range(0, layers, COLUMN_LAYERS):
        n = min(COLUMN_LAYERS, layers - lo)
        scores = torch.rand((n * n_lanes, d_in), generator=gen,
                            device=device)
        cols = torch.topk(scores, k, dim=1, sorted=False).indices
        out.append(torch.sort(cols, dim=1).values.to(torch.int32)
                   .reshape(n, n_lanes, k))
        del scores, cols
    return torch.cat(out)


def make_weights(config: dict, seed: int, device) -> dict:
    """The weight tree of ``config`` drawn from ``seed`` on ``device``, in
    the serving dtype."""
    s = counts.lm_shapes(config)
    dtype = getattr(torch, config["serving"]["dtype"])
    n_layers, d, dh = s["layers"], s["d"], s["head_dim"]
    hq, hkv, f = s["heads"] * dh, s["kv_heads"] * dh, s["d_ff"]
    g = int(config["sparse_ffn"]["group_size"])
    k = s["w_out_nnz_per_row"]
    n_groups = -(-d // g)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dtype).mul_(std)

    with torch.no_grad():
        q = normal((n_layers, d, hq), d ** -0.5)
        kk = normal((n_layers, d, hkv), d ** -0.5)
        v = normal((n_layers, d, hkv), d ** -0.5)
        o = normal((n_layers, hq, d), hq ** -0.5)
        w_in = normal((n_layers, d, f), d ** -0.5)
        w_gate = normal((n_layers, d, f), d ** -0.5)
        values = normal((n_layers, n_groups * k, g), k ** -0.5)
        cols = _kept_columns(gen, n_layers, n_groups * g, f, k, device)
        # lane-major (group, lane, slot) -> slot-major (group · k + slot, lane)
        columns = cols.reshape(n_layers, n_groups, g, k).transpose(2, 3) \
            .reshape(n_layers, n_groups * k, g).contiguous()
        del cols
        table = normal((padded_vocab(config), d), d ** -0.5)
        ones = torch.ones(d, dtype=dtype, device=device)
        per = k // SUBLANES
        chunk_group = torch.arange(n_groups, dtype=torch.int32,
                                   device=device).repeat_interleave(per)
        chunk_first = torch.zeros(n_groups * per, dtype=torch.int32,
                                  device=device)
        chunk_first[::per] = 1
    layers = [{
        "ln1": {"scale": ones},
        "attn": {"q": {"kernel": q[i]}, "k": {"kernel": kk[i]},
                 "v": {"kernel": v[i]}, "o": {"kernel": o[i]}},
        "ln2": {"scale": ones},
        "ffn": {"w_in": {"kernel": w_in[i]},
                "w_out": {"values2d": values[i], "columns2d": columns[i],
                          "chunk_group": chunk_group,
                          "chunk_first": chunk_first},
                "w_gate": {"kernel": w_gate[i]}},
    } for i in range(n_layers)]
    return {"embed": {"table": table}, "final_norm": {"scale": ones},
            "layers": layers}
