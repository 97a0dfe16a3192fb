"""nemotron-4-15b [dense] — GQA, squared-ReLU, untied embeddings.

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.  [arXiv:2402.16819]
Squared-ReLU MLP (no gating), RoPE.
"""
from repro_torch.configs.base import ModelConfig, scale_down

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=24_576,
    vocab=256_000,
    attn_kind="gqa",
    activation="relu2",
    gated_ffn=False,
    tie_embeddings=False,
    layer_pattern=("attn",),
    source="arXiv:2402.16819",
)


def smoke():
    return scale_down(CONFIG)
