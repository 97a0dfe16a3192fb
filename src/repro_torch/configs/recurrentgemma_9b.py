"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 rec.

38L d_model=4096 16H (GQA kv=1 → MQA) d_ff=12288 vocab=256000, window 2048.
[arXiv:2402.19427 (Griffin); hf:google/recurrentgemma-9b]
Pattern: (rec, rec, attn_local) repeating, starting with two recurrent
blocks — 38 = 2 + 12·3.
"""
from repro_torch.configs.base import ModelConfig, scale_down

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,                      # MQA
    d_head=256,
    d_ff=12_288,
    vocab=256_000,
    attn_kind="gqa",
    window=2048,
    prefix_pattern=("rec", "rec"),
    layer_pattern=("attn_local", "rec", "rec"),
    activation="gelu",
    source="arXiv:2402.19427; hf:google/recurrentgemma-9b",
)


def smoke():
    return scale_down(CONFIG, n_kv_heads=1, prefix_pattern=("rec", "rec"))
