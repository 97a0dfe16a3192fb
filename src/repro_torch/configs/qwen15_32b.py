"""qwen1.5-32b [dense] — MHA with QKV bias.

64L d_model=5120 40H (kv=40, i.e. full MHA) d_ff=27392 vocab=152064.
[hf:Qwen/Qwen1.5-32B family; bias per Qwen1.5 reference config]
"""
from repro_torch.configs.base import ModelConfig, scale_down

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_head=128,
    d_ff=27_392,
    vocab=152_064,
    attn_kind="gqa",
    qkv_bias=True,
    layer_pattern=("attn",),
    source="hf:Qwen/Qwen1.5-32B",
)


def smoke():
    return scale_down(CONFIG, n_heads=4, n_kv_heads=4)
