"""granite-moe-1b-a400m [moe] — 32 experts top-8.

24L d_model=1024 16H (GQA kv=8) d_ff=512(expert) vocab=49155, MoE 32e top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, scale_down

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab=49_155,
    attn_kind="gqa",
    moe=MoEConfig(n_experts=32, top_k=8, n_shared=0, d_ff_expert=512,
                  score_fn="softmax", capacity_factor=1.25,
                  dispatch="einsum"),
    layer_pattern=("moe",),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)


def smoke():
    return scale_down(CONFIG)
