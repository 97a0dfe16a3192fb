"""pixtral-12b [vlm] — Pixtral-ViT frontend (stub) + Mistral-NeMo backbone.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
[hf:mistralai/Pixtral-12B-2409]
The vision frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (d_vit=1024) for the first 1024 positions of
the sequence; the backbone projects and consumes them.
"""
from repro_torch.configs.base import ModelConfig, scale_down

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14_336,
    vocab=131_072,
    attn_kind="gqa",
    layer_pattern=("attn",),
    frontend="vision",
    d_frontend=1024,
    frontend_tokens=1024,
    source="hf:mistralai/Pixtral-12B-2409",
)


def smoke():
    return scale_down(CONFIG)
