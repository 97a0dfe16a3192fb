"""minicpm3-4b [dense] — MLA (MiniCPM3 uses DeepSeek-style latent attention).

62L d_model=2560 40H d_ff=6400 vocab=73448.  [hf:openbmb/MiniCPM3-4B]
MLA dims per release: q_lora 768, kv_lora 256, nope 64, rope 32, v 64.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, scale_down

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_head=64,
    d_ff=6400,
    vocab=73_448,
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    layer_pattern=("attn",),
    source="hf:openbmb/MiniCPM3-4B",
)


def smoke():
    return scale_down(CONFIG)
