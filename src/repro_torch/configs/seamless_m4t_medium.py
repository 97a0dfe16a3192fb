"""seamless-m4t-medium [audio] — encoder-decoder, multimodal (stub frontend).

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.  [arXiv:2308.11596]
Encoder-decoder: 12 encoder + 12 decoder layers; the speech frontend is a
STUB — ``input_specs()`` provides precomputed frame embeddings (d=1024)
consumed by the encoder.
"""
from repro_torch.configs.base import ModelConfig, scale_down

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,                      # decoder layers
    n_enc_layers=12,
    enc_dec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab=256_206,
    attn_kind="gqa",
    activation="gelu",
    layer_pattern=("dec_attn",),
    frontend="audio",
    d_frontend=1024,
    source="arXiv:2308.11596; hf:facebook/seamless-m4t-medium",
)


def smoke():
    return scale_down(CONFIG, n_layers=2, n_enc_layers=2)
