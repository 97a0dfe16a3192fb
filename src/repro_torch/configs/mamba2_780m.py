"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128.  [arXiv:2405.21060]
d_inner = 2·d_model = 3072, head_dim 64 → 48 SSD heads.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, scale_down

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,                        # attention-free; kept for API shape
    n_kv_heads=1,
    d_head=64,
    d_ff=0,
    vocab=50_280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk=256),
    layer_pattern=("ssm",),
    gated_ffn=False,
    source="arXiv:2405.21060; hf:state-spaces/mamba2-780m",
)


def smoke():
    return scale_down(CONFIG, d_model=64, n_heads=1, n_kv_heads=1)
