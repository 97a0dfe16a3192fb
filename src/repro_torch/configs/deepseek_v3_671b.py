"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed top-8 + MTP.

61L d_model=7168 128H (GQA kv=128 → MLA) d_ff=2048(expert) vocab=129280,
MoE 256e top-8.  [arXiv:2412.19437; hf]
First 3 layers use dense FFN (d_ff_dense=18432 per the release); MoE layers
use 2048-wide experts with 1 shared expert.  Scoring: sigmoid + aux-loss-free
bias; MTP depth 1.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, scale_down

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    d_ff=18432,                      # dense layers (first 3)
    vocab=129_280,
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, d_ff_expert=2048,
                  score_fn="sigmoid", aux_free_bias=True,
                  capacity_factor=1.25, dispatch="einsum", n_dense_layers=3),
    prefix_pattern=("attn",) * 3,
    layer_pattern=("moe",),
    mtp_depth=1,
    rope_theta=10_000.0,
    source="arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3",
)


def smoke():
    return scale_down(CONFIG, prefix_pattern=("attn",), n_layers=3)
