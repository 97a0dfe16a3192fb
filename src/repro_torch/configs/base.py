"""Model / run configuration dataclasses shared by all architectures.

Each assigned architecture file (``src/repro/configs/<id>.py``) exports:

* ``CONFIG``  — the exact published configuration,
* ``smoke()`` — a reduced same-family config for CPU smoke tests,
* (shapes come from :data:`SHAPES`, shared by all LM archs).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "MLAConfig",
           "SparsityConfig", "ShapeConfig", "SHAPES", "scale_down"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0                  # shared (always-on) experts
    d_ff_expert: int = 0               # per-expert hidden dim
    score_fn: str = "softmax"          # softmax | sigmoid (DeepSeek-V3)
    aux_free_bias: bool = False        # DeepSeek-V3 aux-loss-free balancing
    capacity_factor: float = 1.25
    dispatch: str = "einsum"           # einsum (GShard baseline) | scatter (optimized)
    n_dense_layers: int = 0            # leading dense-FFN layers (DeepSeek-V3: 3)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256                   # SSD chunk length


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 0               # 0 = full-rank q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """The paper's technique as a first-class feature: store selected weight
    matrices in RgCSR (pruned) and run SpMM through the Pallas kernel."""
    enabled: bool = False
    format: str = "rgcsr"
    density: float = 0.25              # kept fraction after magnitude pruning
    group_size: int = 128
    targets: Tuple[str, ...] = ("ffn",)  # which layer families to sparsify
    impl: str = "ref"                  # ref (jnp oracle, SPMD) | kernel (Pallas)

    def impl_is_kernel(self) -> bool:
        return self.impl == "kernel"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                    # 0 -> d_model // n_heads
    # --- attention ---
    attn_kind: str = "gqa"             # gqa | mla
    qkv_bias: bool = False             # Qwen1.5
    rope_theta: float = 10_000.0
    window: Optional[int] = None       # local-attention window
    # --- block pattern ---
    layer_pattern: Tuple[str, ...] = ("attn",)   # period, repeated
    prefix_pattern: Tuple[str, ...] = ()          # unrolled leading layers
    # --- ffn ---
    activation: str = "silu"           # silu | gelu | relu2 (Nemotron squared-ReLU)
    gated_ffn: bool = True             # SwiGLU/GeGLU vs plain MLP
    # --- submodule configs ---
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    mla: MLAConfig = MLAConfig()
    sparsity: SparsityConfig = SparsityConfig()
    # --- embeddings / output ---
    tie_embeddings: bool = True
    mtp_depth: int = 0                 # DeepSeek-V3 multi-token prediction modules
    # --- multimodal frontend stubs ---
    frontend: str = "none"             # none | vision | audio
    d_frontend: int = 0                # embedding dim delivered by the stub
    frontend_tokens: int = 0           # how many positions the stub fills (vlm)
    # --- enc-dec (seamless) ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    # --- numerics / serving ---
    pad_vocab_to: int = 256            # Megatron-style: pad embedding rows so
                                       # the vocab dim shards evenly over any
                                       # mesh axis (logits past `vocab` are
                                       # masked to -inf in the loss/sampler)
    dtype: str = "bfloat16"            # compute dtype
    param_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"   # int8 available (beyond-paper opt)
    long_context_fallback: str = "window"  # full-attn archs at 500k (DESIGN §9)
    fallback_window: int = 32_768
    remat: str = "none"                # none | full | dots  (set by trainer)
    # --- activation sharding (set by the launcher per mesh/cell) ---
    act_shard: bool = False            # emit with_sharding_constraint()s
    attn_shard_mode: str = "none"      # heads | repeat | seq | none
    shard_batch: bool = True           # batch dim divisible by batch axes?
    mesh_batch_axes: Tuple[str, ...] = ("data",)   # ("pod","data") multi-pod
    # --- notes for DESIGN/EXPERIMENTS provenance ---
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_to
        return -(-self.vocab // m) * m

    @property
    def pattern_repeats(self) -> int:
        body = self.n_layers - len(self.prefix_pattern)
        assert body % len(self.layer_pattern) == 0, (
            f"{self.name}: {body} body layers not divisible by pattern "
            f"{self.layer_pattern}")
        return body // len(self.layer_pattern)

    @property
    def is_subquadratic(self) -> bool:
        """True if decode state is O(1)/O(window) in sequence length."""
        kinds = set(self.layer_pattern) | set(self.prefix_pattern)
        return kinds <= {"ssm", "rec", "attn_local"}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode | long_decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "long_decode"),
}


def scale_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Build a reduced same-family smoke config.

    Keeps the block pattern / attention kind / MoE-ness, shrinks widths.
    """
    period = len(cfg.layer_pattern)
    n_prefix = len(cfg.prefix_pattern)
    defaults = dict(
        n_layers=n_prefix + 2 * period,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        d_head=16,
        d_ff=128,
        vocab=512,
        window=min(cfg.window, 32) if cfg.window else None,
        fallback_window=64,
    )
    if cfg.moe.n_experts:
        defaults["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff_expert=32,
            n_dense_layers=min(cfg.moe.n_dense_layers, 1))
    if cfg.attn_kind == "mla":
        defaults["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                    qk_nope_head_dim=16, qk_rope_head_dim=8,
                                    v_head_dim=16)
    if "ssm" in cfg.layer_pattern:
        defaults["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16,
                                              chunk=16)
    if cfg.frontend != "none":
        defaults["d_frontend"] = 32
        defaults["frontend_tokens"] = min(cfg.frontend_tokens, 8)
    if cfg.enc_dec:
        defaults["n_enc_layers"] = 2
    defaults.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **defaults)
