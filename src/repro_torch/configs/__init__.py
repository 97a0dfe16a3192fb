"""Architecture registry + small real inputs for smoke runs.

``get_config(arch)`` returns the exact published config; ``get_smoke(arch)``
the reduced same-family smoke config.  ``base.py`` and the arch modules are
copies of the JAX package's (they use only ``dataclasses``).
``input_specs(cfg, shape)`` returns ``meta`` tensors standing for every
model input of a cell — the reference's shapes and dtypes, nothing
allocated (the dry run's inputs, ``launch/dryrun.py``).
``concrete_inputs`` materializes small real batches as torch tensors, from
the same numpy draws as the reference's, so both packages see the same
tokens for a seed.
"""
from __future__ import annotations

import importlib
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.core.formats import resolve_device

ARCH_IDS = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "mamba2-780m": "mamba2_780m",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "granite-3-2b": "granite_3_2b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen1.5-32b": "qwen15_32b",
    "minicpm3-4b": "minicpm3_4b",
    "pixtral-12b": "pixtral_12b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

__all__ = ["ARCH_IDS", "SHAPES", "get_config", "get_smoke", "input_specs",
           "concrete_inputs"]


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; options: {sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_IDS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).smoke()


def input_specs(cfg: ModelConfig, shape: ShapeConfig | str
                ) -> Dict[str, torch.Tensor]:
    """``meta`` tensors for every model input of one (arch × shape) cell,
    of the reference's shapes, int32 tokens and labels and float32
    frontend stubs.

    * train/prefill: the full token batch (+ frontend stubs).
    * decode/long_decode: the one-token step input.
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    b, s = shape.global_batch, shape.seq_len

    def spec(dtype, *dims):
        return torch.empty(dims, dtype=dtype, device="meta")
    i32, f32 = torch.int32, torch.float32
    if shape.kind not in ("train", "prefill"):
        return {"tokens": spec(i32, b, 1)}
    specs = {}
    text = s
    if cfg.family == "vlm":
        text = s - cfg.frontend_tokens
        specs["patch_embeds"] = spec(f32, b, cfg.frontend_tokens,
                                     cfg.d_frontend)
    elif cfg.family == "audio":
        specs["frames"] = spec(f32, b, s, cfg.d_frontend)
    specs["tokens"] = spec(i32, b, text)
    if shape.kind == "train":
        specs["labels"] = spec(i32, b, text)
    return specs


def concrete_inputs(cfg: ModelConfig, *, batch: int, seq: int,
                    kind: str = "train", seed: int = 0,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """Small real batches for smoke runs: int32 tokens (and labels, and the
    frontend stubs' float32 inputs), drawn in the reference's order."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def toks(b, s):
        return torch.from_numpy(
            rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)).to(dev)

    def normal(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    out = {}
    if cfg.family == "vlm":
        ft = cfg.frontend_tokens
        assert seq > ft, f"seq {seq} must exceed frontend_tokens {ft}"
        out["patch_embeds"] = normal(batch, ft, cfg.d_frontend)
        out["tokens"] = toks(batch, seq - ft)
        if kind == "train":
            out["labels"] = toks(batch, seq - ft)
    elif cfg.family == "audio":
        out["frames"] = normal(batch, seq, cfg.d_frontend)
        out["tokens"] = toks(batch, seq)
        if kind == "train":
            out["labels"] = toks(batch, seq)
    else:
        out["tokens"] = toks(batch, seq)
        if kind == "train":
            out["labels"] = toks(batch, seq)
    return out
