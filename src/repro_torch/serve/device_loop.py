"""The sampler and the decode-step factory shared by the serving paths.

The PyTorch counterpart of the host half of ``repro.serve.device_loop``:

* :func:`sample_tokens` — ``(logits, generator) → tokens``: greedy argmax
  in float32, or temperature / top-k sampling from an explicit
  ``torch.Generator``.  Sampled streams differ from the reference's (the
  generators differ); greedy ones do not.
* :func:`make_decode_step` — the one definition of "one decode step".

The fused multi-step decode loop (``build_fused_decode``) comes with the
continuous-batching slice, as a CUDA graph (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sample_tokens", "make_decode_step"]


def sample_tokens(logits, generator: Optional[torch.Generator],
                  temperature: float, top_k: int) -> torch.Tensor:
    """``logits`` (b, s, V): the last position is sampled in float32 →
    int32 tokens (b,).  ``temperature <= 0`` is greedy argmax (first of
    equal maxima, as the reference's) and draws nothing; otherwise top-k
    keeps the ``top_k`` largest logits (``top_k`` clamped to the vocab:
    ``>= vocab`` keeps every token, ``<= 0`` disables filtering)."""
    logits = logits[:, -1, :].float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    k = min(int(top_k), logits.shape[-1])
    if 0 < k < logits.shape[-1]:
        kth = torch.topk(logits, k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, logits.new_full((), -1e30), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def make_decode_step(model, shape_kind: str = "decode"):
    """``(caches, tokens) → (logits, caches)`` for ``model``."""
    def decode_step(caches, tokens):
        return model.decode_step(caches, tokens, shape_kind=shape_kind)
    return decode_step
