"""Serving engine: batch-synchronous prefill + greedy/sampled decode.

The PyTorch counterpart of ``repro.serve.engine`` up to ``generate``:
``Engine(model_cfg, ServeConfig(...)).generate(prompts, max_new_tokens)``
runs the prompt through ``LanguageModel.prefill`` and then one
``decode_step`` per new token, with the reference's EOS rules.  With an
RgCSR FFN (``cfg.sparsity.enabled``, ``impl="kernel"``) every layer's
``w_out`` product runs through K2, and ``Engine.__init__`` builds each
layer's K2 plan at the compute dtype (``plans_warmed`` counts them: one per
layer).

``ServeConfig`` keeps every field of the reference's; ``generate`` reads
``max_seq``, ``temperature``, ``top_k``, ``eos_id`` and ``seed`` and
ignores the rest, as the reference's does.  Continuous batching
(``Request``, ``EngineSession``, ``serve()``), paged caches, snapshots and
the router are not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import LanguageModel
from repro_torch.serve import device_loop

__all__ = ["ServeConfig", "Engine"]


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 1024
    n_slots: int = 4                    # decode batch size
    temperature: float = 0.0            # 0 → greedy
    top_k: int = 0
    eos_id: int = -1                    # -1 → run to max_new_tokens
    seed: int = 0
    # --- KV-cache layout ---
    kv_layout: str = "paged"            # paged | dense
    page_size: int = 16                 # tokens per KV page
    n_pages: int = 0                    # 0 → auto: dense capacity + null page
    # --- fused decode loop ---
    decode_chunk: int = 8
    # --- overload behavior ---
    admission_policy: str = "prompt"
    strict: bool = False
    deadline_s: float = 0.0
    # --- KV-page integrity ---
    kv_integrity: bool = False


class Engine:
    """``params``: a parameter tree for the model (see
    :mod:`repro_torch.models.model`); without one the model draws its own
    from ``serve_cfg.seed`` on ``device``."""

    def __init__(self, model_cfg, serve_cfg: ServeConfig, params=None, *,
                 device="cuda"):
        self.cfg = serve_cfg
        self.model = LanguageModel(model_cfg, params, device=device,
                                   seed=serve_cfg.seed)
        self.device = self.model.device
        self._decode = device_loop.make_decode_step(self.model)
        self._generator = torch.Generator(device=self.device).manual_seed(
            serve_cfg.seed)
        # Sparse (RgCSR) weights: build every layer's K2 plan at model load,
        # at the compute dtype the layers will ask for.
        self.plans_warmed = 0
        if model_cfg.sparsity.enabled and model_cfg.sparsity.impl_is_kernel():
            self.plans_warmed = ops.warm_plans_from_params(
                self.model, dtype=self.model.compute_dtype)

    def _prefill(self, batch):
        return self.model.prefill(batch, self.cfg.max_seq)

    def _sample(self, logits) -> torch.Tensor:
        return device_loop.sample_tokens(
            logits, self._generator, self.cfg.temperature, self.cfg.top_k)

    def generate(self, prompts, max_new_tokens: int = 32) -> np.ndarray:
        """Batch-synchronous generation (all prompts the same length).

        Output is always ``(b, max_new_tokens)``; with ``eos_id >= 0``,
        sequences that sample EOS (including at prefill — the first token
        counts) stop and their remaining positions are filled with
        ``eos_id``; once every sequence has finished the decode loop exits.
        Without ``eos_id`` the host never waits for the card before the
        end.
        """
        prompts = np.asarray(prompts, np.int32)
        b, s = prompts.shape
        if s + max_new_tokens - 1 > self.cfg.max_seq:
            raise ValueError(
                f"prompt of {s} tokens + {max_new_tokens} new ones needs "
                f"{s + max_new_tokens - 1} cache positions; max_seq is "
                f"{self.cfg.max_seq}")
        eos = self.cfg.eos_id
        with torch.inference_mode():
            batch = {"tokens": torch.from_numpy(prompts).to(self.device)}
            logits, caches = self._prefill(batch)
            tok = self._sample(logits)[:, None]
            done = ((tok[:, 0] == eos).cpu().numpy() if eos >= 0
                    else np.zeros(b, bool))
            outs = [tok]
            for _ in range(max_new_tokens - 1):
                if eos >= 0 and done.all():
                    pad = torch.full((b, 1), eos, dtype=torch.int32,
                                     device=self.device)
                    outs.extend([pad] * (max_new_tokens - len(outs)))
                    break
                logits, caches = self._decode(caches, tok)
                nxt = self._sample(logits)
                if eos >= 0:
                    nxt = torch.where(torch.from_numpy(done).to(self.device),
                                      eos, nxt)
                    done |= (nxt == eos).cpu().numpy()
                tok = nxt[:, None]
                outs.append(tok)
            return torch.cat(outs, dim=1).cpu().numpy()
