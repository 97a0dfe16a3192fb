"""Deterministic synthetic LM data pipeline, per-host sharded.

A copy of ``repro.train.data`` (it uses numpy alone): the same batches,
byte for byte, from the same ``DataConfig``.

Production properties this reproduces:

* **Determinism / replayability** — every batch is a pure function of
  ``(seed, step, host)``: restart-from-checkpoint replays the exact stream
  with no data-loader state to save (the fault-tolerance path in
  train/fault.py relies on this).
* **Per-host sharding** — each host generates only its shard of the global
  batch (``host_id``/``n_hosts``), one shard per process.
* **Structured tokens** — Zipf-distributed unigrams mixed with short
  Markov-ish repeats so the loss actually decreases (pure-uniform tokens
  would pin CE at log V and mask training bugs).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "make_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.2
    repeat_prob: float = 0.3           # P(copy a recent token) — learnable
    family: str = "dense"              # vlm/audio need frontend stubs
    d_frontend: int = 0
    frontend_tokens: int = 0


def _token_block(rng: np.random.Generator, cfg: DataConfig, b: int,
                 s: int) -> np.ndarray:
    base = rng.zipf(cfg.zipf_alpha, size=(b, s)).astype(np.int64)
    tokens = (base - 1) % cfg.vocab
    # inject copy-structure: with prob p, token t = token t-k (k in 1..8)
    copy_mask = rng.uniform(size=(b, s)) < cfg.repeat_prob
    lags = rng.integers(1, 9, size=(b, s))
    idx = np.maximum(np.arange(s)[None, :] - lags, 0)
    copied = np.take_along_axis(tokens, idx, axis=1)
    tokens = np.where(copy_mask, copied, tokens)
    return tokens.astype(np.int32)


def make_batch(cfg: DataConfig, step: int, *, host_id: int = 0,
               n_hosts: int = 1) -> Dict[str, np.ndarray]:
    """The batch for ``step`` (this host's shard)."""
    assert cfg.global_batch % n_hosts == 0
    b = cfg.global_batch // n_hosts
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host_id]))
    s = cfg.seq_len
    out: Dict[str, np.ndarray] = {}
    if cfg.family == "vlm":
        ft = cfg.frontend_tokens
        text = _token_block(rng, cfg, b, s - ft + 1)
        out["patch_embeds"] = rng.standard_normal(
            (b, ft, cfg.d_frontend)).astype(np.float32)
        out["tokens"] = text[:, :-1]
        out["labels"] = text[:, 1:]
    elif cfg.family == "audio":
        text = _token_block(rng, cfg, b, s + 1)
        out["frames"] = rng.standard_normal(
            (b, s, cfg.d_frontend)).astype(np.float32)
        out["tokens"] = text[:, :-1]
        out["labels"] = text[:, 1:]
    else:
        text = _token_block(rng, cfg, b, s + 1)
        out["tokens"] = text[:, :-1]
        out["labels"] = text[:, 1:]
    return out


class SyntheticLM:
    """Iterator facade with explicit step addressing (seekable)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1,
                 start_step: int = 0):
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.step = start_step

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = make_batch(self.cfg, self.step, host_id=self.host_id,
                           n_hosts=self.n_hosts)
        self.step += 1
        return batch

    def seek(self, step: int) -> "SyntheticLM":
        self.step = step
        return self
