"""Trainer: train step + data + checkpoints + watchdog + restart loop.

The PyTorch counterpart of ``repro.train.trainer`` on one device.  It
composes ``launch/steps.py`` (the train step with microbatch
accumulation), ``train/data.py`` (the deterministic stream),
``train/checkpoint.py`` (atomic async checkpoints) and ``train/fault.py``
(watchdog and restartable loop).  The model holds its parameters; the
trainer's state is ``(model.tensors(), optimizer state)``, updated in
place by each step.

Checkpoints hold ``{"params", "opt_state"}`` in the reference's tree
layout (body layers stacked, ``models.reference_layout``), so that either
package's trainer restores the other's.  A mesh or partitioner (the
reference's sharded training) waits for row-sharded SpMV and the
multi-device work and raises.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.formats import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import LanguageModel
from repro_torch.models.model import port_layout, reference_layout
from repro_torch.train.checkpoint import CheckpointManager, latest_step
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.train.fault import FaultConfig, FaultInjector, \
    RestartableLoop, Watchdog
from repro_torch.train.optimizer import OptimizerConfig

log = logging.getLogger("repro_torch.trainer")

__all__ = ["TrainConfig", "Trainer"]


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    microbatches: int = 1
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    seed: int = 0
    opt: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    fault: FaultConfig = dataclasses.field(default_factory=FaultConfig)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _shape_only(t: torch.Tensor) -> np.ndarray:
    """An empty array of ``t``'s rank: what a restore's template needs."""
    return np.zeros((0,) * t.dim(), np.float32)


def _flat(tree, leaf, prefix: str = "") -> Dict[str, np.ndarray]:
    """``leaf`` of each tensor of a nested dict, keyed by its
    ``"/"``-joined path."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, leaf, key + "/"))
        else:
            out[key] = leaf(v)
    return out


class Trainer:
    """``Trainer(model_cfg, train_cfg, device=)``; ``init_state(seq_len,
    global_batch, params=None)`` builds the model (drawn from
    ``train_cfg.seed`` on ``device``, or from a parameter tree in the
    port's layout, e.g. ``models.params_from_numpy``) and the optimizer
    state; ``run(state)`` trains with checkpoints and restarts;
    ``restore_latest()`` loads the newest checkpoint of ``ckpt_dir``."""

    def __init__(self, model_cfg, train_cfg: TrainConfig, *, mesh=None,
                 partitioner=None,
                 fault_injector: Optional[FaultInjector] = None,
                 device="cuda"):
        if mesh is not None or partitioner is not None:
            raise NotImplementedError(
                "training on a mesh (mesh=, partitioner=) is not ported yet "
                "(ROADMAP queue 1, item 3: sharded training)")
        self.cfg = train_cfg
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        self.model: Optional[LanguageModel] = None
        self.fault_injector = fault_injector
        self.data_cfg = DataConfig(
            vocab=model_cfg.vocab,
            seq_len=model_cfg.frontend_tokens + 32
            if model_cfg.family == "vlm" else 0,  # init_state sets it
            global_batch=0,
            family=model_cfg.family, d_frontend=model_cfg.d_frontend,
            frontend_tokens=model_cfg.frontend_tokens, seed=train_cfg.seed)
        self.train_step = self.opt_init = None
        self._drawn = True           # the initial parameters came from seed
        self.ckpt = CheckpointManager(train_cfg.ckpt_dir,
                                      keep=train_cfg.ckpt_keep) \
            if train_cfg.ckpt_dir else None
        self.watchdog = Watchdog(train_cfg.fault)
        self.history: List[Dict[str, float]] = []

    # ------------------------------------------------------------------ API
    def init_state(self, seq_len: int, global_batch: int, params=None):
        self.data_cfg = dataclasses.replace(
            self.data_cfg, seq_len=seq_len, global_batch=global_batch)
        self._drawn = params is None
        self.model = LanguageModel(self.model_cfg, params,
                                   device=self.device, seed=self.cfg.seed)
        self.model.requires_grad_(True)
        self.train_step, self.opt_init = make_train_step(
            self.model, self.cfg.opt, self.cfg.microbatches)
        params = self.model.tensors()
        return params, self.opt_init(params)

    def _batch(self, step: int):
        return make_batch(self.data_cfg, step)

    def _checkpoint_tree(self, state, leaf=_host) -> dict:
        """``state`` in the reference's layout, each tensor as ``leaf``
        makes it (host numpy by default)."""
        params, opt_state = state
        ref = lambda tree: reference_layout(  # noqa: E731
            self.model_cfg, _flat(tree, leaf))
        opt = {k: ref(v) if isinstance(v, dict) else leaf(v)
               for k, v in opt_state.items()}
        return {"params": ref(params), "opt_state": opt}

    def restore_latest(self):
        """``(state, next step)`` from the newest checkpoint: parameters
        copied into the model's tensors, optimizer state on its device."""
        params = self.model.tensors()
        meta = {k: torch.empty_like(t, device="meta")
                for k, t in params.items()}
        like = self._checkpoint_tree((meta, self.opt_init(meta)),
                                     _shape_only)
        restored, manifest = self.ckpt.restore_latest(like)
        with torch.no_grad():
            for k, a in port_layout(self.model_cfg,
                                    restored["params"]).items():
                params[k].copy_(torch.from_numpy(np.asarray(a)))
        opt_state = {}
        for k, v in restored["opt_state"].items():
            if isinstance(v, dict):
                v = port_layout(self.model_cfg, v)
                opt_state[k] = _nest({key: torch.from_numpy(
                    np.array(a)).to(self.device) for key, a in v.items()},
                    params)
            else:
                opt_state[k] = torch.from_numpy(np.array(v)).to(self.device)
        log.info("restored checkpoint step %d", manifest["step"])
        return (params, opt_state), manifest["step"] + 1

    def run(self, state, start_step: int = 0,
            n_steps: Optional[int] = None):
        """Train with watchdog + checkpointing + restart-on-failure."""
        n_steps = n_steps if n_steps is not None else self.cfg.steps
        loop = RestartableLoop(self.cfg.fault)

        def step_fn(state, step):
            if self.fault_injector:
                self.fault_injector.check(step)
            t0 = time.time()
            params, opt_state = state
            batch = self._batch(step)
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                         batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            self.watchdog.observe(step, dt)
            metrics.update(step=step, step_time_s=dt)
            self.history.append(metrics)
            if step % self.cfg.log_every == 0:
                extra = "".join(f" {k}={metrics[k]:.4f}" for k in
                                ("ce", "load_balance", "mtp")
                                if k in metrics)
                log.info("step %d: loss=%.4f%s (%.2fs)", step,
                         metrics["loss"], extra, dt)
            if self.ckpt and step and step % self.cfg.ckpt_every == 0:
                self.ckpt.save(step, self._checkpoint_tree(
                    (params, opt_state)), extra={"data_step": step + 1})
            return params, opt_state

        def restore_fn():
            if not self.ckpt or latest_step(self.cfg.ckpt_dir) is None:
                if not self._drawn:
                    raise RuntimeError(
                        "no checkpoint to restart from, and the initial "
                        "parameters were given, not drawn from the seed")
                # no checkpoint yet: restart from the seed's parameters
                fresh = LanguageModel(self.model_cfg, device=self.device,
                                      seed=self.cfg.seed).tensors()
                params = self.model.tensors()
                with torch.no_grad():
                    for k, t in fresh.items():
                        params[k].copy_(t)
                return (params, self.opt_init(params)), start_step
            return self.restore_latest()

        state, step = loop.run(state, start_step, n_steps, step_fn,
                               restore_fn)
        if self.ckpt:
            self.ckpt.save(step - 1, self._checkpoint_tree(state))
            self.ckpt.wait()
        return state, step


def _nest(flat: Dict[str, torch.Tensor], params) -> Dict:
    """An optimizer state entry keyed like ``params`` from its flat form:
    keys that extend a parameter's name (Adafactor's ``.../vr``) become a
    dict under that name."""
    out: Dict = {}
    for key, t in flat.items():
        if key in params:
            out[key] = t
        else:
            name, leaf = key.rsplit("/", 1)
            out.setdefault(name, {})[leaf] = t
    return out
