"""Trainer: train step + data + checkpoints + watchdog + restart loop.

The PyTorch counterpart of ``repro.train.trainer``.  It composes
``launch/steps.py`` (the train step with microbatch accumulation),
``train/data.py`` (the deterministic stream), ``train/checkpoint.py``
(atomic async checkpoints) and ``train/fault.py`` (watchdog and
restartable loop).  The model holds its parameters; the trainer's state
is ``(model.tensors(), optimizer state)``, updated in place by each step.

Checkpoints hold ``{"params", "opt_state"}`` in the reference's tree
layout (body layers stacked, ``models.reference_layout``), so that either
package's trainer restores the other's.

On a mesh (``mesh=``, ``partitioner=``, a ``torch.distributed``
``DeviceMesh`` over every rank of the default group) the model's tensors
and the optimizer's moments are DTensors laid out by the partitioner's
rules, and every rank runs the same program on the same global batch
(the step takes its rows).  The parameters are drawn from the seed on
every rank, as on one device, and each rank keeps its slices.  A
checkpoint save gathers the whole tensors, rank 0 writes them, and every
rank waits at a barrier before the next step; restores (the restart
loop's too) lay the checkpoint out on this trainer's mesh, whatever mesh
wrote it.  With ``cfg.act_shard`` (as ``launch/train.py --mesh`` sets it)
on a mesh whose ``model`` axis has more than one rank the step computes
tensor-parallel (``launch/steps.py``); the trainer resolves the
attention's mode for that axis (``shardlib.attn_mode_for``: ``"none"`` by
divisibility, an explicit mode checked).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.core.formats import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import LanguageModel, shardlib
from repro_torch.models.model import port_layout, reference_layout
from repro_torch.sharding import layout
from repro_torch.sharding.partitioner import NamedSharding
from repro_torch.train.checkpoint import CheckpointManager, latest_step
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.train.fault import FaultConfig, FaultInjector, \
    RestartableLoop, Watchdog
from repro_torch.train.optimizer import OptimizerConfig

log = logging.getLogger("repro_torch.trainer")

__all__ = ["TrainConfig", "Trainer", "distribute_model", "lay_out_opt"]


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


def _flat(tree, leaf=lambda v: v, prefix: str = "") -> Dict:
    """``leaf`` of each leaf of a tree of dicts and lists, keyed by its
    ``"/"``-joined path."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(_flat(v, leaf, key + "/"))
        else:
            out[key] = leaf(v)
    return out


class Trainer:
    """``Trainer(model_cfg, train_cfg, mesh=, partitioner=, device=)``;
    ``init_state(seq_len, global_batch, params=None)`` builds the model
    (drawn from ``train_cfg.seed`` on ``device``, or from a parameter tree
    in the port's layout, e.g. ``models.params_from_numpy``) and the
    optimizer state, laid out on the mesh when there is one; ``run(state)``
    trains with checkpoints and restarts; ``restore_latest()`` loads the
    newest checkpoint of ``ckpt_dir``."""

    def __init__(self, model_cfg, train_cfg: TrainConfig, *, mesh=None,
                 partitioner=None,
                 fault_injector: Optional[FaultInjector] = None,
                 device="cuda"):
        self.cfg = train_cfg
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        self.mesh, self.partitioner = mesh, partitioner
        self._p_sh = self._o_sh = None
        if mesh is not None or partitioner is not None:
            self._check_mesh(mesh, partitioner)
            self.model_cfg = model_cfg = _attention_on(model_cfg, mesh)
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

    def _check_mesh(self, mesh, partitioner):
        if mesh is None or partitioner is None \
                or partitioner.mesh is not mesh:
            raise ValueError("training on a mesh takes the mesh and a "
                             "Partitioner of that mesh (mesh=, "
                             "partitioner=)")
        if mesh.size() != dist.get_world_size():
            raise ValueError(f"the mesh holds {mesh.size()} ranks, the "
                             f"default process group "
                             f"{dist.get_world_size()}: the trainer's "
                             f"barriers span the group")
        if self.device.type != mesh.device_type:
            raise ValueError(f"device {self.device} on a "
                             f"{mesh.device_type!r} mesh")

    @property
    def _writer(self) -> bool:
        """Whether this rank writes the checkpoints (rank 0 on a mesh)."""
        return self.mesh is None or dist.get_rank() == 0

    # ------------------------------------------------------------------ API
    def init_state(self, seq_len: int, global_batch: int, params=None):
        self.data_cfg = dataclasses.replace(
            self.data_cfg, seq_len=seq_len, global_batch=global_batch)
        self._drawn = params is None
        self.model = LanguageModel(self.model_cfg, params,
                                   device=self.device, seed=self.cfg.seed)
        self.model.requires_grad_(True)
        self.train_step, self.opt_init = make_train_step(
            self.model, self.cfg.opt, self.cfg.microbatches,
            partitioner=self.partitioner)
        if self.mesh is not None:
            spec = self.model.spec()
            self._p_sh = _flat(self.partitioner.param_shardings(spec))
            self._o_sh = self.partitioner.opt_shardings(
                spec, self.cfg.opt.name, self.cfg.opt.factored_min_dim)
            self._distribute_model()
        params = self.model.tensors()
        return params, self._lay_out_opt(self.opt_init(params))

    def _distribute_model(self):
        """Replace each of the model's tensors (the same whole value on
        every rank) by a DTensor of its sharding: rank ``r`` keeps its
        slices only."""
        distribute_model(self.model, self._p_sh)

    def _lay_out_opt(self, opt_state):
        """The optimizer state on the partitioner's ``opt_shardings``."""
        if self.mesh is None:
            return opt_state
        return lay_out_opt(opt_state, self._o_sh)

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

    def _save(self, step: int, state, extra=None):
        """A checkpoint of ``state``; on a mesh every rank gathers, rank 0
        writes (and waits for the write), and all meet at a barrier."""
        if self.mesh is None:
            self.ckpt.save(step, self._checkpoint_tree(state), extra=extra)
            return
        writer = self._writer
        tree = self._checkpoint_tree(
            state, lambda t: _host(layout.gather(t)) if writer
            else _shape_only(layout.gather(t)))
        if writer:
            self.ckpt.save(step, tree, extra=extra)
            self.ckpt.wait()
        dist.barrier()

    def _latest(self) -> Optional[int]:
        """The newest checkpoint's step, once this trainer's pending write
        (an asynchronous save just before a fault) and, on a mesh, rank
        0's have landed."""
        if not self.ckpt:
            return None
        self.ckpt.wait()
        if self.mesh is not None:
            dist.barrier()
        return latest_step(self.cfg.ckpt_dir)

    def restore_latest(self):
        """``(state, next step)`` from the newest checkpoint: parameters
        copied into the model's tensors (their slices on a mesh, whatever
        mesh wrote it), optimizer state on the device."""
        params = self.model.tensors()
        meta = {k: torch.empty(t.shape, dtype=t.dtype, device="meta")
                for k, t in params.items()}
        like = self._checkpoint_tree((meta, self.opt_init(meta)),
                                     _shape_only)
        if self.mesh is not None:
            return self._restore_on_mesh(params, like)
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

    def _checkpoint_shardings(self):
        """``NamedSharding``s in the checkpoint's (reference) layout: a
        stacked body leaf's is its layers' with a replicated leading
        dim."""
        mesh = self.mesh

        def stack(shs):
            spec = tuple(shs[0].spec)
            return shs[0] if not spec else NamedSharding(mesh,
                                                         (None,) + spec)
        rep = self.partitioner.replicated()
        opt = {"step": rep}
        for name, tree in self._o_sh.items():
            if name != "step":
                opt[name] = reference_layout(self.model_cfg, _flat(tree),
                                             stack)
        return {"params": reference_layout(self.model_cfg, self._p_sh,
                                           stack),
                "opt_state": opt}

    def _restore_on_mesh(self, params, like):
        restored, manifest = self.ckpt.restore_latest(
            like, shardings=self._checkpoint_shardings())

        def pick(node, r):
            return node if r is None or node.dim() == 0 \
                else layout.select(node, r)
        with torch.no_grad():
            for k, dt in port_layout(self.model_cfg, restored["params"],
                                     pick).items():
                params[k].to_local().copy_(dt.to_local())
        opt_state = {"step": restored["opt_state"]["step"].to_local()}
        for k, v in restored["opt_state"].items():
            if k != "step":
                opt_state[k] = _nest(port_layout(self.model_cfg, v, pick),
                                     params)
        log.info("restored checkpoint step %d onto mesh %s",
                 manifest["step"], tuple(self.mesh.shape))
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
                self._save(step, (params, opt_state),
                           extra={"data_step": step + 1})
            return params, opt_state

        def restore_fn():
            if self._latest() is None:
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
                        if self.mesh is None:
                            params[k].copy_(t)
                        else:
                            params[k].to_local().copy_(layout.local_chunk(
                                t, self.mesh, params[k].placements))
                return ((params, self._lay_out_opt(self.opt_init(params))),
                        start_step)
            return self.restore_latest()

        state, step = loop.run(state, start_step, n_steps, step_fn,
                               restore_fn)
        if self.ckpt:
            self._save(step - 1, state)
            self.ckpt.wait()
        return state, step


def distribute_model(model, shardings: Dict[str, NamedSharding],
                     device=None):
    """Replace each of ``model``'s tensors (the same whole value on every
    rank) by a DTensor of its sharding (``shardings`` keyed as
    ``model.tensors()``) on ``device`` (default: the sharding's): each
    rank keeps its slices only, and nothing is communicated."""
    for name, t in model.tensors().items():
        path, _, attr = name.replace("/", ".").rpartition(".")
        mod = model.get_submodule(path)
        dt = shardings[name].distribute(t.detach(), device=device)
        if attr in mod._parameters:
            mod._parameters[attr] = nn.Parameter(
                dt, requires_grad=t.requires_grad)
        else:
            mod._buffers[attr] = dt


def lay_out_opt(opt_state, opt_shardings):
    """``opt_state`` (of DTensor parameters) on ``opt_shardings``
    (``Partitioner.opt_shardings``'s tree); the step counter stays a
    plain tensor."""
    out = {"step": opt_state["step"]}
    for name, tree in opt_state.items():
        if name == "step":
            continue
        sh = _flat(opt_shardings[name])
        out[name] = _unflat({k: layout.relayout(v, sh[k].placements())
                             for k, v in _flat(tree).items()}, tree)
    return out


def _attention_on(cfg, mesh):
    """``cfg`` with its attention mode for tensor-parallel compute on
    ``mesh``'s ``model`` axis (unchanged without ``act_shard`` or that
    axis)."""
    names = tuple(mesh.mesh_dim_names or ())
    if not cfg.act_shard or "model" not in names:
        return cfg
    return dataclasses.replace(cfg, attn_shard_mode=shardlib.attn_mode_for(
        cfg, mesh.size(names.index("model"))))


def _unflat(flat: Dict, like):
    """``like``'s tree of dicts and lists with the leaves of ``flat``
    (keyed as :func:`_flat` keys them)."""
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, list):
            return [build(v, f"{prefix}{i}/") for i, v in enumerate(node)]
        return flat[prefix[:-1]]
    return build(like, "")


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
