"""Serving engine: batched prefill + decode with KV caches, and continuous
batching over paged caches with a fused decode loop.

The PyTorch counterpart of ``repro.serve.engine``:

* ``Engine(model_cfg, ServeConfig(...)).generate(prompts, max_new_tokens)``
  — batch-synchronous: the prompt through ``LanguageModel.prefill``, then
  one ``decode_step`` per new token, with the reference's EOS rules.
* ``Engine.serve(requests)`` / ``start_session`` / :class:`EngineSession`
  — continuous mixed-length batching: a fixed decode batch of ``n_slots``
  with a per-slot KV position index, prompt-length prefill per request
  committed into a slot, paged KV caches (``kv_layout="paged"``, the
  default; ``"dense"`` keeps per-slot slabs), admission under the
  ``"prompt"`` or ``"worst_case"`` policy with recompute preemption,
  deadlines, per-request fault isolation (or ``strict`` fail-stop),
  KV-page integrity checks, snapshots, and stats through the metrics
  registry — the reference's semantics, replayed by the port's tests.

Decode steps of a session go through the fused decode loop
(``device_loop.FusedDecode``): on the card one captured CUDA graph of a
step, replayed up to ``decode_chunk`` times per host sync.  Its state —
the session's KV caches, the current tokens and the loop's inputs and
outputs — belongs to the engine and is built at its first session (on the
card the graph is captured then, once; an engine that only ``generate``s
allocates none of it), so the engine serves one session at a time: a new session takes the state over and
zeroes it, and the older one raises if it steps again.  Every host-side
update (admission, preemption, block tables, tokens) writes into that
state in place.

The recurrent families ride the same session: an ``ssm`` or ``rec``
layer's cache is its per-slot state (conv tail and SSD or RG-LRU state),
installed whole at admission (``paging.commit_prefill``) and stepped by
the fused loop only while it is live.  Such a layer holds no page, so a
stack with none paged (mamba2; recurrentgemma, whose attention layers are
windowed rings) keeps the allocator's host-side accounting and
preemption exactly as the reference does, with no pool on the card.

The encoder-decoder family (seamless-m4t-medium) and the vision
frontend (pixtral-12b) need ``frames`` or ``patch_embeds`` beside the
tokens: they are served as the reference serves them, by
``_prefill(batch)`` with the whole batch, then ``_decode(caches, tok)``
and ``_sample(logits)`` per token (a decoder layer's cache carries its
cross keys and values).  ``generate`` and the sessions take tokens only,
so they raise a ``ValueError`` for those configs, where the reference's
fail on the missing key.

With an RgCSR FFN (``cfg.sparsity.enabled``, ``impl="kernel"``) every
layer's ``w_out`` product runs through K2 — in each prefill and in every
decode step, captured ones included — and ``Engine.__init__`` builds each
layer's K2 plan at the compute dtype first (``plans_warmed``: one per
layer).  Engines built with ``params=other.params`` share ``other``'s
model — its weights, their compute-dtype copies and its K2 plans — and add
only their own serving state (the router's replicas).
``warm_spmv_plans`` tunes auxiliary SpMV matrices on the engine's device
(the autotuner); with a ``DeviceMesh`` it also row-shards each one and
tunes each shard on its own rank.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import LanguageModel
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import device_loop, paging
from repro_torch.train.fault import FaultConfig, Watchdog

__all__ = ["ServeConfig", "Engine", "EngineSession", "Request",
           "request_to_state", "request_from_state"]


def request_to_state(req: "Request", now: float) -> Dict:
    """JSON-serializable crash-consistent state of one undone request.
    KV tensors are NOT captured — the generated prefix in ``out`` is
    enough for the recompute path to resume the stream exactly.  The
    arrival timestamp is stored as an *age* so the restoring process can
    rebase it onto its own clock (deadlines keep running across the
    restart)."""
    return {
        "tokens": np.asarray(req.tokens, np.int32).tolist(),
        "max_new_tokens": int(req.max_new_tokens),
        "out": None if req.out is None else [int(t) for t in req.out],
        "preemptions": int(req.preemptions),
        "retries": int(req.retries),
        "deadline_s": req.deadline_s,
        "age_s": 0.0 if req.arrival_t is None
        else float(now - req.arrival_t),
        "queue_s": float(req.queue_s),
        "prefill_s": float(req.prefill_s),
    }


def request_from_state(state: Dict, now: float) -> "Request":
    """Inverse of :func:`request_to_state`: rebuild a live
    :class:`Request` in the restoring process, arrival rebased to
    ``now - age_s``."""
    req = Request(tokens=np.asarray(state["tokens"], np.int32),
                  max_new_tokens=state["max_new_tokens"])
    req.out = None if state.get("out") is None else list(state["out"])
    req.preemptions = state.get("preemptions", 0)
    req.retries = state.get("retries", 0)
    req.deadline_s = state.get("deadline_s")
    req.arrival_t = now - state.get("age_s", 0.0)
    req.queue_s = state.get("queue_s", 0.0)
    req.prefill_s = state.get("prefill_s", 0.0)
    if req.preemptions:
        req.status = f"preempted_{req.preemptions}"
    return req


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
    # max decode steps per fused dispatch (graph replays per host sync on
    # the card); 1 restores the stepwise one-sync-per-token cadence
    decode_chunk: int = 8
    # --- overload behavior ---
    # prompt     → admit on the resident tokens' pages only and
    #              recompute-preempt a victim at decode-boundary exhaustion
    # worst_case → reserve each request's worst case at admission and
    #              defer admissions when the pool can't cover it
    admission_policy: str = "prompt"
    # strict=True restores fail-stop serving: oversized requests and
    # mid-request exceptions raise out of serve() instead of failing only
    # the affected request.
    strict: bool = False
    # default completion deadline (seconds from arrival) applied to
    # requests that don't carry their own ``deadline_s``; 0 → no deadline.
    deadline_s: float = 0.0
    # --- KV-page integrity ---
    # kv_integrity=True arms two detectors for silent corruption of the
    # page pools: per-page crc32 checksums recorded at chunk-commit
    # boundaries and verified before every dispatch, and a NaN/Inf logit
    # screen in the commit loop.  Detection quarantines the page and
    # recompute-preempts exactly the requests that touched it.
    kv_integrity: bool = False


@dataclasses.dataclass
class Request:
    """One serving request.

    Terminal state (set by ``serve``): ``done`` flips True exactly once,
    and ``status`` says how the request ended —

    * ``"ok"``            — completed normally;
    * ``"preempted_<n>"`` — completed normally after ``n`` recompute
      preemptions (still a success — ``ok_like`` covers both);
    * ``"rejected"``      — refused at admission (budget overflows
      ``max_seq``, or its worst-case page count exceeds the whole pool);
    * ``"failed"``        — a mid-request exception (prefill/decode fault)
      killed this request; the rest of the batch kept serving;
    * ``"timed_out"``     — its ``deadline_s`` passed (queued or
      mid-decode); partial output is kept in ``out``;
    * ``"shed"``          — refused at a router's door (backpressure).

    ``error`` carries the reason for the failure statuses.
    ``deadline_s`` is a completion deadline in seconds measured from the
    request's **arrival** — the moment it was submitted to a session
    (``arrival_t``; batch-submitted ``serve()`` requests arrive at call
    entry).  It bounds queue wait + processing; ``None`` falls back to
    ``ServeConfig.deadline_s``.  ``retries`` counts router migrations.

    Timing fields (all seconds, on the engine's clock):

    * ``queue_s``   — time from arrival until this request was first
      slotted (head-of-line wait).
    * ``prefill_s`` — its own (first) prefill duration.
    * ``latency_s`` — from this request's own processing start (first
      slotting) to its completion — not from the start of the serve call.
    """
    tokens: np.ndarray                  # (prompt_len,) int32
    max_new_tokens: int = 32
    out: Optional[List[int]] = None
    done: bool = False
    deadline_s: Optional[float] = None
    status: str = "ok"
    error: Optional[str] = None
    preemptions: int = 0
    retries: int = 0
    arrival_t: Optional[float] = None
    latency_s: float = 0.0
    queue_s: float = 0.0
    prefill_s: float = 0.0

    @property
    def ok_like(self) -> bool:
        """Completed with full output (possibly after preemptions)."""
        return self.done and (self.status == "ok"
                              or self.status.startswith("preempted"))


class Engine:
    """``params``: a parameter tree for the model (see
    :mod:`repro_torch.models.model`), or another engine's :attr:`params`
    (its :class:`~repro_torch.models.LanguageModel`), which this engine
    then shares as it is — weights, compute-dtype copies and K2 plans —
    on its device; without one the model draws its own from
    ``serve_cfg.seed`` on ``device`` (default ``"cuda"``).  ``fault_cfg`` (a
    :class:`~repro_torch.train.fault.FaultConfig`) drives the watchdog
    that flags straggler decode steps; ``fault_injector`` is consulted at
    the per-request prefill and decode sites of every session."""

    def __init__(self, model_cfg, serve_cfg: ServeConfig, params=None, *,
                 device=None, fault_cfg=None, fault_injector=None):
        self.cfg = serve_cfg
        self.fault_cfg = fault_cfg if fault_cfg is not None else FaultConfig()
        self.fault_injector = fault_injector
        # injectable clock: every session timestamp (deadlines, latency,
        # watchdog) flows through this, so tests drive deadlines with a
        # fake timer instead of wall-clock sleeps.
        self.clock = time.time
        # observability: attach a repro_torch.obs.trace.Tracer (and a
        # per-replica label) BEFORE start_session(); None keeps the no-op
        # fast path.
        self.tracer = None
        self.trace_label = "replica0"
        shared = isinstance(params, LanguageModel)
        if shared:
            if params.cfg != model_cfg:
                raise ValueError("params is a model of another config")
            if device is not None and \
                    torch.device(device).type != params.device.type:
                raise ValueError(f"params lives on {params.device}, not "
                                 f"on {device}")
            self.model = params
        else:
            self.model = LanguageModel(model_cfg, params,
                                       device=device or "cuda",
                                       seed=serve_cfg.seed)
        self.device = self.model.device
        self._decode = device_loop.make_decode_step(self.model)
        self._generator = torch.Generator(device=self.device).manual_seed(
            serve_cfg.seed)
        # stats of the most recent serve() call — a plain-dict render of
        # the session's metrics registry (EngineSession.stats_snapshot)
        self.paging_stats: Optional[Dict] = None
        # Sparse (RgCSR) weights: build every layer's K2 plan at model load,
        # at the compute dtype the layers will ask for (a shared model's
        # engine found them built).
        self.plans_warmed = 0
        self.spmv_plans_warmed = 0   # auxiliary matrices (warm_spmv_plans)
        self.sharded_spmv_plans_warmed = 0
        # one small host dict per warmed (matrix, mesh), never pruned
        self.sharded_spmv_shard_stats: List[Dict] = []
        # (mesh signature, x_mode, shape, dtype, matrix content) ->
        # (sharded matrix, plan): keeps the sharded plan cache's entries
        # alive; a re-warm of the same matrix on the same mesh replaces its
        # entry
        self._warm_sharded: Dict[tuple, tuple] = {}
        if model_cfg.sparsity.enabled and \
                model_cfg.sparsity.impl_is_kernel() and not shared:
            self.plans_warmed = ops.warm_plans_from_params(
                self.model, dtype=self.model.compute_dtype)
        # the serving state: the session's KV caches and the fused loop
        # over them, built at the first session (see _loop)
        self._geom = None
        if serve_cfg.kv_layout == "paged":
            self._geom = paging.geometry(serve_cfg.max_seq,
                                         serve_cfg.page_size,
                                         serve_cfg.n_slots,
                                         serve_cfg.n_pages)
        self._runner: Optional[device_loop.FusedDecode] = None
        self._fused_decode = self._run_fused
        self._session: Optional["EngineSession"] = None

    @property
    def params(self) -> LanguageModel:
        """What ``Engine(cfg, scfg, params=engine.params)`` shares: the
        model, with its weights, compute-dtype copies and K2 plans."""
        return self.model

    @property
    def _loop(self) -> device_loop.FusedDecode:
        """The fused decode loop over the session's KV caches, built at the
        first use and kept for the engine's life (on the card its graph is
        captured then, once).  Dense slabs keep one spare row past
        ``max_seq`` for the writes of slots that run past the end (see
        ``models/attention.py``); paged layers take ``max_seq`` from the
        page geometry."""
        if self._runner is None:
            caches = self.model.init_cache(self.cfg.n_slots,
                                           self.cfg.max_seq + 1,
                                           paging=self._geom)
            self._runner = device_loop.build_fused_decode(
                self.model, self.cfg, caches, self._generator)
        return self._runner

    def _run_fused(self, *args):
        """The session's fused dispatch (the seam ``_fused_decode``): one
        chunk of the loop, then the trace hook."""
        out = self._loop(*args)
        self._on_fused_dispatch(out)
        return out

    def warm_spmv_plans(self, matrices, *, repeats: int = 1, mesh=None,
                        mesh_axis: Optional[str] = None,
                        x_mode: str = "replicated",
                        per_shard_tune: bool = True):
        """Pre-tune and stage SpMV plans for auxiliary sparse matrices.

        Serving deployments that also answer SpMV traffic (iterative
        solvers, graph scoring) hand their matrices here at startup — each
        a dense array, a ``scipy.sparse`` matrix or a CSR tuple: each one
        runs the joint autotune search on the engine's device and the
        winning plan lands in the process-wide ``PLAN_CACHE``, kept alive
        by the tuner, before the first request.  The request path hits it
        through ``autotune.tuned_plan`` of the same matrix: a memo hit with
        no timing and no plan build.  Returns the winning
        :class:`~repro_torch.kernels.autotune.TuneConfig` per matrix, in
        order.

        With ``mesh`` (a ``DeviceMesh`` over every rank of the default
        process group, all of which call this together), each matrix is
        also row-sharded over the resolved mesh axis (``mesh_axis`` or the
        partitioner's ``sparse_rows`` rule).  Rank 0 alone runs the
        whole-matrix search (so only its ``PLAN_CACHE`` holds that plan)
        and every rank takes its winner; with ``per_shard_tune`` each
        shard's first rank tunes the shard at that winner's
        ``group_size`` (``autotune.autotune_spmv_per_shard``; ranks that
        share a card search one at a time) and every rank harmonizes the
        same gathered results, so every rank builds the same plan, staged
        in the sharded plan cache (keyed on the shard count, so a resized
        mesh builds a new one).  The sharded matrix and the stacked plan
        stay on the host; each rank moves only its own shard's view to its
        card.  Per-matrix shard stats (slots, steps, remote columns,
        exchange volume, per-shard winners, and the bytes this rank holds
        on its card beside the stacked plan's on the host) land in
        ``sharded_spmv_shard_stats``; the sharded matrices and plans are
        kept on the engine, keyed on the mesh, ``x_mode`` and the exact
        matrix content, so a re-warm replaces its entry.
        """
        from repro_torch.kernels import autotune
        if mesh is None:
            winners = [autotune.tuned_plan(a, repeats=repeats,
                                           device=self.device)[1].config
                       for a in matrices]
            self.spmv_plans_warmed += len(winners)
            return winners
        import torch.distributed as dist
        from repro_torch.core.formats import ShardedRgCSR
        from repro_torch.sharding import (mesh_signature,
                                          resolve_spmv_shard_axis)
        if mesh_axis is None:
            mesh_axis = resolve_spmv_shard_axis(mesh)
        shard, group = ops.mesh_shard(mesh, mesh_axis)
        if mesh.mesh.numel() != dist.get_world_size():
            raise ValueError(
                f"warm_spmv_plans(mesh=) needs a mesh over all "
                f"{dist.get_world_size()} ranks, got {tuple(mesh.shape)}")
        n_shards = dist.get_world_size(group)
        winners = []
        for a in matrices:
            m = autotune._as_csr(a)
            agreed = [autotune.tuned_plan(
                m, repeats=repeats, device=self.device)[1].config
                if dist.get_rank() == 0 else None]
            dist.broadcast_object_list(agreed, src=0)
            cfg = agreed[0]
            winners.append(cfg)
            shard_cfgs = None
            if per_shard_tune:
                shard_cfgs = autotune.harmonize_shard_winners(
                    autotune.autotune_spmv_per_shard(
                        m, n_shards, group_size=cfg.group_size,
                        repeats=repeats, x_mode=x_mode, device=self.device,
                        group=group))
            # the matrix and the stacked plan stay on the host; only this
            # rank's shard goes to its card
            sm = ShardedRgCSR.from_csr(m.values, m.columns, m.row_ptr,
                                       m.shape, n_shards,
                                       group_size=cfg.group_size,
                                       device="cpu")
            splan = ops.get_sharded_plan(
                sm, chunks_per_step=cfg.chunks_per_step,
                ordering=cfg.ordering, spill_threshold=cfg.spill_threshold,
                x_mode=x_mode, shard_configs=shard_cfgs)
            view = splan.local(shard, self.device)
            self._warm_sharded[(mesh_signature(mesh), x_mode, m.shape,
                                str(m.values.dtype),
                                autotune._fingerprint(m))] = (sm, splan)
            self.sharded_spmv_plans_warmed += 1
            self.sharded_spmv_shard_stats.append({
                "n_shards": splan.n_shards,
                "mesh": mesh_signature(mesh),
                "x_mode": splan.x_mode,
                "stored_slots": list(splan.shard_stored_slots),
                "num_steps": list(splan.shard_num_steps),
                "remote_cols": list(splan.shard_remote_cols),
                "exchange_recv_cols": list(splan.shard_exchange_recv_cols),
                "exchange_send_cols": list(splan.shard_exchange_send_cols),
                "exchange_bytes": list(splan.shard_exchange_bytes),
                "kernel_chunks_per_step": splan.chunks_per_step,
                "shard_winners": [list(c) for c in splan.shard_configs],
                "device_bytes": view.nbytes,
                "host_bytes": splan.nbytes,
            })
        self.spmv_plans_warmed += len(winners)
        return winners

    def plan_cache_stats(self):
        """Plan counters: the matrix PlanCache (core spmv dispatch), the
        sharded plan cache, the K2 plans this engine's sparse layers keep,
        and how many plans this engine warmed at init and through
        :meth:`warm_spmv_plans`."""
        kept = sum(len(getattr(m, "_plans", ()))
                   for m in self.model.modules() if hasattr(m, "plan_for"))
        return {"plan_cache": ops.PLAN_CACHE.stats(),
                "param_plans": {"entries": kept},
                "sharded_plan_cache": ops.sharded_plan_cache_stats(),
                "plans_warmed": self.plans_warmed,
                "spmv_plans_warmed": self.spmv_plans_warmed,
                "sharded_spmv_plans_warmed": self.sharded_spmv_plans_warmed}

    def _check_tokens_only(self, what: str) -> None:
        """``what`` passes prompts as tokens alone: refuse a config whose
        prefill needs frames or patches."""
        cfg = self.model.cfg
        if cfg.enc_dec or cfg.frontend != "none":
            need = "frames (the encoder's input)" if cfg.enc_dec \
                else "patch_embeds (the vision frontend's input)"
            raise ValueError(
                f"{cfg.name}: {what} takes prompts as tokens alone, and this "
                f"config's prefill needs {need}; serve it through "
                f"_prefill(batch), _decode(caches, tok) and _sample(logits)")

    # ---------------------------------------------------------------- steps
    def _prefill(self, batch):
        return self.model.prefill(batch, self.cfg.max_seq)

    def _sample(self, logits) -> torch.Tensor:
        return device_loop.sample_tokens(
            logits, self._generator, self.cfg.temperature, self.cfg.top_k)

    def _on_fused_dispatch(self, out) -> None:
        """Trace hook run INSIDE the fused-decode callable — test/bench
        harnesses wrap ``engine._fused_decode`` from the outside, so an
        emission there would be lost under their wrappers.  Late-bound:
        attaching a tracer after engine construction takes effect
        immediately."""
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.instant("fused_dispatch", (self.trace_label, "device"),
                       steps=int(out[1]))

    # ------------------------------------------------------------- one-shot
    def generate(self, prompts, max_new_tokens: int = 32) -> np.ndarray:
        """Batch-synchronous generation (all prompts the same length).

        Output is always ``(b, max_new_tokens)``; with ``eos_id >= 0``,
        sequences that sample EOS (including at prefill — the first token
        counts) stop and their remaining positions are filled with
        ``eos_id``; once every sequence has finished the decode loop exits.
        Without ``eos_id`` the host never waits for the card before the
        end.
        """
        self._check_tokens_only("generate")
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

    # ------------------------------------------------- continuous batching
    def start_session(self, requests: Optional[List[Request]] = None,
                      fault_injector=None) -> "EngineSession":
        """Open a reentrant serving session: ``submit()`` enqueues requests
        at any time, ``step(k)`` runs up to ``k`` decode steps (admissions,
        deadline sweeps and completions happen at chunk boundaries), and
        ``drain()`` runs to quiescence.  The session takes over this
        engine's serving state (see the module's note).  A config whose
        prefill needs frames or patches raises ``ValueError``: a session
        admits tokens only."""
        self._check_tokens_only("a serving session")
        injector = fault_injector if fault_injector is not None \
            else self.fault_injector
        return EngineSession(self, requests or [], injector)

    def restore_session(self, snap, fault_injector=None):
        """Crash-recovery convenience: fresh session + load a
        :meth:`EngineSession.snapshot`.  Returns ``(session, requests)``
        where ``requests`` are the re-enqueued handles in queue order."""
        session = self.start_session([], fault_injector)
        return session, session.restore(snap)

    def serve(self, requests: List[Request],
              fault_injector=None) -> List[Request]:
        """Continuous mixed-length batching over a request queue: a
        blocking :meth:`start_session` + :meth:`EngineSession.drain`.

        Semantics (the reference's):

        * prompt lengths may differ freely within one live batch (per-slot
          position index);
        * paged layout, ``admission_policy="prompt"`` (default): admission
          reserves only the pages the request's resident tokens need; a
          decode boundary that finds the pool dry recompute-preempts the
          latest-admitted slot (pages freed, request re-enqueued at the
          queue head with its generated prefix, re-prefilled later).
          ``"worst_case"`` reserves worst cases and defers admission;
        * per-request fault isolation (unless ``strict=True``): an
          oversized request is ``"rejected"``; an exception in a request's
          prefill, or an injected per-request decode fault, ``"failed"``
          that request alone;
        * deadlines, measured from arrival, time out a request at the
          next chunk boundary (or while queued), keeping its partial
          ``out``;
        * a request whose first (prefill-sampled) token is EOS, or whose
          ``max_new_tokens <= 1``, completes without a decode step, a slot
          or pages;
        * stats land in ``self.paging_stats`` after every call
          (:meth:`EngineSession.stats_snapshot`).
        """
        session = self.start_session(requests, fault_injector)
        session.drain()
        self.paging_stats = session.stats_snapshot()
        return requests


class EngineSession:
    """Reentrant serving stepper over one :class:`Engine`.

    Holds the decode batch's host bookkeeping, page allocator, request
    queue and stats, so the host can run ``step(k)`` decode steps, regain
    control, and interleave other work between bursts.  The KV caches and
    the current tokens are the engine's fused-loop state, taken over (and
    zeroed) when the session starts.

    Faults split into two tiers, as in the reference: request-tier
    injections and exceptions in a request's prefill fail only that
    request (``strict=False``); a ``("replica", k)`` or exact
    ``("process", k)`` injection, or any exception escaping the decode
    dispatch, raises out of ``step()`` with the host state intact for
    ``inflight()``.
    """

    def __init__(self, engine: Engine, requests: List[Request],
                 injector=None):
        self.engine = engine
        cfg = engine.cfg
        self.cfg = cfg
        self.n = cfg.n_slots
        self.paged = cfg.kv_layout == "paged"
        self.strict = cfg.strict
        self.clock = engine.clock
        self.injector = injector
        self.geom = self.alloc = None
        if self.paged:
            self.geom = engine._geom
            self.alloc = paging.PageAllocator(self.geom, self.n,
                                              policy=cfg.admission_policy,
                                              strict=cfg.strict)
        self.kv_integrity = cfg.kv_integrity and self.paged
        self.crc_order = paging.crc_order(engine.model.cfg)
        # the engine's fused-loop state, zeroed: a fresh session sees the
        # zero caches the reference allocates for each session
        loop = engine._loop
        with torch.inference_mode():
            for cache in loop.caches:
                for t in cache.values():
                    t.zero_()
            loop.cur_tok.zero_()
        engine._session = self
        self.caches = loop.caches
        self.cur_tok = loop.cur_tok
        self.queue: deque = deque()
        self.active: List[Optional[Request]] = [None] * self.n
        self.remaining = [0] * self.n
        self.pos = [0] * self.n             # tokens resident per slot
        self.admit_seq = [-1] * self.n      # admission order per slot
        self.seq_counter = 0
        self.started: Dict[int, float] = {}  # id(req) → first slotting time
        self.t_start = self.clock()
        self.watchdog = Watchdog(engine.fault_cfg)
        self.prefill_count = 0              # prefill site index (injector)
        # observability: ``stats`` keeps its dict interface but is a view
        # over a typed metrics registry; request timing feeds histograms.
        # The tracer comes from the engine (NOOP when tracing is off).
        self.trace = engine.tracer if engine.tracer is not None \
            else obs_trace.NOOP
        self.label = engine.trace_label
        self.track = (self.label, "session")
        # the port's own spans (obs.trace.active), the fused dispatch's too
        self.host_track = loop.host_track = (self.label, "host")
        self.metrics = obs_metrics.MetricsRegistry()
        self.stats = self.metrics.view(
            counters=("decode_steps", "decode_dispatches",
                      "admission_deferrals"),
            gauges=("peak_live_tokens", "frag_at_high_water"))
        for key in ("requests", "completed", "preemptions",
                    "recompute_tokens", "rejected", "failed", "timed_out",
                    "restores", "restore_recompute_tokens",
                    "nonfinite_logits"):
            self.stats[key] = 0
        self.stats["frag_at_high_water"] = 0.0
        self.hists = {name: self.metrics.histogram(name)
                      for name in ("queue_s", "prefill_s", "latency_s")}
        if self.alloc is not None and self.trace.enabled:
            self.alloc.tracer = self.trace
            self.alloc.trace_track = self.track
        for req in requests:
            self.submit(req)

    # ------------------------------------------------------------ queries
    @property
    def idle(self) -> bool:
        """No queued and no resident work."""
        return not self.queue and all(a is None for a in self.active)

    @property
    def num_queued(self) -> int:
        return len(self.queue)

    @property
    def num_active(self) -> int:
        return sum(a is not None for a in self.active)

    @property
    def has_free_slot(self) -> bool:
        return any(a is None for a in self.active)

    @property
    def free_pages(self) -> int:
        """Routing signal: free pages in this session's pool (dense
        sessions report free slots — the analogous capacity unit)."""
        if self.alloc is not None:
            return self.alloc.free_pages
        return sum(a is None for a in self.active)

    def inflight(self) -> List[Request]:
        """Undone requests this session owns, FIFO: resident slots in
        admission order, then the queue."""
        resident = sorted((s for s in range(self.n)
                           if self.active[s] is not None),
                          key=lambda s: self.admit_seq[s])
        return [self.active[s] for s in resident] + \
            [r for r in self.queue if not r.done]

    # ---------------------------------------------------------- lifecycle
    def submit(self, req: Request, front: bool = False) -> None:
        """Enqueue a request (``front=True``: ahead of the line).  Stamps
        ``arrival_t`` on first submission; a migrated request keeps its
        original arrival so its deadline keeps running."""
        if req.arrival_t is None:
            req.arrival_t = self.clock()
        self.stats["requests"] += 1
        self.trace.request_begin(req, self.track, prompt=len(req.tokens))
        if front:
            self.queue.appendleft(req)
        else:
            self.queue.append(req)

    def _deadline_expired(self, req: Request, now: float) -> bool:
        d = req.deadline_s if req.deadline_s is not None else \
            (self.cfg.deadline_s if self.cfg.deadline_s > 0 else None)
        return d is not None and (now - req.arrival_t) > d

    def _finish_ok(self, req: Request) -> None:
        req.done = True
        req.status = "ok" if req.preemptions == 0 \
            else f"preempted_{req.preemptions}"
        req.latency_s = self.clock() - self.started[id(req)]
        self.stats["completed"] += 1
        self.hists["latency_s"].observe(req.latency_s)
        self.trace.request_end(req, self.track, status=req.status,
                               tokens=len(req.out or ()))

    def _finish_bad(self, req: Request, status: str, error: str,
                    slot: Optional[int] = None) -> None:
        """Terminal failure for ONE request: record status/error, free
        its slot and pages, leave everyone else serving."""
        req.done = True
        req.status = status
        req.error = error
        if req.out is None:
            req.out = []
        if id(req) in self.started:
            req.latency_s = self.clock() - self.started[id(req)]
            self.hists["latency_s"].observe(req.latency_s)
        self.stats[status] += 1
        if status == "timed_out":
            self.trace.instant("deadline_expired", self.track,
                               queued=slot is None)
        self.trace.request_end(req, self.track, status=status)
        if slot is not None:
            self.trace.end("request", (self.label, f"slot{slot}"),
                           status=status)
            self.active[slot] = None
            if self.paged:
                self.alloc.release(slot)

    def _preempt_slot(self, slot: int) -> None:
        """Recompute-preempt one slot: free its pages (corrupt ones land in
        quarantine at release), re-enqueue the request at the queue HEAD
        with its generated prefix kept in ``out``."""
        req = self.active[slot]
        req.preemptions += 1
        req.status = f"preempted_{req.preemptions}"
        self.stats["preemptions"] += 1
        self.stats["recompute_tokens"] += self.pos[slot]
        self.trace.end("request", (self.label, f"slot{slot}"),
                       status=req.status)
        self.trace.instant("preempt", (self.label, f"slot{slot}"),
                           slot=slot, recompute_tokens=self.pos[slot])
        self.active[slot] = None
        if self.paged:
            self.alloc.release(slot, evicted=True)
        self.queue.appendleft(req)

    def _preempt_victim(self) -> int:
        """Recompute-preempt the latest-admitted (fewest tokens generated)
        active slot; returns it."""
        victim = max((s for s in range(self.n)
                      if self.active[s] is not None),
                     key=lambda s: (self.admit_seq[s],
                                    -len(self.active[s].out)))
        self._preempt_slot(victim)
        return victim

    # ---------------------------------------------------- page integrity
    def _fingerprints(self, committed: Dict[int, int]) -> Dict[int, int]:
        return paging.page_fingerprints(self.caches, committed,
                                        self.crc_order)

    def _record_checksums(self) -> None:
        """Chunk-commit boundary: fingerprint every live page's committed
        contents into the allocator's checksum table.  A slot with ``pos``
        resident tokens has committed exactly the first ``pos`` rows of its
        page chain."""
        alloc, ps = self.alloc, self.geom.page_size
        committed: Dict[int, int] = {}
        for slot in range(self.n):
            if self.active[slot] is None:
                continue
            for j, page in enumerate(alloc.slot_pages[slot]):
                ntok = min(ps, self.pos[slot] - j * ps)
                if ntok > 0:
                    committed[page] = ntok
        for page in list(alloc.checksums):
            if page not in committed:
                del alloc.checksums[page]
        for page, crc in self._fingerprints(committed).items():
            alloc.record_checksum(page, committed[page], crc)

    def _verify_integrity(self) -> None:
        """Pre-dispatch verify: recompute every recorded page's crc and
        compare.  A mismatch quarantines the page and recompute-preempts
        exactly the slots whose block tables reference it, then nulls
        their table rows on the card."""
        alloc = self.alloc
        if not alloc.checksums:
            return
        recorded = dict(alloc.checksums)
        crcs = self._fingerprints({p: lc[0] for p, lc in recorded.items()})
        bad = [p for p, crc in crcs.items() if crc != recorded[p][1]]
        if not bad:
            return
        victims = set()
        for page in bad:
            owner = alloc.owner_of(page)
            alloc.quarantine(page)
            if owner is not None and self.active[owner] is not None:
                victims.add(owner)
        # preempt in reverse admission order so appendleft leaves the
        # earliest-admitted victim at the queue head (FIFO preserved)
        for slot in sorted(victims, key=lambda s: self.admit_seq[s],
                           reverse=True):
            self._preempt_slot(slot)
        paging.sync_block_tables(self.caches, alloc.table)

    def _quarantine_slot_pages(self, slot: int) -> None:
        """A slot's logits went non-finite mid-dispatch: localize the
        poison in its page chain and quarantine it — pages holding
        non-finite values, else checksum mismatches, else the whole
        chain."""
        alloc = self.alloc
        chain = list(alloc.slot_pages[slot])
        bad = paging.pages_nonfinite(self.caches, chain)
        if not bad:
            recorded = {p: alloc.checksums[p][0] for p in chain
                        if p in alloc.checksums}
            bad = {p for p, crc in self._fingerprints(recorded).items()
                   if crc != alloc.checksums[p][1]}
        if not bad:
            bad = set(chain)
        for page in bad:
            alloc.quarantine(page)

    def _admit(self, spans) -> None:
        """Fill free slots from the queue; a request finishing at prefill
        (EOS as its first token, or an exhausted budget) completes without
        ever occupying the slot, so the next queued request slots in.
        ``spans``: the step's active tracer, for ``session.prefill``."""
        cfg, alloc = self.cfg, self.alloc
        deferred = False
        for slot in range(self.n):
            while self.active[slot] is None and self.queue and not deferred:
                req = self.queue[0]
                now = self.clock()
                if self._deadline_expired(req, now):
                    self.queue.popleft()
                    self.started.setdefault(id(req), now)
                    req.queue_s = now - req.arrival_t
                    self.hists["queue_s"].observe(req.queue_s)
                    self._finish_bad(req, "timed_out",
                                     "deadline exceeded after "
                                     f"{now - req.arrival_t:.3f}s in queue")
                    continue
                prefix = req.out or []      # preempted: generated so far
                length = len(req.tokens) + len(prefix)
                budget = max(req.max_new_tokens, 1) - len(prefix)
                # max resident tokens: the last decode step has written
                # length + max_new - 1 of them (the final sampled token
                # never enters the cache) — preemption never raises it
                max_resident = len(req.tokens) \
                    + max(req.max_new_tokens, 1) - 1
                if max_resident > cfg.max_seq:
                    msg = (f"request needs {max_resident} cache "
                           f"positions (prompt {len(req.tokens)} + "
                           f"max_new_tokens {req.max_new_tokens} - 1) "
                           f"but max_seq is {cfg.max_seq}")
                    if self.strict:
                        raise ValueError(msg)
                    self.queue.popleft()
                    self._finish_bad(req, "rejected", msg)
                    continue
                worst = 0
                if self.paged:
                    worst = alloc.pages_for(max_resident)
                    if worst > alloc.usable:
                        msg = (f"request needs up to {worst} pages but "
                               f"the pool has {alloc.usable}: raise "
                               f"n_pages or lower max_new_tokens")
                        if self.strict:
                            raise ValueError(msg)
                        self.queue.popleft()
                        self._finish_bad(req, "rejected", msg)
                        continue
                    if not alloc.can_admit(
                            alloc.admission_pages(length, worst)):
                        # FIFO: don't let shorter later requests starve
                        # the head — stop admitting until pages free
                        self.stats["admission_deferrals"] += 1
                        deferred = True
                        break
                self.queue.popleft()
                t0 = self.clock()
                if id(req) not in self.started:
                    self.started[id(req)] = t0
                    req.queue_s = t0 - req.arrival_t
                    self.hists["queue_s"].observe(req.queue_s)
                lane = (self.label, f"slot{slot}")
                self.trace.begin("request", lane,
                                 prompt=len(req.tokens),
                                 prefix=len(prefix))
                tokens = req.tokens if not prefix else np.concatenate(
                    [np.asarray(req.tokens, np.int32),
                     np.asarray(prefix, np.int32)])
                site = self.prefill_count
                self.prefill_count += 1
                self.trace.begin("prefill", lane, tokens=len(tokens))
                if spans.enabled:
                    spans.begin("session.prefill", self.host_track,
                                tokens=len(tokens))
                try:
                    if self.injector is not None:
                        self.injector.check(site, site="prefill")
                    with torch.inference_mode():
                        batch = torch.from_numpy(np.asarray(
                            tokens, np.int32)[None, :]).to(self.engine.device)
                        logits, slot_cache = self.engine._prefill(
                            {"tokens": batch})
                        first = int(self.engine._sample(logits)[0])
                except Exception as e:  # noqa: BLE001 — isolate request
                    if self.strict:
                        raise
                    if spans.enabled:
                        spans.end("session.prefill", self.host_track,
                                  error=True)
                    self.trace.end("prefill", lane, error=True)
                    self.trace.end("request", lane, status="failed")
                    self._finish_bad(req, "failed", repr(e))
                    continue
                if spans.enabled:
                    spans.end("session.prefill", self.host_track)
                self.trace.end("prefill", lane)
                if req.out is None:
                    req.out = []
                req.out.append(first)
                if not prefix:
                    req.prefill_s = self.clock() - t0
                    self.hists["prefill_s"].observe(req.prefill_s)
                if first == cfg.eos_id or budget <= 1:
                    self.trace.end("request", lane, status="ok")
                    self._finish_ok(req)
                    continue
                with torch.inference_mode():
                    if self.paged:
                        alloc.admit(slot, length, worst)
                        paging.commit_prefill(self.caches, slot_cache, slot,
                                              length, alloc.table,
                                              self.geom.page_size)
                    else:
                        paging.commit_prefill(self.caches, slot_cache, slot,
                                              length)
                    self.cur_tok[slot, 0] = first
                self.active[slot] = req
                self.admit_seq[slot] = self.seq_counter
                self.seq_counter += 1
                self.remaining[slot] = budget - 1
                self.pos[slot] = length

    def _sweep_deadlines(self) -> None:
        """Chunk-boundary deadline sweep: expired slots free their pages
        before anyone is preempted for space."""
        now = self.clock()
        for slot in range(self.n):
            req = self.active[slot]
            if req is not None and self._deadline_expired(req, now):
                self._finish_bad(req, "timed_out",
                                 "deadline exceeded after "
                                 f"{now - req.arrival_t:.3f}s with "
                                 f"{len(req.out)} tokens", slot=slot)

    def _ensure_pages(self, horizon: int = 1) -> int:
        """Grow each active slot's pages for the next fused chunk and
        return the chunk length the pool can actually cover.

        Phase A (mandatory): the next decode step writes each active
        slot's token at position ``pos[slot]`` — allocate that boundary
        page up front, earliest-admitted first.  Under the prompt policy
        pool exhaustion preempts the latest-admitted slot (possibly the
        requester itself) and retries.

        Phase B (chunk horizon): extend surviving slots to cover
        ``min(horizon, remaining)`` further steps, shrinking ``horizon``
        until the extension fits the FREE pool — extension never preempts
        and never raises, so a chunk of the returned length cannot exhaust
        the pool mid-flight.
        """
        alloc = self.alloc
        changed = False
        order = sorted((s for s in range(self.n)
                        if self.active[s] is not None),
                       key=lambda s: self.admit_seq[s])
        for slot in order:
            if self.active[slot] is None:
                continue                 # evicted as a victim below
            while True:
                try:
                    changed |= alloc.ensure(slot, self.pos[slot] + 1)
                    break
                except paging.PoolExhausted:
                    victim = self._preempt_victim()
                    changed = True       # victim's table row went null
                    if victim == slot:
                        break            # requester evicted itself
        k = max(1, horizon)
        if k > 1:
            live = [s for s in order if self.active[s] is not None]

            def extra(steps: int) -> int:
                return sum(
                    max(0, alloc.pages_for(
                        self.pos[s] + min(steps, self.remaining[s]))
                        - len(alloc.slot_pages[s]))
                    for s in live)

            while k > 1 and extra(k) > alloc.free_pages:
                k -= 1
            for s in live:
                changed |= alloc.ensure(
                    s, self.pos[s] + min(k, self.remaining[s]))
        if changed:
            paging.sync_block_tables(self.caches, alloc.table)
        return k

    def _record_live(self) -> None:
        """Live-token peak (layout-agnostic), once per committed decode
        row."""
        live = sum(self.pos[s] + 1 for s in range(self.n)
                   if self.active[s] is not None)
        self.stats["peak_live_tokens"] = max(
            self.stats["peak_live_tokens"], live)
        if self.paged and self.alloc.pages_in_use >= self.alloc.high_water:
            self.stats["frag_at_high_water"] = 1.0 - live / max(
                self.alloc.pages_in_use * self.geom.page_size, 1)

    def step(self, max_steps: int = 1) -> int:
        """Run up to ``max_steps`` decode steps; returns how many ran.

        Each iteration admits from the queue, sweeps deadlines,
        grows/preempts pages out to the chunk horizon, then makes ONE
        fused dispatch (``engine._fused_decode``) of up to
        ``decode_chunk`` decode+sample steps — on the card, graph replays
        and one sync — and commits the returned ``(steps, n_slots)`` token
        block row by row with the stepwise per-slot semantics (decode
        fault sites, EOS/budget completion, page release).  Admission-only
        iterations don't count against ``max_steps``.  An armed replica or
        process fault inside the upcoming chunk splits the chunk at the
        fault step.

        With a tracer active (``obs.trace.recording``) the call is the span
        ``session.step`` on ``(trace_label, "host")``, and each iteration's
        phases are spans inside it: ``session.admit`` (each request's
        ``session.prefill`` in it), ``session.schedule`` up to the
        dispatch (whose ``decode.*`` spans ``FusedDecode`` records) and
        ``session.commit``.  Spans a raising step leaves open end with
        ``error=True``.
        """
        if self.engine._session is not self:
            raise RuntimeError("a newer session of this engine took over "
                               "its serving state")
        spans = obs_trace.active()
        if not spans.enabled:
            return self._step(max_steps, spans)
        since = len(spans.events)
        spans.begin("session.step", self.host_track)
        try:
            ran = self._step(max_steps, spans)
        except BaseException:
            obs_trace.close_open(spans, self.host_track, since, error=True)
            raise
        spans.end("session.step", self.host_track)
        return ran

    def _step(self, max_steps: int, spans) -> int:
        cfg = self.cfg
        host = self.host_track
        ran = 0
        while ran < max_steps and (
                self.queue or any(a is not None for a in self.active)):
            if self.kv_integrity:
                # commit-boundary verify BEFORE admission: corruption
                # detected here frees/quarantines pages and re-enqueues
                # its victims at the head
                self._verify_integrity()
            if spans.enabled:
                spans.begin("session.admit", host)
            self._admit(spans)
            if spans.enabled:
                spans.end("session.admit", host)
            if all(a is None for a in self.active):
                if self.queue:
                    continue     # heads were rejected/timed out — refill
                break            # the fill loop drained the queue
            if spans.enabled:
                spans.begin("session.schedule", host)
            self._sweep_deadlines()
            chunk = min(max(1, cfg.decode_chunk), max_steps - ran)
            if self.paged:
                chunk = self._ensure_pages(chunk)
            self._record_live()  # chunk-boundary peak (pre-dispatch)
            if all(a is None for a in self.active):
                if spans.enabled:
                    spans.end("session.schedule", host)
                continue         # deadline sweep / self-eviction emptied
            if self.injector is not None:
                # process tier first (exact match), then replica tier;
                # an armed step strictly inside the chunk caps it
                self.injector.check(self.stats["decode_steps"],
                                    site="process", exact=True)
                self.injector.check(self.stats["decode_steps"],
                                    site="replica")
                lo = self.stats["decode_steps"] + 1
                hi = self.stats["decode_steps"] + chunk
                faults = [f for f in (
                    self.injector.next_armed("replica", lo, hi),
                    self.injector.next_armed("process", lo, hi, exact=True))
                    if f is not None]
                if faults:
                    chunk = min(faults) - self.stats["decode_steps"]
                if self.paged:
                    # corruption striking INSIDE the dispatch window:
                    # caught by the commit loop's NaN/Inf screen
                    idx = self.injector.take("page_nan")
                    if idx is not None:
                        paging.corrupt_page(self.caches, idx, nan=True)
            if self.trace.enabled:
                if self.paged:
                    self.trace.counter("free_pages", self.track,
                                       free=self.alloc.free_pages)
                self.trace.begin("decode_chunk", self.track,
                                 chunk=int(chunk),
                                 active=self.num_active)
            rem = [self.remaining[s] if self.active[s] is not None else 0
                   for s in range(self.n)]
            act = [a is not None for a in self.active]
            # the loop would stop once every budget ran out: ask for no
            # more steps than that, so that without EOS every replay is
            # a live step
            n_steps = min(chunk, max(rem))
            if spans.enabled:
                spans.end("session.schedule", host)
            step_t0 = self.clock()
            block, steps_ran, _, _, _, ok_block = self.engine._fused_decode(
                self.caches, self.cur_tok, rem, act, n_steps)
            steps = int(steps_ran)
            self.stats["decode_dispatches"] += 1
            # normalize wall time by steps actually fused into this
            # dispatch — a k-step chunk must not read as a k× straggler
            if self.watchdog.observe(self.stats["decode_steps"],
                                     (self.clock() - step_t0)
                                     / max(steps, 1)):
                self.trace.instant("straggler_flagged", self.track,
                                   step=self.stats["decode_steps"])
            if spans.enabled:
                spans.begin("session.commit", host)
            for i in range(steps):
                if all(a is None for a in self.active):
                    break        # decode faults emptied the batch early
                if i > 0:
                    self._record_live()
                self.stats["decode_steps"] += 1
                ran += 1
                for slot in range(self.n):
                    req = self.active[slot]
                    if req is None:
                        continue
                    if self.injector is not None:
                        try:
                            # per-request decode site: "this request
                            # committing its len(out)-th generated token"
                            self.injector.check(len(req.out), site="decode")
                        except Exception as e:  # noqa: BLE001 — isolate
                            if self.strict:
                                raise
                            self._finish_bad(req, "failed", repr(e),
                                             slot=slot)
                            continue
                    if self.kv_integrity and not ok_block[i, slot]:
                        # poisoned logits: the tainted token is never
                        # committed — quarantine the bad page(s) and
                        # recompute-preempt just this slot
                        self.stats["nonfinite_logits"] += 1
                        self._quarantine_slot_pages(slot)
                        self._preempt_slot(slot)
                        continue
                    tok_i = int(block[i, slot])
                    req.out.append(tok_i)
                    self.pos[slot] += 1
                    self.remaining[slot] -= 1
                    if self.remaining[slot] <= 0 or tok_i == cfg.eos_id:
                        self._finish_ok(req)
                        self.trace.end("request",
                                       (self.label, f"slot{slot}"),
                                       status=req.status)
                        self.active[slot] = None
                        if self.paged:
                            self.alloc.release(slot)
            if self.kv_integrity:
                self._record_checksums()
            self.trace.end("decode_chunk", self.track, steps=steps)
            if spans.enabled:
                spans.end("session.commit", host)
            if self.injector is not None and self.paged:
                # silent corruption at rest: injected AFTER the boundary
                # fingerprints, so the next iteration's verify flags it
                idx = self.injector.take("page")
                if idx is not None:
                    paging.corrupt_page(self.caches, idx)
        return ran

    def drain(self) -> None:
        """Run to quiescence: every submitted request reaches a terminal
        status."""
        while not self.idle:
            self.step(max_steps=1 << 30)

    # ------------------------------------------------- snapshot / restore
    def snapshot(self) -> Dict:
        """Crash-consistent session state as a JSON-serializable dict: the
        host truth only — undone requests in ``inflight()`` order, counters,
        the engine generator's state (the reference stores its PRNG key),
        and the allocator's quarantine/accounting state.  KV tensors are
        not serialized: :meth:`restore` re-enqueues each request with its
        prefix, and re-admission re-prefills it."""
        now = self.clock()
        reqs = [request_to_state(req, now) for req in self.inflight()]
        snap: Dict = {
            "version": 1,
            "kv_layout": self.cfg.kv_layout,
            "n_slots": self.n,
            "requests": reqs,
            "stats": dict(self.stats),
            "request_timing": {name: h.state()
                               for name, h in self.hists.items()},
            "generator_state": self.engine._generator.get_state().tolist(),
        }
        self.trace.instant("snapshot", self.track, requests=len(reqs))
        if self.paged:
            snap["alloc"] = {
                "quarantined": sorted(self.alloc.quarantined
                                      | self.alloc._pending_quarantine),
                "double_release": self.alloc.double_release,
                "evictions": self.alloc.evictions,
                "pages_evicted": self.alloc.pages_evicted,
                "page_high_water": self.alloc.high_water,
            }
        return snap

    def restore(self, snap: Dict) -> List[Request]:
        """Load a :meth:`snapshot` into this (idle, freshly-built) session:
        counters resume, the generator's state is reinstated, quarantined
        pages stay out of circulation, and every snapshotted request is
        re-enqueued FIFO with its generated prefix.  Returns the new
        :class:`Request` objects in queue order."""
        if not self.idle:
            raise RuntimeError("restore() needs an idle session — it "
                               "rebuilds the queue from the snapshot")
        if snap.get("kv_layout") != self.cfg.kv_layout:
            raise ValueError(
                f"snapshot was taken under kv_layout="
                f"{snap.get('kv_layout')!r} but this session runs "
                f"{self.cfg.kv_layout!r}")
        now = self.clock()
        self.engine._generator.set_state(
            torch.tensor(snap["generator_state"], dtype=torch.uint8))
        for key, val in snap.get("stats", {}).items():
            if key in self.stats:
                self.stats[key] = val
        for name, state in snap.get("request_timing", {}).items():
            if name in self.hists:
                self.hists[name].load(state)
        self.stats["restores"] += 1
        if self.paged and "alloc" in snap:
            a = snap["alloc"]
            # replay quarantines with the allocator's tracer off: the
            # process that found the corruption already traced them
            saved_tracer = self.alloc.tracer
            self.alloc.tracer = None
            try:
                for page in a.get("quarantined", ()):
                    self.alloc.quarantine(page)
            finally:
                self.alloc.tracer = saved_tracer
            self.alloc.double_release = a.get("double_release", 0)
            self.alloc.evictions = a.get("evictions", 0)
            self.alloc.pages_evicted = a.get("pages_evicted", 0)
            self.alloc.high_water = max(self.alloc.high_water,
                                        a.get("page_high_water", 0))
        restored: List[Request] = []
        for rs in snap.get("requests", []):
            req = request_from_state(rs, now)
            if req.out:
                # the whole prompt+prefix must re-prefill
                self.stats["restore_recompute_tokens"] += \
                    len(req.tokens) + len(req.out)
            # bypass submit(): the snapshotted stats already counted these
            self.queue.append(req)
            restored.append(req)
        self.trace.instant("restore", self.track,
                           requests=len(restored))
        return restored

    def stats_snapshot(self) -> Dict:
        """Current counters in the ``Engine.paging_stats`` shape; callable
        at any point in the session."""
        stats = dict(self.stats)
        stats["straggler_decode_steps"] = len(self.watchdog.events)
        stats["request_timing"] = {name: h.state()
                                   for name, h in self.hists.items()}
        stats["latency_percentiles"] = obs_metrics.timing_percentiles(
            stats["request_timing"])
        if self.paged:
            stats.update(self.alloc.stats())
            stats["kv_layout"] = "paged"
            # dense-equivalent residency: what (n_slots, S_max) slabs pin
            stats["dense_equiv_tokens"] = self.n * self.cfg.max_seq
            stats["paged_peak_tokens"] = stats["page_high_water"] \
                * self.geom.page_size
        else:
            stats["kv_layout"] = "dense"
        return stats
