"""Multi-replica serving router: health-checked failover, request
migration, and backpressure (DESIGN.md §7).

The PyTorch counterpart of ``repro.serve.router``: host code over
:class:`~repro_torch.serve.engine.EngineSession`, the reference's
semantics unchanged.  Replicas built with ``params=first.params`` share
one model — weights, compute-dtype copies and K2 plans — and each adds its
own KV caches and, on the card, its own decode graph.  Replicas step in
turn on one stream, each fused chunk ending in a host sync, so the graphs
never run at once.  Only injected faults and host exceptions fail a
replica over: a device-side error on the card poisons the CUDA context
that every replica shares.

One :class:`~repro_torch.serve.engine.Engine` is one decode batch on one
card — a replica fault kills every in-flight stream and there is no admission
layer above a single ``serve()`` call.  The :class:`Router` fronts M
engine replicas (shared params, independent KV pools) through the
:class:`~repro_torch.serve.engine.EngineSession` stepper and adds the three
properties a fleet needs:

* **failover + migration** — a replica-tier fault (injected via
  ``FaultInjector`` site ``"replica"``, or any exception escaping
  ``EngineSession.step``) marks the replica dead and migrates its
  in-flight requests to survivors.  Migration *is* recompute preemption
  across replicas: each harvested request carries its generated prefix in
  ``out``, so re-admission elsewhere re-prefills prompt+prefix and the
  resumed stream is token-identical to the single-engine oracle.  Retries
  are bounded per request (``FaultConfig.max_restarts``); exhaustion →
  ``status="failed"``.  Dead replicas restart after a linear backoff
  (``backoff_s × restarts``, the ``RestartableLoop`` schedule) with a
  fresh session; a replica that exhausts its own restart budget stays
  down permanently.
* **health-aware routing** — a per-replica ``Watchdog`` EWMA over
  ``step()`` wall durations marks slow replicas ``degraded``; dispatch
  prefers healthy replicas and, within a health class, the most free
  pages (``PageAllocator.free_pages``).  Admission into a replica is
  deliberately conservative — one request at a time, only into a replica
  with a free slot and an empty session queue — so the router's global
  FIFO queue stays the single ordering authority and no request is
  trapped behind a replica-local backlog when that replica dies.
* **backpressure** — the router queue is bounded (``queue_limit``);
  over-capacity arrivals are refused at the door with ``status="shed"``
  instead of queueing unboundedly.  Migrations bypass the limit (they
  re-enter at the queue head: those requests were already admitted once
  and FIFO-precede everything still waiting).

Draining: ``drain_replica(i)`` stops admitting to a replica, lets its
residents finish, then recycles it with a fresh session (planned
maintenance — the failover path minus the fault).

Everything is driven by the injectable ``clock`` (defaults to
``engine.clock``) — tests run the full fault/migration/backoff machinery
on a fake timer with zero wall-clock asserts.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Dict, List, Optional

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import paging
from repro_torch.serve.engine import (Engine, EngineSession, Request,
                                      request_from_state, request_to_state)
from repro_torch.train.fault import FaultConfig, ProcessKilled, Watchdog

__all__ = ["Router", "RouterConfig", "Replica"]

log = logging.getLogger("repro_torch.router")


@dataclasses.dataclass
class RouterConfig:
    n_replicas: int = 2
    # global backpressure: max requests waiting in the router queue;
    # submissions beyond it are shed (status="shed").  0 → unbounded.
    queue_limit: int = 0
    # decode steps per replica per round — the stepper's interleave grain.
    # 0 (default) → one full fused chunk (the session's decode_chunk) per
    # round, so each round costs one on-device dispatch per busy replica;
    # an explicit value restores a finer host-visible grain.
    steps_per_round: int = 0
    # per-request migration budget and per-replica restart budget both
    # come from FaultConfig.max_restarts (backoff_s drives restart delay)


@dataclasses.dataclass
class Replica:
    """Router-side state for one engine replica."""
    engine: Engine
    session: EngineSession
    watchdog: Watchdog
    state: str = "healthy"                 # healthy|degraded|dead|draining
    restarts: int = 0                      # faults survived so far
    restart_at: Optional[float] = None     # clock time to revive at
    drains: int = 0
    # snapshots of this replica's dead/recycled sessions — their counters
    # survive the session so fleet stats never lose a faulted replica's work
    retired_stats: List[Dict] = dataclasses.field(default_factory=list)

    @property
    def alive(self) -> bool:
        return self.state in ("healthy", "degraded", "draining")

    @property
    def admitting(self) -> bool:
        return self.state in ("healthy", "degraded")


class Router:
    """Health-checked request router over M engine replicas.

    Build with a list of :class:`Engine` replicas (share one model's
    params across them: ``Engine(cfg, scfg, params=first.params)``), or
    use :meth:`build` to construct the fleet from configs.  Then either
    ``serve(requests)`` — the blocking batch API, mirroring
    ``Engine.serve`` — or ``submit()`` + ``run_round()`` for continuous
    operation.  ``stats()`` aggregates per-replica session stats through
    ``paging.merge_replica_stats`` and adds the router's own counters
    (``migrations``, ``retries_exhausted``, ``shed``, ``replica_faults``,
    ``replica_restarts``, ``drains``).
    """

    def __init__(self, engines: List[Engine], cfg: RouterConfig = None,
                 fault_cfg=None, clock=None, sleep=None, tracer=None):
        if not engines:
            raise ValueError("Router needs at least one engine replica")
        self.cfg = cfg if cfg is not None else RouterConfig(
            n_replicas=len(engines))
        self.fault_cfg = fault_cfg if fault_cfg is not None \
            else FaultConfig()
        self.clock = clock if clock is not None else engines[0].clock
        # sleep is only invoked when the whole fleet is blocked on a
        # pending restart; inject one that ADVANCES the injected clock
        # (e.g. FakeClock.advance) or serve() spins until the revival time
        self.sleep = sleep if sleep is not None else time.sleep
        # observability (DESIGN.md §13): label + attach the tracer to
        # every engine BEFORE the sessions are built, so each replica's
        # spans land on its own replica<i> track and router-level events
        # (shed, dispatch, failover) on the router track
        self.tracer = tracer if tracer is not None else obs_trace.NOOP
        self.track = ("router", "main")
        if tracer is not None:
            for i, e in enumerate(engines):
                e.tracer = tracer
                e.trace_label = f"replica{i}"
        self.queue: deque = deque()
        self.replicas: List[Replica] = [
            Replica(engine=e, session=e.start_session(),
                    watchdog=Watchdog(self.fault_cfg))
            for e in engines]
        self.counters = {"migrations": 0, "retries_exhausted": 0,
                         "shed": 0, "replica_faults": 0,
                         "replica_restarts": 0, "drains": 0,
                         "degraded_marks": 0}
        # prompt+prefix tokens that restore() re-enqueued at the ROUTER
        # queue (session-resident restores count theirs in session stats);
        # stats() folds this into the merged restore_recompute_tokens
        self._queue_restore_tokens = 0

    @classmethod
    def build(cls, model_cfg, serve_cfg, n_replicas: int,
              cfg: RouterConfig = None, fault_cfg=None, clock=None,
              params=None, device=None, **router_kw) -> "Router":
        """Construct ``n_replicas`` engines sharing one model, built from
        ``params`` (a parameter tree, or an engine's ``params``) on
        ``device`` as :class:`Engine` builds it."""
        first = Engine(model_cfg, serve_cfg, params=params, device=device,
                       fault_cfg=fault_cfg)
        engines = [first] + [
            Engine(model_cfg, serve_cfg, params=first.params,
                   fault_cfg=fault_cfg) for _ in range(n_replicas - 1)]
        if clock is not None:
            for e in engines:
                e.clock = clock
        return cls(engines, cfg=cfg, fault_cfg=fault_cfg, clock=clock,
                   **router_kw)

    # --------------------------------------------------------- admission
    def submit(self, req: Request) -> bool:
        """Enqueue at the router; False → shed by backpressure.

        The queue bound counts waiting requests only (not residents on
        replicas): it is the promise the router can still keep if every
        replica dies — bounded, so an overloaded fleet refuses work at
        the door instead of accumulating unbounded latency debt.
        """
        if req.arrival_t is None:
            req.arrival_t = self.clock()
        limit = self.cfg.queue_limit
        if limit and len(self.queue) >= limit:
            req.done = True
            req.status = "shed"
            req.error = (f"router queue at capacity ({limit}): request "
                         "shed at admission")
            if req.out is None:
                req.out = []
            self.counters["shed"] += 1
            self.tracer.instant("shed", self.track,
                                queue_len=len(self.queue))
            return False
        self.queue.append(req)
        self.tracer.request_begin(req, self.track,
                                  prompt=len(req.tokens))
        return True

    def _dispatch(self) -> None:
        """Move queue heads onto replicas, one per free slot, preferring
        healthy over degraded and, within a class, the most free pages.
        A replica only takes a new request when its own session queue is
        empty — the global queue is the one FIFO authority, and a request
        never waits behind a replica-local backlog."""
        while self.queue:
            candidates = [r for r in self.replicas
                          if r.admitting and r.session.has_free_slot
                          and r.session.num_queued == 0]
            if not candidates:
                return
            best = max(candidates,
                       key=lambda r: (r.state == "healthy",
                                      r.session.free_pages))
            req = self.queue.popleft()
            if self.tracer.enabled:
                idx = self.replicas.index(best)
                self.tracer.instant(
                    "dispatch", (f"replica{idx}", "session"), replica=idx)
                self.tracer.request_point(req, "dispatched",
                                          (f"replica{idx}", "session"),
                                          replica=idx)
            best.session.submit(req)

    # ---------------------------------------------------------- stepping
    def _on_fault(self, idx: int, exc: Exception) -> None:
        """Replica ``idx`` died mid-step: harvest its in-flight requests,
        re-queue survivors at the head (FIFO: they were admitted before
        anything still waiting), fail the ones whose retry budget is
        spent, and schedule the replica's restart."""
        rep = self.replicas[idx]
        rep.state = "dead"
        rep.restarts += 1
        self.counters["replica_faults"] += 1
        self.tracer.instant("replica_fault", (f"replica{idx}", "session"),
                            replica=idx, error=repr(exc))
        budget = self.fault_cfg.max_restarts
        if rep.restarts <= budget:
            backoff = self.fault_cfg.backoff_s * rep.restarts
            rep.restart_at = self.clock() + backoff
            log.warning("replica %d died (%r); restart %d/%d in %.3fs",
                        idx, exc, rep.restarts, budget, backoff)
        else:
            rep.restart_at = None          # permanently down
            log.error("replica %d died (%r); restart budget exhausted",
                      idx, exc)
        inflight = rep.session.inflight()
        rep.retired_stats.append(rep.session.stats_snapshot())
        rep.session = None                 # lost with the replica
        # reversed + appendleft keeps the harvested FIFO order at the head
        for req in reversed(inflight):
            req.retries += 1
            if req.retries > budget:
                req.done = True
                req.status = "failed"
                req.error = (f"replica {idx} fault ({exc!r}); migration "
                             f"budget exhausted after {req.retries - 1} "
                             "retries")
                if req.out is None:
                    req.out = []
                self.counters["retries_exhausted"] += 1
                self.tracer.request_end(req, self.track, status="failed")
            else:
                self.counters["migrations"] += 1
                # one "migrate" instant per migrations increment, on the
                # faulted replica's track (check_trace pairs them exactly)
                self.tracer.instant("migrate", (f"replica{idx}", "session"),
                                    replica=idx, retries=req.retries)
                self.tracer.request_point(req, "migrated", self.track,
                                          from_replica=idx)
                self.queue.appendleft(req)

    def _maybe_restart(self) -> None:
        now = self.clock()
        for idx, rep in enumerate(self.replicas):
            if rep.state == "dead" and rep.restart_at is not None \
                    and now >= rep.restart_at:
                rep.session = rep.engine.start_session()
                rep.state = "healthy"
                rep.restart_at = None
                self.counters["replica_restarts"] += 1
                self.tracer.instant("replica_restart",
                                    (f"replica{idx}", "session"),
                                    replica=idx, restarts=rep.restarts)
                log.info("replica %d restarted (restart %d)", idx,
                         rep.restarts)

    def _finish_drains(self) -> None:
        """A draining replica whose residents finished gets recycled with
        a fresh session and rejoins the healthy pool."""
        for idx, rep in enumerate(self.replicas):
            if rep.state == "draining" and rep.session.idle:
                rep.retired_stats.append(rep.session.stats_snapshot())
                rep.session = rep.engine.start_session()
                rep.state = "healthy"
                rep.drains += 1
                self.counters["drains"] += 1
                self.tracer.instant("drain", (f"replica{idx}", "session"),
                                    replica=idx)

    def drain_replica(self, idx: int) -> None:
        """Planned maintenance: stop admitting to replica ``idx``; its
        residents finish on subsequent rounds, then it is recycled."""
        rep = self.replicas[idx]
        if not rep.alive:
            raise ValueError(f"replica {idx} is {rep.state}; only a live "
                             "replica can be drained")
        rep.state = "draining"

    def run_round(self) -> int:
        """One scheduling round: revive due replicas, dispatch queue heads,
        then step every live replica ``steps_per_round`` decode steps
        (watchdog-timed; a step that raises triggers failover).  Returns
        total decode steps run; 0 with a non-empty queue means the router
        is waiting on a restart (the injected ``sleep`` is invoked with
        the time until the nearest one)."""
        self._maybe_restart()
        self._finish_drains()
        self._dispatch()
        ran = 0
        for idx, rep in enumerate(self.replicas):
            if not rep.alive or rep.session.idle:
                continue
            t0 = self.clock()
            grain = self.cfg.steps_per_round or \
                max(1, rep.session.cfg.decode_chunk)
            try:
                n = rep.session.step(grain)
            except ProcessKilled:
                # process-tier fault: there is no surviving replica to
                # migrate to — the whole fleet is gone.  Propagate to the
                # crash drill, which rebuilds the router and restores the
                # latest snapshot (DESIGN.md §7.6).
                raise
            except Exception as exc:  # noqa: BLE001 — replica-tier fault
                self._on_fault(idx, exc)
                continue
            ran += n
            # normalize by steps run so a fused chunk is judged per-step
            # (a k-step round must not read as a k× straggler)
            if n and rep.watchdog.observe(rep.session.stats["decode_steps"],
                                          (self.clock() - t0) / n):
                # transiently slow (stragglers) → route around it; the
                # next clean round restores it to the healthy class
                if rep.state == "healthy":
                    rep.state = "degraded"
                    self.counters["degraded_marks"] += 1
                    self.tracer.instant("degraded_mark",
                                        (f"replica{idx}", "session"),
                                        replica=idx)
            elif n and rep.state == "degraded":
                rep.state = "healthy"
        if ran == 0 and self.queue:
            pending = [r.restart_at for r in self.replicas
                       if r.state == "dead" and r.restart_at is not None]
            if pending:
                # idle until the nearest revival — through the injected
                # sleep, so tests advance a FakeClock instead of waiting
                self.sleep(max(0.0, min(pending) - self.clock()))
            elif not any(r.alive for r in self.replicas):
                self._fail_stranded()
        return ran

    def _fail_stranded(self) -> None:
        """Every replica is permanently down: nothing can ever serve the
        queue — fail it rather than spin forever."""
        while self.queue:
            req = self.queue.popleft()
            req.done = True
            req.status = "failed"
            req.error = "all replicas permanently down"
            if req.out is None:
                req.out = []
            self.counters["retries_exhausted"] += 1
            self.tracer.request_end(req, self.track, status="failed")

    # ---------------------------------------------------------- blocking
    @property
    def idle(self) -> bool:
        return not self.queue and all(
            (not r.alive) or r.session.idle for r in self.replicas)

    def serve(self, requests: List[Request]) -> List[Request]:
        """Blocking batch API mirroring ``Engine.serve``: submit all (the
        over-capacity tail is shed), run rounds to quiescence."""
        for req in requests:
            self.submit(req)
        while not self.idle:
            self.run_round()
        return requests

    # ------------------------------------------------- snapshot / restore
    def snapshot(self) -> Dict:
        """Crash-consistent fleet state (DESIGN.md §7.6): every live
        replica session's :meth:`EngineSession.snapshot`, the retired-
        session counters, the router's own counters, and the global queue
        (as rebased request states).  JSON-serializable; persist through
        :class:`repro_torch.train.checkpoint.SnapshotManager` for the atomic
        write + rolling retention."""
        now = self.clock()
        return {
            "version": 1,
            "sessions": [None if rep.session is None
                         else rep.session.snapshot()
                         for rep in self.replicas],
            "retired_stats": [list(rep.retired_stats)
                              for rep in self.replicas],
            "replica_restarts": [rep.restarts for rep in self.replicas],
            "replica_drains": [rep.drains for rep in self.replicas],
            "queue": [request_to_state(req, now) for req in self.queue
                      if not req.done],
            "counters": dict(self.counters),
        }

    def restore(self, snap: Dict) -> List[Request]:
        """Load a :meth:`snapshot` into this freshly-built, idle router.
        Every replica here starts alive (the old process's dead replicas
        come back as fresh engines — their inflight work was already
        migrated into the snapshotted queue at fault time); counters and
        retired-session stats carry over so fleet totals survive the
        restart.  Returns every re-enqueued :class:`Request` handle —
        session residents first (per replica), then the global queue —
        and ``serve([])``/``run_round()`` then drains them
        token-identically to the dead process's streams."""
        sessions = snap.get("sessions", [])
        if len(sessions) != len(self.replicas):
            raise ValueError(
                f"snapshot holds {len(sessions)} replicas but this "
                f"router has {len(self.replicas)}")
        if self.queue or not self.idle:
            raise RuntimeError("restore() needs an idle router")
        now = self.clock()
        restored: List[Request] = []
        for rep, sess_snap, retired, restarts, drains in zip(
                self.replicas, sessions,
                snap.get("retired_stats", [[] for _ in self.replicas]),
                snap.get("replica_restarts", [0] * len(self.replicas)),
                snap.get("replica_drains", [0] * len(self.replicas))):
            rep.retired_stats = [dict(s) for s in retired]
            rep.restarts = restarts
            rep.drains = drains
            if sess_snap is not None:
                restored.extend(rep.session.restore(sess_snap))
        for rs in snap.get("queue", []):
            req = request_from_state(rs, now)
            if req.out:
                # a migrated request parked in the global queue carries a
                # generated prefix that must re-prefill after the restart
                self._queue_restore_tokens += len(req.tokens) + \
                    len(req.out)
            self.queue.append(req)
            restored.append(req)
        for key, val in snap.get("counters", {}).items():
            if key in self.counters:
                self.counters[key] = val
        return restored

    # ------------------------------------------------------------- stats
    def stats(self) -> Dict:
        """Fleet-level stats: merged per-session counters (live sessions +
        every retired one, so faulted replicas' work is not forgotten)
        plus the router's own counters and per-replica health."""
        by_replica = [
            r.retired_stats + ([r.session.stats_snapshot()]
                               if r.session is not None else [])
            for r in self.replicas]
        merged = paging.merge_replica_stats(
            [s for sessions in by_replica for s in sessions])
        if "page_high_water" in merged:
            # merge_replica_stats lists per *session*; fold a replica's
            # retired sessions into one per-replica high-water here
            merged["page_high_water_per_replica"] = [
                max((s.get("page_high_water", 0) for s in sessions),
                    default=0) for sessions in by_replica]
        if "straggler_decode_steps" in merged:
            # same per-replica fold for straggler attribution: sum each
            # replica's retired + live sessions, so one chronically slow
            # host is visible as a skewed entry, not just a bigger total
            merged["straggler_decode_steps_per_replica"] = [
                sum(s.get("straggler_decode_steps", 0) for s in sessions)
                for sessions in by_replica]
        if self._queue_restore_tokens:
            merged["restore_recompute_tokens"] = merged.get(
                "restore_recompute_tokens", 0) + self._queue_restore_tokens
        if "request_timing" in merged:
            # fleet-level p50/p95/p99 over the merged per-request
            # histograms (queue_s / prefill_s / latency_s)
            merged["latency_percentiles"] = obs_metrics.timing_percentiles(
                merged["request_timing"])
        merged.update(self.counters)
        merged["router_queue_len"] = len(self.queue)
        merged["replica_states"] = [r.state for r in self.replicas]
        merged["n_replicas"] = len(self.replicas)
        return merged
