"""Fault tolerance: step watchdog, failure classification, restart policy,
straggler mitigation.

What runs here vs. what is documented-only on CPU:

* **Implemented + tested** — the restart loop (exception → restore latest
  checkpoint → seek the data stream → resume), the step-time watchdog
  (EWMA straggler detector), bounded retry with backoff, and fault
  injection hooks used by tests/test_fault.py.  The watchdog and injector
  are shared with the serving engine (DESIGN.md §6.4): ``Engine.serve``
  runs a :class:`Watchdog` over decode-step times (stragglers land in
  ``paging_stats``) and threads a :class:`FaultInjector` through its
  per-request prefill/decode paths for fault-isolation tests.
* **Documented policy (needs a real cluster)** — hot-spare pod promotion
  and ICI-link-failure remapping: on a 1000+-node deployment the watchdog's
  `on_straggler` callback is wired to the cluster scheduler to drain/replace
  the slow host; here it logs and (optionally) triggers an elastic re-shard
  through checkpoint.restore_sharded onto the surviving mesh — which IS
  exercised by tests (256→128-device re-layout under the dry-run device
  count).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

__all__ = ["FaultConfig", "Watchdog", "RestartableLoop", "FaultInjector",
           "ProcessKilled"]

log = logging.getLogger("repro_torch.fault")


class ProcessKilled(RuntimeError):
    """A ``("process", k)`` fault site fired: the whole serving process is
    presumed lost — every replica, every session, every in-memory queue.

    Deliberately NOT a replica-tier fault: the router re-raises it instead
    of migrating (there is no surviving replica to migrate to).  The crash
    drill (DESIGN.md §7.6) catches it at the top level, rebuilds the fleet
    from params, and restores the latest snapshot."""


@dataclasses.dataclass
class FaultConfig:
    max_restarts: int = 3
    backoff_s: float = 0.1
    straggler_ewma_alpha: float = 0.1
    straggler_factor: float = 2.0      # step > factor × EWMA → straggler
    min_samples: int = 5


class Watchdog:
    """EWMA step-time tracker; flags stragglers (slow steps/hosts).

    A flagged step's ``dt`` is **clamped to the flagging threshold**
    (``straggler_factor × EWMA``) before it feeds the EWMA: folding the
    raw outlier in used to inflate the baseline so fast that a sustained
    slowdown stopped being flagged after a single alert.  With the clamp
    the baseline still adapts — geometrically, one clamped update at a
    time — so a host that is *permanently* slower eventually becomes the
    new normal (bounded alert stream), but a step-function slowdown is
    flagged for several consecutive steps first, long enough for a
    router/scheduler health policy to act on it.
    """

    def __init__(self, cfg: FaultConfig,
                 on_straggler: Optional[Callable[[int, float, float], None]]
                 = None):
        self.cfg = cfg
        self.ewma: Optional[float] = None
        self.n = 0
        self.events = []
        self.on_straggler = on_straggler

    def observe(self, step: int, dt: float) -> bool:
        """Record a step time; returns True if flagged as straggler."""
        flagged = False
        if self.ewma is not None and self.n >= self.cfg.min_samples \
                and dt > self.cfg.straggler_factor * self.ewma:
            flagged = True
            self.events.append((step, dt, self.ewma))
            log.warning("straggler: step %d took %.3fs (EWMA %.3fs)",
                        step, dt, self.ewma)
            if self.on_straggler:
                self.on_straggler(step, dt, self.ewma)
        a = self.cfg.straggler_ewma_alpha
        # clamp flagged outliers at the threshold so one straggler can't
        # poison the baseline (see class docstring)
        d = min(dt, self.cfg.straggler_factor * self.ewma) if flagged else dt
        self.ewma = d if self.ewma is None else (1 - a) * self.ewma + a * d
        self.n += 1
        return flagged


class FaultInjector:
    """Test hook: raise at chosen steps (simulates node/request failure).

    ``fail_at_steps`` entries are either bare ints (site-agnostic — the
    train loop's ``check(step)`` matches them) or ``(site, step)`` tuples
    for site-qualified injection: the serving engine threads
    ``check(k, site="prefill")`` / ``check(k, site="decode")`` through its
    per-request paths, so a fault can target "the 3rd prefill this serve
    call" or "a request committing its 2nd generated token" without
    touching the engine.  Each entry fires exactly once (then it is
    discarded), so injection is deterministic regardless of how many
    requests reach the same step count; fired entries are recorded in
    ``self.fired`` for assertions.

    Two sites have non-raising / non-default semantics (DESIGN.md §7.6):

    * ``("process", k)`` raises :class:`ProcessKilled` (never ``exc``) —
      whole-process loss; checked with ``exact=True`` so bare ints can't
      accidentally escalate a request fault to a process death;
    * ``("page", idx)`` / ``("page_nan", idx)`` entries don't raise at
      all: the engine drains them via :meth:`take` at chunk-commit
      boundaries and *corrupts KV page* ``idx`` in place — silent
      device-memory corruption, detected later by the integrity layer.
    """

    def __init__(self, fail_at_steps=(), exc=RuntimeError):
        self.fail_at = set(fail_at_steps)
        self.exc = exc
        self.armed = True
        self.fired = []

    def check(self, step: int, site: Optional[str] = None,
              exact: bool = False):
        """Raise if an armed entry matches.  ``exact=True`` matches ONLY
        the ``(site, step)`` tuple — bare site-agnostic ints are ignored
        (used for the ``"process"`` site, where a stray bare int must not
        escalate to a whole-process death)."""
        if not self.armed:
            return
        if exact:
            keys = ((site, step),)
        else:
            keys = (step,) if site is None else ((site, step), step)
        for key in keys:
            if key in self.fail_at:
                self.fail_at.discard(key)
                self.fired.append((site, step))
                exc = ProcessKilled if site == "process" else self.exc
                raise exc(f"injected fault at {site or 'step'} {step}")

    def next_armed(self, site: Optional[str], start: int,
                   stop: int, exact: bool = False) -> Optional[int]:
        """Smallest armed step in ``[start, stop)`` that ``check(step,
        site=site)`` would fire on (site-qualified tuples and bare
        site-agnostic ints both count, unless ``exact``), or ``None``.
        The serving engine's fused decode loop uses this to split a chunk
        exactly at an injected replica/process fault, so chunked serving
        fires faults at the same decode-step index the stepwise cadence
        did."""
        if not self.armed:
            return None
        hits = [s for s in range(start, stop)
                if (site, s) in self.fail_at
                or (not exact and s in self.fail_at)]
        return min(hits) if hits else None

    def take(self, site: str) -> Optional[int]:
        """Pop and return the smallest armed index for ``site`` WITHOUT
        raising, or ``None``.  This is the corruption-site drain: the
        engine calls ``take("page")`` at each chunk-commit boundary and
        scribbles over the returned page — the fault is the *corruption*,
        not an exception, so detection must come from the integrity
        layer."""
        if not self.armed:
            return None
        hits = sorted(k[1] for k in self.fail_at
                      if isinstance(k, tuple) and k[0] == site)
        if not hits:
            return None
        idx = hits[0]
        self.fail_at.discard((site, idx))
        self.fired.append((site, idx))
        return idx


class RestartableLoop:
    """Run a step function with restart-from-checkpoint on failure.

    ``run(state, start_step, n_steps, step_fn, restore_fn)`` where
    ``step_fn(state, step) -> state`` and ``restore_fn() -> (state, step)``
    reloads the latest checkpoint.  Deterministic data (train/data.py) makes
    the recovery exact: the replayed steps see identical batches.

    ``sleep=`` / ``clock=`` are injectable (matching ``Engine.clock`` /
    ``Router.clock``): the restart backoff sleeps through ``sleep`` and
    each restart is stamped with ``clock()`` into ``restart_log`` as
    ``(failed_step, backoff_s, t)`` — so tests assert the exact backoff
    schedule on a fake timer instead of burning real wall-clock.
    """

    def __init__(self, cfg: FaultConfig, sleep: Optional[Callable] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.cfg = cfg
        self.restarts = 0
        # resolved lazily so monkeypatching repro_torch.train.fault.time still
        # works for callers that construct the loop first
        self._sleep = sleep
        self._clock = clock
        self.restart_log = []

    def run(self, state, start_step: int, n_steps: int, step_fn,
            restore_fn):
        sleep = self._sleep if self._sleep is not None else time.sleep
        clock = self._clock if self._clock is not None else time.time
        step = start_step
        end = start_step + n_steps
        while step < end:
            try:
                state = step_fn(state, step)
                step += 1
            except Exception as e:  # noqa: BLE001 — any step failure
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    log.error("restart budget exhausted (%d)", self.restarts)
                    raise
                log.warning("step %d failed (%r); restoring (restart %d/%d)",
                            step, e, self.restarts, self.cfg.max_restarts)
                backoff = self.cfg.backoff_s * self.restarts
                self.restart_log.append((step, backoff, clock()))
                sleep(backoff)
                state, step = restore_fn()
        return state, step
