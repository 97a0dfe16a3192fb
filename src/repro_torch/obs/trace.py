"""Structured span/event recorder for the serving stack (DESIGN.md §13.2).

A :class:`Tracer` records raw events — duration spans (``B``/``E``),
instants (``i``), counters (``C``), and async request lifelines
(``b``/``n``/``e``) — stamped with microsecond timestamps from an
*injectable* clock.  The engine passes its own ``Engine.clock``, so a
test that drives the engine with a FakeClock gets byte-identical traces
across runs: no wall-clock, no ``id()``-derived identifiers, no dict
ordering leaks.  Export to Chrome trace-event JSON lives in
:mod:`repro.obs.export`; this module only records.

Tracks are ``(process, thread)`` string pairs: one process per replica
(``replica0`` ...) plus ``router``, and within a replica one lane per
slot (``slot0`` ...) plus ``session`` for engine-level work and
``device`` for fused-loop dispatch marks.

Every emission site goes through a tracer attribute that defaults to the
module-level :data:`NOOP` (a :class:`NullTracer`), so the serving hot
path pays one attribute load + truthiness check when tracing is off.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

__all__ = ["NullTracer", "Tracer", "NOOP"]

Track = Tuple[str, str]


class NullTracer:
    """Disabled tracer: every method is a no-op.

    Emission sites are written as ``if tracer.enabled: tracer.begin(...)``
    or call methods directly; either way a NullTracer makes tracing-off
    runs behave exactly like the pre-observability code path.
    """

    enabled = False

    def begin(self, name, track, **args):
        pass

    def end(self, name, track, **args):
        pass

    def instant(self, name, track, **args):
        pass

    def counter(self, name, track, **values):
        pass

    def request_begin(self, req, track, **args):
        pass

    def request_point(self, req, name, track, **args):
        pass

    def request_end(self, req, track, **args):
        pass


NOOP = NullTracer()


class Tracer(NullTracer):
    """Event recorder with deterministic ids and injectable time.

    ``clock`` returns seconds (same contract as ``Engine.clock``);
    timestamps are recorded as integer microseconds.  Request lifelines
    use async events keyed by a tracer-assigned uid (a simple counter,
    stamped onto the request as ``_trace_uid``) — never ``id(req)``,
    which would differ between runs and break byte-identical exports.
    """

    enabled = True

    def __init__(self, clock=None):
        self.clock = clock if clock is not None else _default_clock
        self.events: List[Dict] = []
        self._uids = itertools.count(1)
        self._open_async: set = set()

    # -- core emitters ----------------------------------------------------

    def _ts(self) -> int:
        return int(round(self.clock() * 1e6))

    def _emit(self, ph: str, name: str, track: Track, args=None,
              cat: Optional[str] = None, uid: Optional[int] = None) -> None:
        ev: Dict = {"ph": ph, "name": name, "ts": self._ts(),
                    "track": (str(track[0]), str(track[1]))}
        if args:
            ev["args"] = dict(args)
        if cat is not None:
            ev["cat"] = cat
        if uid is not None:
            ev["id"] = uid
        self.events.append(ev)

    def begin(self, name, track, **args):
        """Open a duration span on ``track`` (must nest: close in LIFO
        order with :meth:`end`)."""
        self._emit("B", name, track, args)

    def end(self, name, track, **args):
        self._emit("E", name, track, args)

    def instant(self, name, track, **args):
        """A point event (preemption, migration, quarantine, ...)."""
        self._emit("i", name, track, args)

    def counter(self, name, track, **values):
        """A sampled counter series (e.g. free pages over time)."""
        self._emit("C", name, track, {k: v for k, v in values.items()})

    # -- per-request lifelines (async events) -----------------------------

    def _uid(self, req) -> int:
        uid = getattr(req, "_trace_uid", None)
        if uid is None:
            uid = next(self._uids)
            try:
                req._trace_uid = uid
            except AttributeError:
                pass
        return uid

    def request_begin(self, req, track, **args):
        """Open the request's async lifeline (idempotent: a request that
        passes through ``Router.submit`` and then ``session.submit`` only
        opens once)."""
        uid = self._uid(req)
        if uid in self._open_async:
            return
        self._open_async.add(uid)
        self._emit("b", "request", track, args, cat="request", uid=uid)

    def request_point(self, req, name, track, **args):
        uid = self._uid(req)
        if uid not in self._open_async:
            return
        args = dict(args)
        args["point"] = name
        self._emit("n", "request", track, args, cat="request", uid=uid)

    def request_end(self, req, track, **args):
        uid = self._uid(req)
        if uid not in self._open_async:
            return
        self._open_async.discard(uid)
        self._emit("e", "request", track, args, cat="request", uid=uid)


def _default_clock() -> float:
    import time

    return time.time()
