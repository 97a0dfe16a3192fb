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

The port adds one process-wide slot for a tracer, :func:`active`
(:data:`NOOP` until :func:`recording` installs one), for the code that has
no engine to hang a tracer on, and for the spans that must stay off the
engine's own tracer, whose event stream is the reference's event for
event: the session's phases and the fused dispatch on ``(trace_label,
"host")``, the sparse products' dispatch and launch on :data:`KERNELS`
(``session.step`` ⊃ ``session.admit`` ⊃ ``session.prefill``,
``session.schedule``, ``decode.dispatch`` ⊃ ``decode.wait``,
``session.commit``; ``sparse.call`` ⊃ ``sparse.launch``; instants
``host_build`` where a plan or work list is built).  Each such site
reads the slot at the call and does nothing further while its
``enabled`` is false; the per-product sites of the sparse path read
:data:`_active` itself, one load and one branch, with no call.

The default clock is the profiler's: :func:`time.time`, recorded in µs,
is the epoch on which ``torch.profiler``'s kineto events give their
nanoseconds, so a span and the device activity under it line up.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["NullTracer", "Tracer", "NOOP", "KERNELS", "active",
           "recording", "close_open"]

Track = Tuple[str, str]

# the sparse layer's track on the active tracer
KERNELS: Track = ("kernels", "host")


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
_active: NullTracer = NOOP


def active() -> NullTracer:
    """The process-wide tracer (:data:`NOOP` unless :func:`recording`)."""
    return _active


@contextlib.contextmanager
def recording(tracer: NullTracer):
    """Install ``tracer`` as :func:`active` for the block, then put back
    what was there."""
    global _active
    before, _active = _active, tracer
    try:
        yield tracer
    finally:
        _active = before


def close_open(tracer: "Tracer", track: Track, since: int, **args) -> None:
    """End, innermost first, every span that ``tracer`` began on ``track``
    at or after event ``since`` and has not ended: the spans a raising call
    left open."""
    track = (str(track[0]), str(track[1]))
    stack: List[str] = []
    for ev in tracer.events[since:]:
        if ev["track"] != track:
            continue
        if ev["ph"] == "B":
            stack.append(ev["name"])
        elif ev["ph"] == "E" and stack:
            stack.pop()
    for name in reversed(stack):
        tracer.end(name, track, **args)


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


# the profiler's clock, read with no frame of its own
_default_clock = time.time
