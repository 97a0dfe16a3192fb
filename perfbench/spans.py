"""The program's own spans in a traced run: the span stretch, and what the
readers of span metrics share.

The port records spans and counters on its process-wide tracer
(``repro_torch.obs.trace.active``) only while one is installed.  The first
reader of a ``--trace 1`` run that asks for them runs the **span
stretch**: the cell's set-up again (its runner's ``setup`` on a copy of
the run, so the same program, weights and traffic from the same seed),
then the cell's own traffic under ``recording(Tracer())``, then the
runner's ``release``.  It leaves the events in ``run.host["span_events"]``
and the products or step calls it made in ``run.host["span_count"]``.

- Serving: step calls, clients resubmitting, until half a deck of
  requests has been admitted (``session.prefill`` spans), under a second
  :class:`~perfbench.trace.Slice` that profiles the card's activity alone
  (``run.host["span_slice"]``), whose idle time the shares split.  At
  most ``seconds``.
- Products: ``trace_seconds`` of blocks of ``enqueue_products`` products
  at the mix's renorm cadence, each block enqueued while a spin kernel
  holds the card, as ``host_us_per_product`` times its enqueues: no launch
  waits for queue space, so the spans time the host's own work.  No
  profiler runs, so none of its callbacks is timed.

It runs after the window, its check and every reader of the traced
slice, so the end-to-end metrics, ``run.slice`` and each metric read from
them see what they see without it; a ``--trace 0`` run never reaches it.
Where the program has no such tracer, or the run's call is a stand-in
(``run.substitute``), nothing is recorded and the readers return
``None``.

Times: the tracer's microseconds (``time.time``) and the profiler's
nanoseconds lie on one clock, so a span's events are compared with the
Slice's device activity after ``ts · 1000``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from perfbench import harness
from perfbench.trace import Slice

# the session's phases whose card-idle time each serving share counts: the
# innermost open span on the session's track is one of these.  Dispatch
# leaves out ``decode.wait``, which holds every replay after the first:
# the host blocked behind the card, whose idle there is the graph's own
ADMIT = ("session.admit", "session.prefill")
DISPATCH = ("session.schedule", "decode.dispatch")
COMMIT = ("session.commit",)

HOLD_S = 0.1                  # the spin's least hold over a block of products
SPIN_CYCLES_PER_S = 2.0e9     # above the card's clock: the hold outlasts


def _serving(run, st, tracer) -> int:
    """Step calls, clients resubmitting, until ``deck // 2`` requests have
    been admitted, or for at most the run's ``seconds``; returns the calls
    made."""
    loop, want = st.loop, max(1, int(run.traffic["deck"]) // 2)
    calls = seen = admitted = 0
    t0 = harness.now()
    while admitted < want and harness.now() - t0 < run.seconds:
        loop.scan(loop.step(), len(loop.calls) - 1, True)
        calls += 1
        admitted += sum(ev["ph"] == "B" and ev["name"] == "session.prefill"
                        for ev in tracer.events[seen:])
        seen = len(tracer.events)
    return calls


def _products(run, st, tracer) -> int:
    """Blocks of ``enqueue_products`` products, renormalised every
    ``renorm_every``, for ``trace_seconds``, each block enqueued while a
    spin kernel holds the card; returns the products."""
    import torch
    tr, dev = run.traffic, run.device
    every, block = int(tr["renorm_every"]), int(tr["enqueue_products"])
    cuda = dev.type == "cuda"
    hold, x, n, t0 = HOLD_S, st.x0, 0, harness.now()
    while harness.now() - t0 < float(tr["trace_seconds"]):
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda._sleep(int(SPIN_CYCLES_PER_S * hold))
        t = harness.now()
        for i in range(1, block + 1):
            x = st.product(x)
            if i % every == 0:
                x = x / torch.linalg.vector_norm(x, dim=0)
        n += block
        hold = max(hold, 4 * (harness.now() - t))  # outlasts the next block
    if cuda:
        torch.cuda.synchronize(dev)
    return n


class CardSlice(Slice):
    """A :class:`~perfbench.trace.Slice` that records the card's activity
    and no host operation: the host runs the stretch at its untraced pace
    (a profiler callback on each ATen op slows the eager prefill's host),
    and the read takes less time.  Its ``busy`` is read as ``Slice``'s."""

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        self.prof = profile(activities=[
            ProfilerActivity.CUDA if self.device.type == "cuda"
            else ProfilerActivity.CPU])
        self.prof.start()
        self.t0 = time.time_ns()


# each runner's stretch, by the runner's name in the mix, and whether the
# card's activity is traced beside it
STRETCHES = {"closed_loop": (_serving, True),
             "sparse_power": (_products, False)}


def recorded(run) -> bool:
    """Run the span stretch once for ``run``; whether it recorded."""
    if "span_events" not in run.host:
        run.host.update(span_events=None, span_slice=None, span_count=0)
        _stretch(run)
    return bool(run.host["span_events"])


def _stretch(run) -> None:
    stretch, profiled = STRETCHES.get(run.traffic["runner"], (None, False))
    if not run.trace or run.substitute is not None or stretch is None:
        return
    from repro_torch.obs import trace as program_trace
    if not hasattr(program_trace, "recording"):
        return                      # a program without the process-wide slot
    name = run.traffic["runner"]
    runner = harness.load_module(harness.BENCH_DIR / "runners" / f"{name}.py",
                                 "runner." + name)
    again = dataclasses.replace(run, host={}, e2e={}, phases=[], slice=None,
                                window_t0=None, window_s=0.0, attempted=0,
                                failed=0)
    st = runner.setup(again)
    try:
        tracer = program_trace.Tracer()
        sl = CardSlice(run.device) if profiled else None
        with program_trace.recording(tracer):
            if sl is not None:
                sl.start()
            count = stretch(again, st, tracer)
            if sl is not None:
                sl.stop()
    finally:
        runner.release(again, st)
        harness.free_device_memory()
    run.host.update(span_events=tracer.events, span_slice=sl,
                    span_count=count)


# ------------------------------------------------------------- reading
def spans(events: Iterable[dict], name: str) -> List[Tuple[int, int]]:
    """``(start, end)`` in ns of every span ``name``, whatever its track."""
    open_: Dict[tuple, List[int]] = {}
    out = []
    for ev in events:
        if ev["name"] != name:
            continue
        key = tuple(ev["track"])
        if ev["ph"] == "B":
            open_.setdefault(key, []).append(ev["ts"] * 1000)
        elif ev["ph"] == "E" and open_.get(key):
            out.append((open_[key].pop(), ev["ts"] * 1000))
    return out


def self_seconds(events: Iterable[dict], track) -> Dict[str, float]:
    """Each span name's self time on ``track``: its spans' time less what
    their child spans on the track cover, in seconds."""
    out: Dict[str, float] = {}
    for a, b, name in innermost(events, track):
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out


def innermost(events: Iterable[dict], track) -> List[Tuple[int, int, str]]:
    """The time under spans on ``track`` cut into ``(start, end, name)``
    pieces in ns, each under one innermost open span."""
    track = tuple(track)
    out, stack, prev = [], [], 0
    for ev in events:
        if tuple(ev["track"]) != track or ev["ph"] not in ("B", "E"):
            continue
        t = ev["ts"] * 1000
        if stack and t > prev:
            out.append((prev, t, stack[-1]))
        if ev["ph"] == "B":
            stack.append(ev["name"])
        elif stack:
            stack.pop()
        prev = t
    return out


def idle_intervals(sl) -> List[Tuple[int, int]]:
    """The card's idle intervals in the Slice's window: the complement of
    its ``busy`` union, as ``device_idle`` reads it."""
    out, prev = [], sl.t0
    for a, b in sl.busy:
        if a > prev:
            out.append((prev, a))
        prev = max(prev, b)
    if sl.t1 > prev:
        out.append((prev, sl.t1))
    return out


def overlap_ns(xs: Sequence[Tuple[int, int]],
               ys: Sequence[Tuple[int, int]]) -> int:
    """The time two sorted lists of disjoint intervals share."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def session_track(events: Iterable[dict]) -> Optional[tuple]:
    for ev in events:
        if ev["name"] == "session.step":
            return tuple(ev["track"])
    return None


def idle_share(run, names: Sequence[str]) -> Optional[float]:
    """Percent of the span Slice's window in which the card is idle and
    the innermost open span on the session's track is one of ``names``."""
    if not recorded(run):
        return None
    events, sl = run.host["span_events"], run.host["span_slice"]
    track = session_track(events)
    if track is None or sl is None or not sl.gpu or sl.t1 <= sl.t0:
        return None
    under = [(a, b) for a, b, name in innermost(events, track)
             if name in names]
    return 100.0 * overlap_ns(idle_intervals(sl), under) / (sl.t1 - sl.t0)


def per_product_us(run, name: str) -> Optional[float]:
    """Microseconds of the spans ``name`` a product (a ``sparse.call``)."""
    if not recorded(run):
        return None
    events = run.host["span_events"]
    products = len(spans(events, "sparse.call"))
    if not products:
        return None
    return sum(b - a for a, b in spans(events, name)) / products / 1e3
