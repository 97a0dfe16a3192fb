"""Timing harness: the median time of one call on a CUDA card, in µs.

By default each repeat puts one pair of ``torch.cuda.Event``s on the
current stream around ``calls`` back-to-back calls and divides by
``calls``: the time a caller waits per call in a loop.  Where the card is
the slower, that is the card's time; where the host's work per call (a
Python wrapper around a short kernel) outlasts the kernels, the card idles
between calls and the pair measures the host.

Two options time the card alone, for a kernel's own (per-layer) metric:

- ``hold=True`` first queues a spin kernel (``torch.cuda._sleep``) long
  enough for the host to enqueue all ``calls``, so the card reaches the
  start event only when every timed call is queued behind it: the device
  time of a call with its inputs warm in the 50 MB L2 where they fit.  It
  hides the host, so it is not what a caller waits.
- ``cold=True`` also holds the card, and times each call alone after a
  write of a buffer twice the L2's size, so that the call reads its inputs
  from HBM, as in a solver that touches other vectors between calls.

Timing needs a card: asking for it without one raises — a measurement
never falls back to the CPU's clock.

:func:`profiled_time_us_group` is the autotuner's clock: the card's own
time of each of a group of callables, from one ``torch.profiler`` session
(a session costs far too much to open per candidate).  Repeat ``r`` of
callable ``i`` runs inside a ``record_function("tune:i:r")`` window that
ends in a synchronize, so the windows are disjoint on the host's clock and
on the card's; each CUDA kernel (or copy) the session recorded falls in
the window that holds its midpoint on the card's timeline (where the
profiler marks each window's span; its host clock drifts from the card's
by up to milliseconds), and a window's time is the sum of its events'
durations.  Windows that lost device records (the profiler drops some
after long sessions) are left out: a callable's time is the median of
its complete windows.  It returns ``None`` whenever the profiler records no
kernel — always on a host without a card — and the autotuner then falls
back to a clock it names in ``TuneResult.timing_source``.
"""
from __future__ import annotations

import bisect
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.formats import resolve_device

__all__ = ["time_us", "profiler_available", "profiled_time_us_group"]

_CYCLES_PER_S = {}


def _hold_card(seconds: float, dev) -> None:
    """Queue a spin kernel that keeps the card busy for about ``seconds``."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _CYCLES_PER_S:   # calibrate the spin once per card
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _CYCLES_PER_S[idx] = 1e7 / (start.elapsed_time(end) * 1e-3)
    torch.cuda._sleep(int(_CYCLES_PER_S[idx] * seconds))


def _l2_flush_buffer(dev):
    """A buffer twice the card's L2: writing it evicts every input."""
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size", 0)
    return torch.empty(max(2 * l2, 128 << 20) // 4, dtype=torch.float32,
                       device=dev)


def time_us(fn: Callable, *args, repeats: int = 5, warmup: int = 2,
            calls: int = 10, device="cuda", hold: bool = False,
            cold: bool = False) -> float:
    """Median over ``repeats`` of the time of ``calls`` back-to-back
    ``fn(*args)``, divided by ``calls``, in µs (see the module's note for
    ``hold`` and ``cold``).

    The warmup calls are waited for before the first repeat starts, so
    warmup work cannot bleed into it; ``warmup=0`` is valid.  The host's
    time to enqueue the last warmup call sizes the spin of ``hold`` and
    ``cold`` (no spin without warmup).
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"time_us times CUDA work; got device {dev}")
    if calls < 1:
        raise ValueError(f"calls must be >= 1, got {calls}")
    with torch.cuda.device(dev):
        flush = _l2_flush_buffer(dev) if cold else None
        host_s = 0.0
        for _ in range(warmup):
            t = time.perf_counter()
            fn(*args)
            host_s = time.perf_counter() - t
        torch.cuda.synchronize(dev)
        times = []
        for _ in range(repeats):
            if (hold or cold) and host_s:
                per_call = host_s + (2e-5 if cold else 0.0)
                _hold_card(min(1.5 * per_call * calls + 2e-4, 1.0), dev)
            if cold:
                pairs = []
                for _ in range(calls):
                    flush.zero_()
                    pairs.append((torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True)))
                    pairs[-1][0].record()
                    fn(*args)
                    pairs[-1][1].record()
                pairs[-1][1].synchronize()
                times.append(sum(s.elapsed_time(e) for s, e in pairs)
                             * 1e3 / calls)
                continue
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / calls)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# torch.profiler-backed card timing
# ---------------------------------------------------------------------------

_PROFILER_OK: Optional[bool] = None
# throwaway kernels at the head of each profiler session (see _window_times)
_HEAD_FILLER = 1024
# why the last profiler timing gave nothing (None after a success), and
# how many of its windows a successful one left out as incomplete
profiler_failure: Optional[str] = None
windows_left_out = 0


def profiler_available() -> bool:
    """Whether a ``torch.profiler`` session records CUDA kernels here
    (probed once per process; the probe's session also warms CUPTI, whose
    first start is slow).  False without a card."""
    global _PROFILER_OK, profiler_failure
    if _PROFILER_OK is None:
        _PROFILER_OK = False
        if not torch.cuda.is_available():
            profiler_failure = "no CUDA card"
        else:
            try:
                x = torch.ones(1024, device="cuda")
                got = _window_times([lambda: x.mul_(1.0)], repeats=1)
                _PROFILER_OK = got is not None
            except Exception as err:       # noqa: BLE001 — any failure
                profiler_failure = f"probe raised {err!r}"
    return _PROFILER_OK


def _window_times(fns: Sequence[Callable], repeats: int,
                  sessions: int = 3) -> Optional[List[List[float]]]:
    """Per callable, the card's µs in each of its complete windows (see
    :func:`_attribute`) of one profiler session; a session that leaves
    some callable without a complete window is run again, up to
    ``sessions`` times, and then ``None``."""
    global profiler_failure, windows_left_out
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    for _ in range(sessions):
        torch.cuda.synchronize()
        filler = torch.zeros(1, device="cuda")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # once a process has profiled long runs (CUDA graph replays
            # among them), the profiler loses the first device records of
            # each later session, one or a few: throwaway kernels, outside
            # every window, take their place
            for _ in range(_HEAD_FILLER):
                filler.zero_()
            torch.cuda.synchronize()
            for i, fn in enumerate(fns):
                for r in range(repeats):
                    with record_function(f"tune:{i}:{r}"):
                        fn()
                        torch.cuda.synchronize()
        events = [(str(ev.name), ev.device_type == DeviceType.CUDA,
                   bool(getattr(ev, "is_user_annotation", False)),
                   ev.time_range.start, ev.time_range.end)
                  for ev in prof.events()]
        got = _attribute(events, len(fns), repeats)
        if got is not None:
            profiler_failure = None
            windows_left_out = len(fns) * repeats - sum(map(len, got))
            return got
        spans = sum(e[1] and e[0].startswith("tune:") for e in events)
        profiler_failure = (
            f"a session of {len(fns) * repeats} windows recorded "
            f"{spans} window spans on the card and "
            f"{sum(e[1] and not e[2] for e in events)} device events")
    return None


def _attribute(events, n_fns: int, repeats: int
               ) -> Optional[List[List[float]]]:
    """Sum device events into the windows ``tune:i:r``.  ``events``:
    ``(name, on the card, is an annotation, start µs, end µs)``.

    A window is its annotation's span on the card's timeline (the
    profiler's ``gpu_user_annotation``: from the first to the last device
    event launched inside the window).  The host's span of the same
    window cannot stand in for it: the profiler's card and host clocks
    drift apart by up to milliseconds within one session.  Each device
    event counts in the window that holds its midpoint; events outside
    every window do not count.

    The profiler sometimes drops device records (seen on the card after
    long profiled runs), and with them a window's span or some of its
    events.  Each call of a callable launches the
    same work, so a window is complete when it holds as many device
    events as the fullest window of its callable; the others are left
    out.  Returns, per callable, the times of its complete windows;
    ``None`` when some callable has none."""
    windows, device = {}, []
    for name, on_card, annotation, t0, t1 in events:
        if not on_card:
            continue
        if name.startswith("tune:"):
            _, i, r = name.split(":")
            windows[(int(i), int(r))] = (t0, t1)
        elif not annotation:
            device.append((t0, t1))
    keys = sorted(windows, key=lambda k: windows[k][0])
    starts = [windows[k][0] for k in keys]
    sums, counts = dict.fromkeys(keys, 0.0), dict.fromkeys(keys, 0)
    for t0, t1 in device:
        mid = 0.5 * (t0 + t1)
        j = bisect.bisect_right(starts, mid) - 1
        if j >= 0 and mid <= windows[keys[j]][1]:
            sums[keys[j]] += t1 - t0
            counts[keys[j]] += 1
    out = []
    for i in range(n_fns):
        mine = [(i, r) for r in range(repeats) if (i, r) in windows]
        full = max((counts[k] for k in mine), default=0)
        if not full:
            return None
        out.append([sums[k] for k in mine if counts[k] == full])
    return out


def profiled_time_us_group(fns: Sequence[Callable], *, repeats: int = 3,
                           warmup: int = 1) -> Optional[List[float]]:
    """The card's time in µs of each zero-argument callable: the median
    over its complete windows of ``repeats`` in one profiler session (see
    the module's note).  Warmup calls (at least one each) run before the
    session, so no build or first-call work is timed.  ``None`` when the
    profiler is not available or leaves some callable without a complete
    window (``profiler_failure`` says why): the caller falls back to
    another clock."""
    global profiler_failure
    if not fns or not profiler_available():
        return None
    try:
        for fn in fns:
            for _ in range(max(1, warmup)):
                fn()
        per_window = _window_times(fns, repeats)
    except Exception as err:               # noqa: BLE001 — any failure
        profiler_failure = f"raised {err!r}"
        return None
    if per_window is None:
        return None
    return [float(np.median(t)) for t in per_window]
