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
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.formats import resolve_device

__all__ = ["time_us"]

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
