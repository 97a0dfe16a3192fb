"""Timing harness: the median device time of one call, in µs.

Each repeat puts one pair of ``torch.cuda.Event``s on the current stream
around ``calls`` back-to-back calls and divides by ``calls``, so the time is
the card's, not the enqueue's, and the host's work before a launch overlaps
the previous call instead of counting as device time.  Timing needs a card:
asking for it without one raises — a measurement never falls back to the
CPU's clock.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.formats import resolve_device

__all__ = ["time_us"]


def time_us(fn: Callable, *args, repeats: int = 5, warmup: int = 2,
            calls: int = 10, device="cuda") -> float:
    """Median over ``repeats`` of the device time of ``calls`` back-to-back
    ``fn(*args)``, divided by ``calls``, in µs.

    The warmup calls are waited for before the first repeat starts, so
    warmup work cannot bleed into it; ``warmup=0`` is valid.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"time_us times CUDA work; got device {dev}")
    if calls < 1:
        raise ValueError(f"calls must be >= 1, got {calls}")
    with torch.cuda.device(dev):
        for _ in range(warmup):
            fn(*args)
        torch.cuda.synchronize(dev)
        times = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / calls)
    return float(np.median(times))
