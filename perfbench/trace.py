"""A traced slice of a run: ``torch.profiler`` over a stretch of the
window, read back as device activities and host operations.

The slice starts and ends on a synchronized card, so every device
activity of the work enqueued inside it lies inside it.  From the
profiler's raw (kineto) events it keeps

- each device activity (kernels, copies, sets): name, start, duration,
  and whether a CUDA graph launched it or the host did, one by one (its
  correlation with the runtime call that launched it);
- the host's operations (ATen ops, the benchmark's own ranges, runtime
  calls) with their nesting, to name what the host was doing while the
  card sat idle.

Times are the profiler's nanoseconds, on the same clock as
``time.time_ns()``.
"""
from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Sequence, Tuple

import torch

TOP = 10            # entries of each breakdown list
# the benchmark's own host ranges (record_function), which the profiler
# also lists on the card's timeline: no device work
MIRRORED = ("bench.",)
GAPS_NAMED = 5000   # the longest idle gaps that are named


class Slice:
    """``start()`` … ``stop()`` around work on ``device``; then
    ``window_s``, ``busy_s``, :meth:`kernel_seconds` and
    :meth:`breakdown`."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = 0
        self.gpu: List[Tuple[str, int, int, bool]] = []
        self.cpu: List[Tuple[str, int, int]] = []
        self.busy: List[Tuple[int, int]] = []

    @staticmethod
    def warm(device) -> None:
        """Open and close one profiler session, so that the profiler's own
        start-up falls in set-up, not in a traced window."""
        sl = Slice(device)
        sl.start()
        torch.ones(1, device=device).add_(1)
        sl.stop()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        kinds = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            kinds.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=kinds)
        self.prof.start()
        self.t0 = time.time_ns()

    def stop(self) -> None:
        self._sync()
        self.t1 = time.time_ns()
        self.prof.stop()
        self._read(self.prof.profiler.kineto_results.events())
        self.prof = None

    # ------------------------------------------------------------ reading
    def _read(self, events) -> None:
        from torch.autograd import DeviceType
        runtime: Dict[int, str] = {}
        gpu_raw, cpu = [], []
        for e in events:
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if e.name().startswith(MIRRORED):
                    continue        # a host range mirrored on the card
                gpu_raw.append((e.name(), start, dur, e.correlation_id(),
                                e.linked_correlation_id()))
                continue
            name = e.name()
            if name.startswith(("cuda", "cu")) and not name.startswith(
                    "cuda::"):
                runtime[e.correlation_id()] = name
            cpu.append((name, start, start + dur))
        self.gpu = []
        for name, start, dur, corr, linked in gpu_raw:
            how = runtime.get(corr) or runtime.get(linked) or ""
            self.gpu.append((name, start, dur, "Graph" in how))
        self.cpu = sorted(cpu, key=lambda c: (c[1], -c[2]))
        self.busy = _union([(s, s + d) for _, s, d, _ in self.gpu],
                           self.t0, self.t1)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def kernel_seconds(self, names: Sequence[str],
                       graph_only: bool = False) -> float:
        """Seconds of the device activities whose name holds one of
        ``names``; with ``graph_only``, of those a CUDA graph launched."""
        return sum(d for n, _, d, g in self.gpu
                   if any(k in n for k in names)
                   and (g or not graph_only)) / 1e9

    def breakdown(self) -> dict:
        """``device_ops``: the device activities that took most time, by
        name; ``idle_gaps``: the card's idle time inside the slice by what
        the host was doing (the innermost host operation running at each
        gap's middle), the longest first."""
        ops = collections.Counter()
        for name, _, d, _ in self.gpu:
            ops[name[:120]] += d / 1e9
        gaps = []
        prev = self.t0
        for a, b in self.busy + [(self.t1, self.t1)]:
            if a > prev:
                gaps.append((a - prev, prev, a))
            prev = max(prev, b)
        gaps.sort(reverse=True)
        named = collections.Counter()
        tree = _Nesting(self.cpu)
        for length, a, b in gaps[:GAPS_NAMED]:
            named[tree.innermost((a + b) // 2)] += length / 1e9
        rest = sum(g[0] for g in gaps[GAPS_NAMED:]) / 1e9
        if rest:
            named["(shorter gaps, not named)"] += rest
        return {"device_ops": [[n, s] for n, s in ops.most_common(TOP)],
                "idle_gaps": [[n, s] for n, s in named.most_common(TOP)]}


def _union(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The intervals clipped to ``[lo, hi]`` and merged."""
    out: List[Tuple[int, int]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class _Nesting:
    """Host operations sorted by start, each with its parent (the
    operation that encloses it), to find the innermost one at a time."""

    def __init__(self, ops: List[Tuple[str, int, int]]):
        self.ops = ops
        self.starts = [o[1] for o in ops]
        self.parent = [-1] * len(ops)
        stack: List[int] = []
        for i, (_, a, b) in enumerate(ops):
            while stack and ops[stack[-1]][2] < b:
                if ops[stack[-1]][2] <= a:
                    stack.pop()
                else:
                    break
            self.parent[i] = stack[-1] if stack else -1
            stack.append(i)

    def innermost(self, t: int) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ops[i][2] < t:
            i = self.parent[i]
        return self.ops[i][0] if i >= 0 else "host (no traced op)"
