"""Typed metrics registry: counters, gauges, histograms (DESIGN.md §13.1).

The serving stack used to carry its counters as ad-hoc dicts — the
session's ``stats``, the router's ``counters``, and
``paging.merge_replica_stats``'s hand-rolled sum/max/first merge.  This
module gives those three shapes one model:

* a **metric** is a named cell with a merge semantic: :class:`Counter`
  (monotonic, merges by sum), :class:`Gauge` (level, merges by max), or
  :class:`Histogram` (sample distribution, merges by concatenation —
  percentiles come from the merged samples, never from averaged
  percentiles).  Labels (``registry.counter("faults", replica=1)``)
  distinguish children of one logical metric.
* a :class:`MetricsRegistry` owns the metrics and round-trips them
  through JSON (:meth:`~MetricsRegistry.snapshot` /
  :meth:`~MetricsRegistry.restore`) so cumulative counters survive the
  §7.6 crash-consistent snapshots with no resets or double counts.
* a :class:`StatsView` is a ``MutableMapping`` facade over a registry's
  scalar metrics — existing ``stats["preemptions"] += 1`` call sites and
  ``dict(stats)`` consumers keep working unchanged while the values live
  in typed cells.
* :func:`merge_stats` replaces the ad-hoc replica merge with a
  declarative spec: each key names its :class:`MergeRule` (sum / max /
  first / histogram-map, optional per-replica list, optional gate key),
  and ``paging.merge_replica_stats`` is now a spec application.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, MutableMapping, Optional, Sequence

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsView",
           "MergeRule", "merge_stats", "percentile_summary",
           "timing_percentiles", "PERCENTILES"]

PERCENTILES = (50, 95, 99)


def _labels_key(labels) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in dict(labels).items()))


class Counter:
    """Monotonic scalar (events since birth).  Merge semantic: sum."""

    kind = "counter"

    def __init__(self, name: str, labels=()):
        self.name = name
        self.labels = dict(labels)
        self.value = 0

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r}: negative inc {n}")
        self.value += n

    def state(self):
        return self.value

    def load(self, state) -> None:
        self.value = state


class Gauge(Counter):
    """Level (current/peak capacity figure).  Merge semantic: max."""

    kind = "gauge"

    def set(self, v) -> None:
        self.value = v

    def set_max(self, v) -> None:
        self.value = max(self.value, v)


class Histogram:
    """Sample distribution with exact percentiles over retained samples.

    Raw samples are retained up to ``MAX_SAMPLES`` (the serving mixes sit
    far below it); overflow keeps ``count``/``sum`` exact and counts the
    discarded samples in ``dropped`` so truncated percentiles are
    *visible*, never silent.
    """

    kind = "histogram"
    MAX_SAMPLES = 4096

    def __init__(self, name: str, labels=()):
        self.name = name
        self.labels = dict(labels)
        self.count = 0
        self.total = 0.0
        self.dropped = 0
        self.samples: List[float] = []

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if len(self.samples) < self.MAX_SAMPLES:
            self.samples.append(v)
        else:
            self.dropped += 1

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        return float(np.percentile(np.asarray(self.samples, float), q))

    def state(self) -> Dict:
        return {"count": self.count, "sum": self.total,
                "dropped": self.dropped, "samples": list(self.samples)}

    def load(self, state: Dict) -> None:
        self.count = int(state.get("count", 0))
        self.total = float(state.get("sum", 0.0))
        self.dropped = int(state.get("dropped", 0))
        self.samples = [float(v) for v in state.get("samples", ())]

    @staticmethod
    def merge_states(states: Sequence[Dict]) -> Dict:
        """Concatenate histogram states (cross-replica merge): counts and
        sums add; samples concatenate up to the cap, the excess lands in
        ``dropped``."""
        merged = {"count": 0, "sum": 0.0, "dropped": 0, "samples": []}
        for st in states:
            if not st:
                continue
            merged["count"] += int(st.get("count", 0))
            merged["sum"] += float(st.get("sum", 0.0))
            merged["dropped"] += int(st.get("dropped", 0))
            room = Histogram.MAX_SAMPLES - len(merged["samples"])
            samples = list(st.get("samples", ()))
            merged["samples"].extend(samples[:room])
            merged["dropped"] += max(0, len(samples) - room)
        return merged


def percentile_summary(state, qs: Sequence[int] = PERCENTILES) -> Dict:
    """``{"p50": ..., "p95": ..., "p99": ...}`` from a histogram (or its
    :meth:`Histogram.state` dict).  Empty histogram → ``{}``."""
    samples = state.get("samples", ()) if isinstance(state, dict) \
        else state.samples
    if not samples:
        return {}
    arr = np.asarray(samples, float)
    return {f"p{q}": round(float(np.percentile(arr, q)), 6) for q in qs}


def timing_percentiles(timing_map: Dict) -> Dict:
    """Per-metric percentile summaries for a ``{name: hist_state}`` map
    (the session's ``request_timing``), skipping empty histograms."""
    out = {}
    for name in sorted(timing_map):
        pcts = percentile_summary(timing_map[name])
        if pcts:
            out[name] = pcts
    return out


class StatsView(MutableMapping):
    """Dict-compatible facade over a registry's unlabeled scalar metrics.

    ``view[k] += 1`` increments the underlying cell; assigning to an
    unseen key creates it on the fly (counter by default, gauge when the
    key was declared in ``gauges``); ``dict(view)`` and iteration walk
    the cells in creation order.  This is what keeps every existing
    ``session.stats["x"] += 1`` / snapshot-restore assignment site
    working unchanged on top of the typed registry.
    """

    def __init__(self, registry: "MetricsRegistry", gauges=()):
        self._reg = registry
        self._gauges = set(gauges)
        self._cells: Dict[str, Counter] = {}

    def _cell(self, key: str) -> Counter:
        cell = self._cells.get(key)
        if cell is None:
            maker = self._reg.gauge if key in self._gauges \
                else self._reg.counter
            cell = maker(key)
            self._cells[key] = cell
        return cell

    def __getitem__(self, key: str):
        cell = self._cells.get(key)
        if cell is None:
            raise KeyError(key)
        return cell.value

    def __setitem__(self, key: str, value) -> None:
        self._cell(key).value = value

    def __delitem__(self, key: str) -> None:
        raise TypeError("stats keys cannot be deleted — metrics are "
                        "registered for the session's lifetime")

    def __iter__(self) -> Iterator[str]:
        return iter(self._cells)

    def __len__(self) -> int:
        return len(self._cells)


class MetricsRegistry:
    """Owner of one process component's metrics (a session, a router).

    ``counter/gauge/histogram(name, **labels)`` get-or-create the typed
    cell; re-registering a name under a different kind is an error.
    :meth:`snapshot` / :meth:`restore` round-trip every cell through a
    JSON-serializable dict (deterministically ordered), which is how the
    serving session's cumulative counters and latency histograms ride
    the §7.6 host-state snapshots.
    """

    _KINDS = None  # filled below

    def __init__(self):
        self._metrics: Dict[tuple, Counter] = {}

    def _get(self, cls, name: str, labels):
        key = (name, _labels_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, dict(labels))
            self._metrics[key] = m
        elif not isinstance(m, cls) or m.kind != cls.kind:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, not {cls.kind}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def view(self, counters: Sequence[str] = (),
             gauges: Sequence[str] = ()) -> StatsView:
        """A :class:`StatsView` pre-seeded with zeroed cells for
        ``counters`` (sum-merged) and ``gauges`` (max-merged)."""
        view = StatsView(self, gauges=gauges)
        for key in list(counters) + list(gauges):
            view[key] = 0
        return view

    def snapshot(self) -> Dict:
        entries = []
        for (name, lk), m in sorted(self._metrics.items()):
            entry = {"name": name, "kind": m.kind, "state": m.state()}
            if lk:
                entry["labels"] = dict(lk)
            entries.append(entry)
        return {"version": 1, "metrics": entries}

    def restore(self, snap: Dict) -> None:
        for entry in snap.get("metrics", ()):
            cls = self._KINDS[entry["kind"]]
            m = self._get(cls, entry["name"], entry.get("labels", {}))
            m.load(entry["state"])

    def scalars(self) -> Dict[str, float]:
        """Flat ``{name: value}`` of every counter/gauge; labeled cells
        flatten as ``name{k=v,...}``."""
        out = {}
        for (name, lk), m in sorted(self._metrics.items()):
            if m.kind == "histogram":
                continue
            key = name if not lk else \
                name + "{" + ",".join(f"{k}={v}" for k, v in lk) + "}"
            out[key] = m.value
        return out


MetricsRegistry._KINDS = {"counter": Counter, "gauge": Gauge,
                          "histogram": Histogram}


# ---------------------------------------------------------------------------
# declarative cross-replica merge (the merge_replica_stats semantics)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MergeRule:
    """How one stats key aggregates across replica snapshots.

    ``kind``: ``"sum"`` (counters), ``"max"`` (gauges/high-waters),
    ``"first"`` (shared geometry/config — replicas agree by construction),
    ``"hist_map"`` (a ``{name: hist_state}`` map, merged per name by
    :meth:`Histogram.merge_states`).  ``list_as`` additionally emits the
    raw per-replica values under that key (skew visibility — a hot
    replica shows up as an outlier entry, not just a bigger aggregate).
    ``gate`` merges whenever *any* replica carries the gate key, even if
    this key is absent everywhere (missing entries contribute 0) — used
    for values that only exist alongside another metric family.
    """

    kind: str
    list_as: Optional[str] = None
    gate: Optional[str] = None


def merge_stats(per_replica: Sequence[Dict],
                spec: Dict[str, MergeRule]) -> Dict:
    """Apply a merge spec over per-replica stats dicts.

    Keys absent from every replica are omitted (unless gated in); keys
    outside the spec are dropped — the spec is the authoritative schema
    of the merged view."""
    merged: Dict = {}
    if not per_replica:
        return merged
    for key, rule in spec.items():
        if rule.gate is not None:
            if not any(rule.gate in s for s in per_replica):
                continue
        elif not any(key in s for s in per_replica):
            continue
        if rule.kind == "first":
            if key in per_replica[0]:
                merged[key] = per_replica[0][key]
        elif rule.kind == "sum":
            merged[key] = sum(s.get(key, 0) for s in per_replica)
        elif rule.kind == "max":
            merged[key] = max(s.get(key, 0) for s in per_replica)
        elif rule.kind == "hist_map":
            maps = [s.get(key) or {} for s in per_replica]
            names = sorted({n for m in maps for n in m})
            merged[key] = {
                n: Histogram.merge_states([m[n] for m in maps if n in m])
                for n in names}
        else:
            raise ValueError(f"unknown merge kind {rule.kind!r} for "
                             f"{key!r}")
        if rule.list_as is not None and rule.kind in ("sum", "max"):
            merged[rule.list_as] = [s.get(key, 0) for s in per_replica]
    return merged
