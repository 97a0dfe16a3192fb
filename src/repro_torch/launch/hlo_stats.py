"""Collective traffic for the roofline's third term.

The PyTorch counterpart of ``repro.launch.hlo_stats``.  The reference
parses the post-SPMD HLO's collective instructions; the port records each
collective as it is called (``sharding.layout.collective_log``: kind, mesh
axis, group size and the bytes of the whole tensor it moves) and sums, per
kind, the per-device traffic with the same ring-algorithm byte model:

=================== ===========================================
all-gather           (n-1)/n · result_bytes
reduce-scatter       (n-1)/n · operand_bytes (= n · result)
all-reduce           2 · (n-1)/n · operand_bytes  (RS + AG ring)
all-to-all           (n-1)/n · operand_bytes
collective-permute   operand_bytes
=================== ===========================================

where ``n`` is the record's group size, at least 2 as in the reference.
"""
from __future__ import annotations

from typing import Dict, Iterable

__all__ = ["collective_stats", "ring_traffic", "moved_bytes"]

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def ring_traffic(kind: str, nbytes: float, size: int) -> float:
    """The per-device ring traffic of one collective of ``kind`` over a
    group of ``size`` ranks moving ``nbytes`` (its record's bytes)."""
    n = max(2, size)
    frac = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * frac * nbytes
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return frac * nbytes
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective kind {kind!r}")


def collective_stats(records: Iterable, n_devices: int) -> Dict:
    """Per-kind call counts and per-device traffic bytes of ``records``
    (``layout.Collective``s), with ``total_bytes`` and ``total_count``:
    the reference's dict.  ``n_devices`` is the group size of a record
    that has none (0), as the reference's default for an HLO line without
    replica groups."""
    stats = {k: {"count": 0, "bytes": 0.0} for k in _COLLECTIVES}
    for r in records:
        stats[r.kind]["count"] += 1
        stats[r.kind]["bytes"] += ring_traffic(r.kind, r.bytes,
                                               r.size or n_devices)
    stats["total_bytes"] = float(sum(v["bytes"] for v in stats.values()
                                     if isinstance(v, dict)))
    stats["total_count"] = int(sum(v["count"] for v in stats.values()
                                   if isinstance(v, dict)))
    return stats


def moved_bytes(records: Iterable) -> Dict[str, int]:
    """The bytes of the whole tensors ``records`` moved, summed by
    ``"<kind> <axis>"``: what the card's runs and the dry run print side
    by side."""
    out: Dict[str, int] = {}
    for r in records:
        key = f"{r.kind} {r.axis}"
        out[key] = out.get(key, 0) + r.bytes
    return out
