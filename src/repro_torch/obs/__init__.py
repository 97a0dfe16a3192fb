"""Observability: the metrics registry and the span tracer.

Copies of ``repro.obs.metrics`` and ``repro.obs.trace``, which use no
framework; only the import paths differ.  Both run on the host around the
serving session (``serve/engine.py``).  The Chrome-trace export
(``repro.obs.export``) is not ported yet (ROADMAP queue 1).
"""
from repro_torch.obs import metrics, trace  # noqa: F401

__all__ = ["metrics", "trace"]
