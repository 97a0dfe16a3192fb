"""Observability: the metrics registry, the span tracer and the Chrome
trace export.

Copies of ``repro.obs.metrics``, ``repro.obs.trace`` and
``repro.obs.export``, which use no framework; only the import paths
differ.  They run on the host around the serving session
(``serve/engine.py``) and the router (``serve/router.py``).
"""
from repro_torch.obs import export, metrics, trace  # noqa: F401

__all__ = ["metrics", "trace", "export"]
