"""Serving: the batch-synchronous ``Engine.generate`` path."""
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: F401
