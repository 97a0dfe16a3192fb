"""Training substrate: so far the pieces that serving uses — a copy of
``repro.train.fault`` (``FaultConfig``, ``FaultInjector``, ``Watchdog``,
``ProcessKilled``) and ``train.checkpoint`` (step checkpoints in the
reference's on-disk layout, and the serving snapshots).  The optimizer,
trainer and data are not ported yet (ROADMAP queue 1)."""
from repro_torch.train.fault import (  # noqa: F401
    FaultConfig, FaultInjector, ProcessKilled, Watchdog)

__all__ = ["FaultConfig", "FaultInjector", "ProcessKilled", "Watchdog"]
