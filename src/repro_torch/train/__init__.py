"""Training substrate: so far only the fault-tolerance pieces that serving
uses — a copy of ``repro.train.fault`` (``FaultConfig``, ``FaultInjector``,
``Watchdog``, ``ProcessKilled``).  The optimizer, trainer, data and
checkpointing are not ported yet (ROADMAP queue 1)."""
from repro_torch.train.fault import (  # noqa: F401
    FaultConfig, FaultInjector, ProcessKilled, Watchdog)

__all__ = ["FaultConfig", "FaultInjector", "ProcessKilled", "Watchdog"]
