"""Training substrate: optimizer, data, checkpointing, fault tolerance.

The PyTorch counterpart of ``repro.train``: ``optimizer``, ``data``,
``trainer``, ``checkpoint`` (the reference's on-disk layout, and the
serving snapshots) and ``fault`` (a copy).  ``TrainConfig`` and
``Trainer`` are imported lazily, as in the reference: ``trainer`` imports
``launch.steps``, which imports ``train.optimizer``.
"""
from repro_torch.train.fault import (  # noqa: F401
    FaultConfig, FaultInjector, ProcessKilled, Watchdog)
from repro_torch.train.optimizer import (  # noqa: F401
    OptimizerConfig, make_optimizer)

__all__ = ["FaultConfig", "FaultInjector", "ProcessKilled", "Watchdog",
           "OptimizerConfig", "make_optimizer", "TrainConfig", "Trainer"]


def __getattr__(name):
    if name in ("TrainConfig", "Trainer"):
        from repro_torch.train import trainer
        return getattr(trainer, name)
    raise AttributeError(name)
