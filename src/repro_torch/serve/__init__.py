"""Serving: batch-synchronous ``Engine.generate`` and continuous batching
(``Engine.serve`` / ``EngineSession``) over paged KV caches, with the fused
decode loop as a CUDA graph on the card, fronted by a fault-tolerant
multi-replica router (``Router``)."""
from repro_torch.serve import paging  # noqa: F401
from repro_torch.serve.engine import (  # noqa: F401
    Engine, EngineSession, Request, ServeConfig)
from repro_torch.serve.paging import (  # noqa: F401
    PageAllocator, PageGeometry, PoolExhausted)
from repro_torch.serve.router import Replica, Router, RouterConfig  # noqa: F401
