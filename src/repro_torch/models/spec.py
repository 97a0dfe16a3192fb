"""Parameter specs: one declaration per layer → real initial parameters.

Every layer declares its parameters as a tree (dicts and lists) of
:class:`P` (shape + logical axes + initializer).  ``init_from_spec`` draws
the tree of tensors from an explicit ``torch.Generator``; ``count_params``
and ``param_bytes`` read the spec without allocating.  The logical axes are
kept for parity with the reference's specs; the port runs on one card and
shards nothing.

The draws differ from the reference's for the same seed (torch's and JAX's
generators differ): parity tests carry the reference's parameters across
with :func:`repro_torch.models.params_from_numpy` instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = ["P", "init_from_spec", "count_params", "param_bytes",
           "spec_leaves", "map_spec"]


@dataclasses.dataclass(frozen=True)
class P:
    """Spec for one parameter tensor.

    ``axes`` are logical names, one per dim (None = never sharded).
    ``init`` ∈ {normal, zeros, ones, fan_in, embed} or a callable
    ``(generator, shape, dtype, device) -> tensor``; ``dtype`` (a
    ``torch.dtype``) overrides the tree's dtype for this tensor.
    """

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: Any = "fan_in"
    scale: float = 1.0
    dtype: Any = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def map_spec(fn: Callable, spec):
    """The tree of ``spec`` (dicts and lists) with ``fn(p)`` at each leaf."""
    if isinstance(spec, P):
        return fn(spec)
    if isinstance(spec, dict):
        return {k: map_spec(fn, v) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return [map_spec(fn, v) for v in spec]
    raise TypeError(f"spec trees hold dicts, lists and P, got {type(spec)}")


def spec_leaves(spec) -> Iterator[P]:
    """Every :class:`P` of the tree, in its order (dict insertion order)."""
    out = []
    map_spec(out.append, spec)
    return iter(out)


def _init_one(gen: torch.Generator, p: P, dtype, device) -> torch.Tensor:
    dtype = p.dtype or dtype
    shape = tuple(p.shape)
    if callable(p.init):
        return p.init(gen, shape, dtype, device)
    if p.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if p.init in ("normal", "embed"):
        z = torch.randn(shape, generator=gen, device=device)
        return (p.scale * z).to(dtype)
    if p.init == "fan_in":
        # truncated normal with 1/sqrt(fan_in); fan_in = prod of all dims
        # but the last
        fan_in = max(1, int(np.prod(shape[:-1])))
        std = p.scale / np.sqrt(fan_in)
        z = torch.nn.init.trunc_normal_(
            torch.empty(shape, device=device), 0.0, 1.0, -2.0, 2.0,
            generator=gen)
        return (std * z).to(dtype)
    raise ValueError(f"unknown init {p.init!r}")


def init_from_spec(spec, generator: torch.Generator, dtype=torch.float32,
                   device="cuda"):
    """Real parameters for a spec tree, drawn from ``generator`` (on
    ``device``) leaf by leaf in the tree's order."""
    with torch.no_grad():
        return map_spec(lambda p: _init_one(generator, p, dtype, device),
                        spec)


def count_params(spec) -> int:
    return int(sum(np.prod(p.shape) for p in spec_leaves(spec)))


def param_bytes(spec, dtype=torch.float32) -> int:
    return int(sum(np.prod(p.shape) * (p.dtype or dtype).itemsize
                   for p in spec_leaves(spec)))
