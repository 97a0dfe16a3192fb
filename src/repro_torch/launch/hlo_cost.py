"""Cost model of one step (FLOPs, HBM traffic, collective traffic), counted
while the step runs.

The PyTorch counterpart of ``repro.launch.hlo_cost``.  The reference
parses the compiled post-SPMD HLO text; the port has no compiled program,
so :func:`analyze_hlo` runs the step itself — on ``meta`` tensors in the
dry run (``launch/dryrun.py``), or on real ones — under one counting
``TorchDispatchMode`` and ``sharding.layout.collective_log``, and returns
the reference's :class:`HloCost` fields.  The mode applies
``FlopCounterMode``'s per-op formulas and ``MemTracker``'s storage rule
itself (``tests/test_torch_dryrun.py`` holds its counts to theirs):
stacked, the three modes cost ~60 µs an op, and a production cell runs
millions of ops.  The counts follow the rank that runs it (rank 0 in the
dry run), per step:

* **flops** — matrix products only (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``), as the reference counts ``dot`` only; elementwise and
  convolution flops are excluded.  ``flops_by_dtype`` splits them by the
  products' input dtype (a bf16 model still routes and scores attention
  in float32), which the roofline divides by each dtype's peak.
* **bytes** — result plus operand bytes of the aten ops that the
  reference's materializing HLO set names: products, reductions
  (``sum``, ``mean``, ``amax``, softmax, ``cumsum``...), gathers
  (``index``, ``index_select``, ``gather``, ``embedding``), scatters
  (``index_put_``, ``scatter``, ``index_add_``, ``slice_scatter``...),
  ``cat``, ``sort`` and ``topk``, copies (``clone``, ``copy_``,
  ``_to_copy``), ``constant_pad_nd``, and each collective's result and
  operand (from the log).  Elementwise ops are skipped, as in the
  reference.  Views (``slice``, ``select``, ``transpose``) move no bytes
  in eager torch and are not counted; the copy that makes one
  contiguous is.
* **loops** — eager torch has no ``while`` loop to multiply: a layer, a
  microbatch or a recomputed (remat) forward runs as often as it runs and
  is counted each time it does.  ``loops`` stays empty.
* **collectives** — the log's records through ``hlo_stats``'s ring model;
  ``collective_bytes_by_axis`` keeps the whole tensors' bytes by kind and
  mesh axis (``hlo_stats.moved_bytes``).
* **collective_bytes_f32_dot** is 0: it corrects the reference's CPU-XLA
  upcast of bf16 products before their all-reduce, which the port does
  not make.
* **temp_bytes** — the peak of live storage bytes on the arguments'
  device above the arguments (``held``): a storage counts from the op
  that makes it until it is freed.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import hlo_stats
from repro_torch.sharding import layout

__all__ = ["analyze_hlo", "HloCost", "MATERIALIZING", "PRODUCTS"]

_aten = torch.ops.aten
# the reference's `dot`
PRODUCTS = frozenset({_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm})
# the aten ops of the reference's `_MATERIALIZING` HLO set
MATERIALIZING = PRODUCTS | frozenset({
    # reduce, reduce-window
    _aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max, _aten.min,
    _aten.prod, _aten.logsumexp, _aten.cumsum, _aten.var_mean,
    _aten.linalg_vector_norm, _aten.argmax, _aten.argmin, _aten.any,
    _aten.all, _aten._softmax, _aten._log_softmax,
    _aten._softmax_backward_data, _aten._log_softmax_backward_data,
    # gather, dynamic-slice
    _aten.index, _aten.index_select, _aten.gather, _aten.embedding,
    # scatter, dynamic-update-slice
    _aten.index_put, _aten.index_put_, _aten._index_put_impl_,
    _aten.scatter, _aten.scatter_, _aten.scatter_add, _aten.scatter_add_,
    _aten.index_add, _aten.index_add_, _aten.index_copy,
    _aten.index_copy_, _aten.embedding_dense_backward,
    _aten.slice_scatter, _aten.select_scatter, _aten.masked_scatter,
    # concatenate, sort, copy, pad, convolution
    _aten.cat, _aten.stack, _aten.sort, _aten.topk, _aten.clone,
    _aten.copy_, _aten._to_copy, _aten.repeat, _aten.constant_pad_nd,
    _aten.convolution,
})
_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
          torch.float64: "f64", torch.int8: "s8", torch.int32: "s32",
          torch.int64: "s64", torch.bool: "pred"}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local slice (the rank's bytes); a tensor as it is."""
    return getattr(t, "_local_tensor", t)


def _items(x):
    """The tensors and other values of an aten op's arguments or result
    (a value, or a list or tuple of them), one level deep."""
    return x if isinstance(x, (list, tuple)) else (x,)


def _tensors(*trees):
    for tree in trees:
        for x in _items(tree):
            if isinstance(x, torch.Tensor):
                yield x
            elif isinstance(x, (list, tuple)):
                yield from (y for y in x if isinstance(y, torch.Tensor))


def _nbytes(*trees) -> int:
    return sum(_local(t).numel() * t.element_size()
               for t in _tensors(*trees))


def _shape_key(t: torch.Tensor) -> str:
    return f"{_SHORT.get(t.dtype, str(t.dtype))}" \
           f"[{','.join(str(d) for d in _local(t).shape)}]"


@dataclasses.dataclass
class HloCost:
    flops: float
    bytes: float
    collective_bytes: float
    collective_counts: Dict[str, int]
    collective_bytes_by_kind: Dict[str, float]
    loops: Dict[str, int]
    dot_flops_by_shape: Dict[str, float]
    # the reference's CPU-XLA upcast correction: 0 here (module's note)
    collective_bytes_f32_dot: float = 0.0
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_bytes_by_axis: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    collectives: List[layout.Collective] = dataclasses.field(
        default_factory=list)
    # the step's peak of live storage bytes on its arguments' device,
    # above them
    temp_bytes: int = 0

    @property
    def collective_bytes_tpu(self) -> float:
        """The reference's corrected collective traffic: the same as
        ``collective_bytes`` here."""
        return self.collective_bytes - 0.5 * self.collective_bytes_f32_dot


def _kind(func) -> str:
    """How an aten op's outputs relate to its inputs: ``"fresh"`` (new
    tensors whose metadata depends on the inputs' metadata alone),
    ``"inplace"`` (writes its first argument and returns it, metadata
    unchanged), else ``"other"`` (views, ``out=`` variants, resizes,
    other namespaces)."""
    schema = func._schema
    if func.namespace != "aten":
        return "other"
    returns, arguments = schema.returns, schema.arguments
    writes = [a for a in arguments if a.alias_info is not None
              and a.alias_info.is_write]
    if not writes and not any(r.alias_info for r in returns):
        return "fresh"
    name = func.overloadpacket.__name__
    if (name.endswith("_") and not name.startswith(("resize", "set_",
                                                     "as_strided"))
            and len(returns) == 1 and len(writes) == 1 and arguments
            and writes[0] is arguments[0] and returns[0].alias_info
            is not None and returns[0].alias_info.is_write):
        return "inplace"
    return "other"


class _StepCounter(TorchDispatchMode):
    """One dispatch mode for the whole count, below autograd: product
    FLOPs by dtype and result shape (``FlopCounterMode``'s per-op
    formulas, ``flop_registry``), the bytes of the materializing ops, and
    the live and peak bytes of every storage by device (``MemTracker``'s
    rule: a storage counts from the op that makes it until it is freed;
    views add nothing).  On ``meta`` tensors an op that makes fresh
    tensors, or writes its first argument in place, is run once per
    signature (op, input shapes, strides and dtypes, other arguments) and
    its outputs' metadata reused: a meta kernel costs 0.1–0.3 ms of
    Python, and the layers of a model repeat the same signatures
    thousands of times.  A DTensor op passes to
    DTensor, whose local ops come back here (``MemTracker`` does the
    same)."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor
        self.bytes = 0
        self.flops_by_dtype: Dict[str, float] = {}
        self.dot_shapes: Dict[str, float] = {}
        self.live: Dict[torch.device, int] = {}
        self.peak: Dict[torch.device, int] = {}
        self._storages: Dict[int, weakref.ref] = {}
        # id(op) → (kind, materializing, product), and the cache
        self._ops: Dict[int, tuple] = {}
        self._cache: Dict[tuple, object] = {}

    # ------------------------------------------------------------ memory
    def hold(self, t: torch.Tensor):
        """Count ``t``'s storage as live (the step's arguments, before it
        runs), on its device."""
        local = _local(t)
        st = local.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n, dev = st.nbytes(), local.device

        def freed(_, key=key, n=n, dev=dev):
            self.live[dev] -= n
            del self._storages[key]
        self._storages[key] = weakref.ref(st, freed)
        live = self.live[dev] = self.live.get(dev, 0) + n
        if live > self.peak.get(dev, 0):
            self.peak[dev] = live

    # ------------------------------------------------------------- cache
    @staticmethod
    def _sig(x):
        """A stand-in of one argument for the cache key, or None where
        the output may depend on more than metadata (a tensor off
        ``meta``, a subclass)."""
        tx = type(x)
        if tx is torch.Tensor or tx is torch.nn.Parameter:
            return (x.shape, x.stride(), x.dtype) if x.is_meta else None
        if tx is list or tx is tuple:
            out = []
            for y in x:
                sy = _StepCounter._sig(y)
                if sy is None and y is not None:
                    return None
                out.append(sy)
            return tuple(out)
        if isinstance(x, torch.Tensor):
            return None
        return x

    def _key(self, func, args, kwargs):
        key = [id(func)]
        for a in args:
            sa = self._sig(a)
            if sa is None and a is not None:
                return None
            key.append(sa)
        for k, v in kwargs.items():
            sv = self._sig(v)
            if sv is None and v is not None:
                return None
            key.append((k, sv))
        return tuple(key)

    def _run(self, func, args, kwargs, kind):
        key = self._key(func, args, kwargs) if kind != "other" else None
        if key is not None:
            try:
                hit = self._cache.get(key)
            except TypeError:                   # an unhashable argument
                key = hit = None
            if hit is not None:
                if kind == "inplace":
                    return args[0]
                if type(hit) is list:
                    return tuple(None if m is None else torch.empty_strided(
                        m[0], m[1], dtype=m[2], device="meta") for m in hit)
                return torch.empty_strided(hit[0], hit[1], dtype=hit[2],
                                           device="meta")
        out = func(*args, **kwargs)
        if key is not None:
            if kind == "inplace":
                self._cache[key] = True
            elif type(out) is torch.Tensor:
                if out.is_meta:
                    self._cache[key] = (out.shape, out.stride(), out.dtype)
            elif type(out) is tuple and all(
                    x is None or (type(x) is torch.Tensor and x.is_meta)
                    for x in out):
                self._cache[key] = [None if x is None else
                                    (x.shape, x.stride(), x.dtype)
                                    for x in out]
        return out

    def _describe(self, func) -> tuple:
        packet = func.overloadpacket
        info = (_kind(func), packet in MATERIALIZING, packet in PRODUCTS)
        self._ops[id(func)] = info
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for t in types:
            if t is not torch.Tensor and issubclass(t, self._dtensor):
                return NotImplemented
        kwargs = kwargs or {}
        kind, materializing, product = \
            self._ops.get(id(func)) or self._describe(func)
        out = self._run(func, args, kwargs, kind)
        if kind == "fresh" or kind == "other":  # an in-place op adds none
            if isinstance(out, torch.Tensor):
                self.hold(out)
            elif isinstance(out, (list, tuple)):
                for x in out:
                    if isinstance(x, torch.Tensor):
                        self.hold(x)
        if materializing:
            operands = args[1:] if func.overloadpacket is _aten.copy_ \
                else args
            self.bytes += _nbytes(out) + _nbytes(operands,
                                                 tuple(kwargs.values()))
        if product:
            packet = func.overloadpacket
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            a = args[1] if packet in (_aten.addmm, _aten.baddbmm) \
                else args[0]
            dt = str(a.dtype).replace("torch.", "")
            self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0.0) + f
            key = _shape_key(out)
            self.dot_shapes[key] = self.dot_shapes.get(key, 0.0) + f
        return out


def _collective_io_bytes(r: layout.Collective) -> int:
    """Result plus operand bytes of one logged collective."""
    n = max(1, r.size)
    if r.kind in ("all-gather", "reduce-scatter"):
        return r.bytes + r.bytes // n
    return 2 * r.bytes


def analyze_hlo(fn: Callable[[], object], n_devices: int,
                held: Iterable[torch.Tensor] = ()) -> HloCost:
    """Run ``fn()`` (one step; ``meta`` tensors or real ones) and count
    its cost on this rank (the module's note).  ``held``: the tensors
    alive before the step (its arguments), above whose bytes
    ``temp_bytes`` is the step's peak on their device (a host scalar the
    step makes on the side is not the device's).  ``n_devices`` is the
    group size of a logged collective that names none."""
    counter = _StepCounter()
    held = list(held)
    for t in held:
        counter.hold(t)
    dev = _local(held[0]).device if held else None
    start = counter.live.get(dev, 0)
    with layout.collective_log() as log, counter:
        fn()
    stats = hlo_stats.collective_stats(log, n_devices)
    kinds = [k for k in stats if isinstance(stats[k], dict)
             and stats[k]["count"]]
    return HloCost(
        flops=float(sum(counter.flops_by_dtype.values())),
        bytes=float(counter.bytes + sum(_collective_io_bytes(r)
                                        for r in log)),
        collective_bytes=stats["total_bytes"],
        collective_counts={k: stats[k]["count"] for k in kinds},
        collective_bytes_by_kind={k: stats[k]["bytes"] for k in kinds},
        loops={}, dot_flops_by_shape=counter.dot_shapes,
        flops_by_dtype=counter.flops_by_dtype,
        collective_bytes_by_axis=hlo_stats.moved_bytes(log),
        collectives=list(log),
        temp_bytes=counter.peak.get(dev, start) - start)
