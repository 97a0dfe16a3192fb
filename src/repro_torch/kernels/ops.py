"""Public wrappers around the CUDA kernels + the plan/cache layer.

The PyTorch counterpart of the single-device half of ``repro.kernels.ops``.

``RgCSRPlan`` is the device-resident execution plan built once per
(matrix, kernel config) — the format-compile step: the flat grouped storage
reshaped into the ``(S, G)`` slot-major tile the kernels consume, plus the
**step table** (``step_group``/``step_first``).  With ``chunks_per_step > 1``
every group's slot count is padded up to a multiple of ``8·chunks_per_step``
(DESIGN.md §3); the padding is exact zeros with ghost column 0.  Plan arrays
are byte-equal to the reference's; the port adds ``group_step_ptr``, the
per-group step range the CUDA kernels walk, because GPU blocks do not run
in the order of a step table.

``PlanCache`` is the process-wide memo: SpMV-heavy paths fetch plans
through ``get_plan`` instead of rebuilding host-side layouts per call.
Entries are keyed on matrix identity + config and evicted when the matrix
is garbage-collected.

Plans live on the matrix's device.  The wrappers launch the CUDA kernels for
CUDA tensors and run the kernels' plain PyTorch versions for CPU tensors.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import weakref
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.formats import (ELLPACK, RgCSR, _host, _tensor,
                                      resolve_device)
from repro_torch.core.ordering import descending_from_lengths, split_spill_rows
from repro_torch.kernels.ell_spmv import ell_spmv_launch
from repro_torch.kernels.rgcsr_spmm import rgcsr_spmm_launch
from repro_torch.kernels.rgcsr_spmv import (CHUNKS_PER_STEP_CHOICES, LANES,
                                            SUBLANES, rgcsr_spmv_launch)

__all__ = ["RgCSRPlan", "make_plan", "rgcsr_spmv", "rgcsr_spmm",
           "EllPlan", "make_ell_plan", "ell_spmv", "plan_from_numpy",
           "PlanCache", "PLAN_CACHE", "get_plan"]


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _group_step_ptr(step_group: np.ndarray, step_first: np.ndarray,
                    n_groups: int) -> np.ndarray:
    """``(n_groups + 1,)`` int32: group ``g`` owns steps ``[ptr[g], ptr[g+1])``.

    Needs the reference's step-table invariant: each group's steps are
    consecutive, groups appear in order, and ``step_first`` marks exactly
    the first step of each group.
    """
    sg = np.asarray(step_group).astype(np.int64)
    starts = np.diff(sg, prepend=-1) != 0
    if len(sg) and (np.any(np.diff(sg) < 0) or sg[0] < 0
                    or sg[-1] >= n_groups
                    or not np.array_equal(starts, np.asarray(step_first) != 0)):
        raise ValueError("step table is not group-contiguous: the CUDA "
                         "kernels need each group's steps consecutive, in "
                         "group order, with step_first on each first step")
    ptr = np.zeros(n_groups + 1, dtype=np.int64)
    np.cumsum(np.bincount(sg, minlength=n_groups), out=ptr[1:])
    return ptr.astype(np.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class RgCSRPlan:
    """Kernel-ready layout for one RgCSR matrix at one kernel config.

    ``step_group``/``step_first`` form the coarsened step table: step ``s``
    covers slot rows ``[R·s, R·(s+1))`` of ``values2d``/``columns2d``
    (``R = 8·chunks_per_step``) and belongs to group ``step_group[s]``.
    ``group_step_ptr`` is the same table as one step range per group.

    **Adaptive plans** (``ordering='adaptive'``, DESIGN.md §5): groups hold
    length-sorted rows instead of consecutive ones, so the kernel's output
    lives in the *permuted* row space.  ``gather_idx``/``grouped_mask`` map
    it back to original rows, and rows longer than ``spill_threshold`` live
    in the COO tail (``spill_*``), added by a segment sum in the epilogue.
    Block plans leave these ``None``.
    """

    values2d: Any       # (S, G)
    columns2d: Any      # (S, G) int32
    step_group: Any     # (num_steps,) int32
    step_first: Any     # (num_steps,) int32
    n_rows: int
    n_cols: int
    n_groups: int
    group_size: int
    chunks_per_step: int = 1
    # --- adaptive grouping (None/defaults on block plans) ---
    ordering: str = "block"        # "block" | "adaptive"
    spill_threshold: int = 0       # 0 = no spill
    nnz: int = -1                  # true nonzeros incl. spill (-1 = unknown)
    gather_idx: Any = None         # (n_rows,) int32: flat kernel-output index
    grouped_mask: Any = None       # (n_rows,) bool: False = row is spilled
    spill_values: Any = None       # (nnz_spill,)
    spill_rows: Any = None         # (nnz_spill,) int32 original row ids
    spill_columns: Any = None      # (nnz_spill,) int32
    # --- the port's own: (n_groups + 1,) int32 step range of each group ---
    group_step_ptr: Any = None

    def __post_init__(self):
        if self.group_step_ptr is None:
            ptr = _group_step_ptr(_host(self.step_group),
                                  _host(self.step_first), self.n_groups)
            object.__setattr__(self, "group_step_ptr",
                               _tensor(ptr, self.values2d.device))

    @property
    def num_steps(self) -> int:
        """Steps of the step table."""
        return int(self.step_group.shape[0])

    @property
    def num_chunks(self) -> int:
        """8-slot chunks covered (= num_steps · chunks_per_step)."""
        return self.num_steps * self.chunks_per_step

    @property
    def stored_slots(self) -> int:
        return int(self.values2d.shape[0])

    @property
    def n_spilled_elements(self) -> int:
        return 0 if self.spill_values is None else int(
            self.spill_values.shape[0])

    @property
    def stored_elements(self) -> int:
        """Grouped slots × lanes + COO tail (the format's byte footprint)."""
        return self.stored_slots * self.group_size + self.n_spilled_elements

    @property
    def padded_slot_fraction(self) -> float:
        """Fraction of stored elements that are padding (artificial zeros).

        The paper's fill-ratio metric normalized to stored bytes: on a
        memory-bound op this is directly the fraction of wasted HBM traffic.
        Requires ``nnz`` (set by ``make_plan``).
        """
        if self.nnz < 0 or self.stored_elements == 0:
            return 0.0
        return (self.stored_elements - self.nnz) / self.stored_elements


def make_plan(m: RgCSR, *, chunks_per_step: int = 1,
              ordering: str = "block",
              spill_threshold: int = 0) -> RgCSRPlan:
    """Plan construction (format-compile), on the matrix's device.

    ``chunks_per_step`` coarsens the step table: each group's ``(K_g, G)``
    tile is re-padded so ``K_g`` is a multiple of ``8·chunks_per_step``.  The
    extra rows are exact zeros (ghost column 0), so summing them is a no-op.

    ``ordering='adaptive'`` (DESIGN.md §5) regroups rows by descending
    length so same-length rows share groups, and rows longer than
    ``spill_threshold`` (> 0) leave the grouped storage for a COO tail.
    The kernel then computes in the permuted row space; the SpMV/SpMM
    wrappers add the inverse gather and the tail back in.
    """
    if m.group_size % LANES != 0:
        raise ValueError(
            f"plan needs group_size % {LANES} == 0, got {m.group_size} "
            f"(use group_size=128/256/512; smaller groups are modeled, not run "
            f"— DESIGN.md §2)")
    if m.slot_pad % SUBLANES != 0:
        raise ValueError(f"slot_pad must be a multiple of {SUBLANES}")
    if chunks_per_step not in CHUNKS_PER_STEP_CHOICES:
        raise ValueError(
            f"chunks_per_step must be one of {CHUNKS_PER_STEP_CHOICES}, "
            f"got {chunks_per_step}")
    if ordering not in ("block", "adaptive"):
        raise ValueError(
            f"ordering must be 'block' or 'adaptive', got {ordering!r}")
    if ordering == "adaptive":
        return _make_adaptive_plan(m, chunks_per_step=chunks_per_step,
                                   spill_threshold=int(spill_threshold))
    if spill_threshold:
        raise ValueError(
            "spill_threshold requires ordering='adaptive' (block grouping "
            "cannot drop rows without a permutation gather)")
    g = m.group_size
    dev = m.values.device
    rows_per_step = chunks_per_step * SUBLANES
    slots = _host(m.slots_per_group).astype(np.int64)
    total_slots = int(slots.sum())
    values2d = m.values.reshape(total_slots, g)
    columns2d = m.columns.reshape(total_slots, g)

    padded = -(-slots // rows_per_step) * rows_per_step
    if int(padded.sum()) != total_slots:
        # re-pad each group's tile up to the coarsened step granularity
        src_off = np.concatenate([[0], np.cumsum(slots)[:-1]])
        dst_off = np.concatenate([[0], np.cumsum(padded)[:-1]])
        dst = _tensor(np.arange(total_slots) + np.repeat(dst_off - src_off,
                                                         slots), dev)
        vp = values2d.new_zeros((int(padded.sum()), g))
        cp = columns2d.new_zeros((int(padded.sum()), g))
        values2d = vp.index_copy_(0, dst, values2d)
        columns2d = cp.index_copy_(0, dst, columns2d)

    step_group, step_first = _step_table(padded, rows_per_step)
    return RgCSRPlan(
        values2d=values2d,
        columns2d=columns2d,
        step_group=_tensor(step_group, dev),
        step_first=_tensor(step_first, dev),
        n_rows=m.shape[0],
        n_cols=m.shape[1],
        n_groups=m.n_groups,
        group_size=g,
        chunks_per_step=chunks_per_step,
        nnz=m.nnz,
        group_step_ptr=_tensor(_group_step_ptr(step_group, step_first,
                                               m.n_groups), dev),
    )


def _step_table(padded_slots: np.ndarray, rows_per_step: int):
    """(step_group, step_first) for per-group padded slot counts."""
    steps_per_group = (padded_slots // rows_per_step).astype(np.int64)
    n_groups = len(steps_per_group)
    step_group = np.repeat(np.arange(n_groups, dtype=np.int32),
                           steps_per_group)
    first_idx = np.cumsum(np.concatenate([[0], steps_per_group[:-1]]))
    step_first = np.zeros(len(step_group), dtype=np.int32)
    step_first[first_idx] = 1
    return step_group, step_first


def _make_adaptive_plan(m: RgCSR, *, chunks_per_step: int,
                        spill_threshold: int) -> RgCSRPlan:
    """Length-aware regrouping + pathological-row spill (DESIGN.md §5).

    1. rows with nnz > ``spill_threshold`` (if > 0) leave for the COO tail;
    2. remaining rows are permuted by descending length (stable), so each
       group of ``G`` rows has near-uniform lengths and its slot count
       ``K_g = roundup(max len in group, 8·chunks_per_step)`` carries
       minimal padding under the alignment constraint;
    3. the kernel output is in permuted space — ``gather_idx`` maps original
       row ``r`` to its flat output lane, ``grouped_mask`` marks spilled
       rows (their value comes from the tail's segment sum alone).

    Index arithmetic runs on the host in numpy; values and columns move
    from the matrix's storage to the plan on its device.
    """
    g = m.group_size
    dev = m.values.device
    rows_per_step = chunks_per_step * SUBLANES
    n_rows, n_cols = m.shape
    row_lens = _host(m.row_lengths).astype(np.int64)
    flat, row_ptr = m.csr_positions()

    grouped_rows, spilled_rows = split_spill_rows(row_lens, spill_threshold)
    order = descending_from_lengths(row_lens[grouped_rows])
    perm = grouped_rows[order]                 # position p holds row perm[p]
    n_grouped = len(perm)
    n_groups = max(1, -(-n_grouped // g))

    # per-group slot counts: own max length, aligned to the step granularity
    lens = np.zeros(n_groups * g, dtype=np.int64)
    lens[:n_grouped] = row_lens[perm]
    slots = np.maximum(lens.reshape(n_groups, g).max(axis=1), 1)
    slots = -(-slots // rows_per_step) * rows_per_step
    offsets = np.concatenate([[0], np.cumsum(slots)[:-1]])

    grouped_mask = np.zeros(n_rows, bool)
    grouped_mask[perm] = True
    position = np.zeros(n_rows, dtype=np.int64)
    position[perm] = np.arange(n_grouped)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), row_lens)
    slot = np.arange(len(rows), dtype=np.int64) - np.repeat(row_ptr[:-1],
                                                            row_lens)
    sel = grouped_mask[rows]
    p = position[rows[sel]]
    dst = _tensor((offsets[p // g] + slot[sel]) * g + p % g, dev)
    src = _tensor(flat[sel], dev)
    total = int(slots.sum()) * g
    values2d = m.values.new_zeros(total).index_copy_(0, dst, m.values[src])
    columns2d = m.columns.new_zeros(total).index_copy_(0, dst, m.columns[src])

    step_group, step_first = _step_table(slots, rows_per_step)
    gather_idx = np.zeros(n_rows, np.int32)
    gather_idx[perm] = np.arange(n_grouped, dtype=np.int32)
    spill = _tensor(flat[~sel], dev)

    return RgCSRPlan(
        values2d=values2d.reshape(-1, g),
        columns2d=columns2d.reshape(-1, g),
        step_group=_tensor(step_group, dev),
        step_first=_tensor(step_first, dev),
        n_rows=n_rows,
        n_cols=n_cols,
        n_groups=n_groups,
        group_size=g,
        chunks_per_step=chunks_per_step,
        ordering="adaptive",
        spill_threshold=spill_threshold,
        nnz=m.nnz,
        gather_idx=_tensor(gather_idx, dev),
        grouped_mask=_tensor(grouped_mask, dev),
        spill_values=m.values[spill],
        spill_rows=_tensor(rows[~sel].astype(np.int32), dev),
        spill_columns=m.columns[spill],
        group_step_ptr=_tensor(_group_step_ptr(step_group, step_first,
                                               n_groups), dev),
    )


def plan_from_numpy(fields: Dict[str, Any], *, device="cuda") -> RgCSRPlan:
    """A plan from the fields of ``repro.kernels.ops.RgCSRPlan``, with every
    array field given as a numpy array (``None`` where the reference has
    none); ``group_step_ptr`` is derived from the step table."""
    dev = resolve_device(device)
    kwargs = {}
    for f in dataclasses.fields(RgCSRPlan):
        if f.name == "group_step_ptr" or f.name not in fields:
            continue
        v = fields[f.name]
        if isinstance(v, np.ndarray):
            v = _tensor(v, dev)
        kwargs[f.name] = v
    return RgCSRPlan(**kwargs)


# ---------------------------------------------------------------------------
# PlanCache — process-wide memo of (matrix identity, config) -> RgCSRPlan
# ---------------------------------------------------------------------------


class PlanCache:
    """LRU plan cache keyed on matrix identity + kernel config.

    Keys use ``id(matrix)`` plus every plan-shaping config field —
    ``(chunks_per_step, ordering, spill_threshold)`` — so a block plan and
    an adaptive plan of the same matrix (or two adaptive plans at different
    spill thresholds) can never shadow each other.  A ``weakref.finalize``
    hook evicts every config of a matrix when it is garbage-collected
    (CPython runs the finalizer during deallocation, before the id can be
    reused).  Thread-safe; plan *construction* happens outside the lock so
    concurrent misses on different matrices don't serialize.
    """

    def __init__(self, maxsize: int = 256):
        self.maxsize = maxsize
        self._plans: "collections.OrderedDict[tuple, RgCSRPlan]" = \
            collections.OrderedDict()
        self._finalized: set = set()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    def get(self, m: RgCSR, *, chunks_per_step: int = 1,
            ordering: str = "block", spill_threshold: int = 0) -> RgCSRPlan:
        key = (id(m), chunks_per_step, ordering, int(spill_threshold))
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self.hits += 1
                self._plans.move_to_end(key)
                return plan
        plan = make_plan(m, chunks_per_step=chunks_per_step,
                         ordering=ordering, spill_threshold=spill_threshold)
        with self._lock:
            if key not in self._plans:
                self.misses += 1
                self._plans[key] = plan
                if id(m) not in self._finalized:
                    self._finalized.add(id(m))
                    weakref.finalize(m, self._evict, id(m))
                while len(self._plans) > self.maxsize:
                    self._plans.popitem(last=False)
            else:
                self.hits += 1
                plan = self._plans[key]
        return plan

    def _evict(self, mid: int) -> None:
        with self._lock:
            self._finalized.discard(mid)
            for key in [k for k in self._plans if k[0] == mid]:
                del self._plans[key]

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self._finalized.clear()
            self.hits = 0
            self.misses = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._plans)}

    def __len__(self) -> int:
        return len(self._plans)


PLAN_CACHE = PlanCache()


def get_plan(m: RgCSR, *, chunks_per_step: int = 1, ordering: str = "block",
             spill_threshold: int = 0) -> RgCSRPlan:
    """Fetch (or build and memoize) the kernel plan for ``m``."""
    return PLAN_CACHE.get(m, chunks_per_step=chunks_per_step,
                          ordering=ordering, spill_threshold=spill_threshold)


# ---------------------------------------------------------------------------
# SpMV / SpMM wrappers
# ---------------------------------------------------------------------------


def _gatherable(x):
    """x as the kernels read it.  Padding slots point at column 0, which
    every x with a row has; an empty x becomes one zero row."""
    if x.shape[0]:
        return x.contiguous()
    return x.new_zeros((1,) + tuple(x.shape[1:]))


def _check_operand(plan, x, ndim: int, what: str) -> None:
    if x.dim() != ndim or x.shape[0] != plan.n_cols:
        raise ValueError(f"{what}: expected {ndim}-D x with {plan.n_cols} "
                         f"rows, got shape {tuple(x.shape)}")
    if x.device != plan.values2d.device:
        raise ValueError(f"{what}: x is on {x.device}, the plan on "
                         f"{plan.values2d.device}")


def _adaptive_finish_spmv(y_flat, x, plan: RgCSRPlan):
    """Adaptive epilogue: inverse-permutation gather + COO tail.

    Original row ``r`` reads lane ``gather_idx[r]`` of the permuted kernel
    output (spilled rows masked to zero) and the pathological rows come back
    as a segment sum over the COO tail.  On CUDA ``index_add_`` adds with
    atomics, so the tail's sum order — and its last bits — vary by run.
    """
    out = torch.where(plan.grouped_mask, y_flat[plan.gather_idx.long()],
                      y_flat.new_zeros(()))
    if plan.n_spilled_elements:
        prods = plan.spill_values * x[plan.spill_columns.long()]
        out = out.to(prods.dtype).index_add_(0, plan.spill_rows.long(), prods)
    return out


def _adaptive_finish_spmm(y2d, x, plan: RgCSRPlan):
    """SpMM twin of :func:`_adaptive_finish_spmv` (row gather over axis 0)."""
    out = torch.where(plan.grouped_mask[:, None],
                      y2d[plan.gather_idx.long()], y2d.new_zeros(()))
    if plan.n_spilled_elements:
        prods = x[plan.spill_columns.long()] * plan.spill_values[:, None]
        out = out.to(prods.dtype).index_add_(0, plan.spill_rows.long(), prods)
    return out


def rgcsr_spmv(plan: RgCSRPlan, x, *, x_tile: int | None = None):
    """y = A @ x via K1. x: (n_cols,) -> y: (n_rows,).

    The reference tiled x by columns to bound TPU VMEM; the kernel reads x
    whole, unpadded, so ``x_tile`` is accepted for the reference's signature
    and every value of it gives the same y.

    Adaptive plans return through the epilogue (inverse gather + spill
    segment sum); block plans slice the contiguous rows.
    """
    _check_operand(plan, x, 1, "rgcsr_spmv")
    y = rgcsr_spmv_launch(plan.values2d, plan.columns2d, plan.step_group,
                          plan.group_step_ptr, _gatherable(x),
                          chunks_per_step=plan.chunks_per_step)
    y_flat = y.reshape(-1)
    if plan.ordering != "adaptive":
        return y_flat[: plan.n_rows]
    return _adaptive_finish_spmv(y_flat, x, plan)


def rgcsr_spmm(plan: RgCSRPlan, x, *, d_tile: int = LANES):
    """Y = A @ X via K2. X: (n_cols, d) -> Y: (n_rows, d).

    ``d_tile`` is the kernel's d-chunk per CTA (capped at 128 columns); the
    kernel masks the d edge, so X is not padded.
    """
    _check_operand(plan, x, 2, "rgcsr_spmm")
    y = rgcsr_spmm_launch(plan.values2d, plan.columns2d, plan.step_group,
                          plan.group_step_ptr, _gatherable(x),
                          chunks_per_step=plan.chunks_per_step,
                          d_tile=d_tile)
    if plan.ordering != "adaptive":
        return y[: plan.n_rows]
    return _adaptive_finish_spmm(y, x, plan)


# ---------------------------------------------------------------------------
# ELLPACK
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class EllPlan:
    values2d: Any   # (K_pad, N_pad)
    columns2d: Any  # (K_pad, N_pad)
    n_rows: int
    n_cols: int


def make_ell_plan(m: ELLPACK) -> EllPlan:
    """Pad the slot-major arrays to ``(K % 8, N % 128)`` on their device."""
    k, n = m.values.shape
    k_pad, n_pad = _pad_to(k, SUBLANES), _pad_to(n, LANES)
    vp = m.values.new_zeros((k_pad, n_pad))
    cp = m.columns.new_zeros((k_pad, n_pad))
    vp[:k, :n] = m.values
    cp[:k, :n] = m.columns
    return EllPlan(values2d=vp, columns2d=cp, n_rows=m.shape[0],
                   n_cols=m.shape[1])


def ell_spmv(plan: EllPlan, x):
    """y = A @ x via K3. x: (n_cols,) -> y: (n_rows,)."""
    _check_operand(plan, x, 1, "ell_spmv")
    return ell_spmv_launch(plan.values2d, plan.columns2d,
                           _gatherable(x))[: plan.n_rows]
