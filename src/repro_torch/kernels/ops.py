"""Public wrappers around the CUDA kernels + the plan/cache layer.

The PyTorch counterpart of the single-device half of ``repro.kernels.ops``.

``RgCSRPlan`` is the device-resident execution plan built once per
(matrix, kernel config) — the format-compile step: the flat grouped storage
reshaped into the ``(S, G)`` slot-major tile the kernels consume, plus the
**step table** (``step_group``/``step_first``).  With ``chunks_per_step > 1``
every group's slot count is padded up to a multiple of ``8·chunks_per_step``
(DESIGN.md §3); the padding is exact zeros with ghost column 0.  Plan arrays
are byte-equal to the reference's; the port adds two derived fields of its
own: ``group_step_ptr``, the per-group step range the CUDA kernels walk,
because GPU blocks do not run in the order of a step table, and
``seg_slots``, how many leading slot rows of each 32-lane segment of each
group hold anything but padding, so that the kernels skip trailing padding.

``RgCSRPlan.work_list`` cuts long groups into pieces for K1 or K2, built
once per plan, kernel and piece size (see :class:`WorkList`).

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
           "PlanCache", "PLAN_CACHE", "get_plan", "WorkList", "SEGMENT",
           "plan_from_params", "warm_plans_from_params"]

# Lanes of one warp: the unit in which seg_slots counts live slot rows.
SEGMENT = 32
# The piece-size rule aims at this many pieces' worth of slot rows per SM,
CTAS_PER_SM = 16
# and cuts no piece shorter than this (a multiple of every step, 8·cps):
# splitting a short group buys little and costs the combine launch.
MIN_PIECE_ROWS = 64
# Largest fp32 partial workspace the piece-size rule allows (K2: pieces of
# split groups × G × d × 4 bytes).
WORKSPACE_BYTES = 64 << 20


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _seg_slots(values2d, columns2d, step_group, group_step_ptr,
               rows_per_step: int, n_groups: int):
    """``(n_groups, G/32)`` int32 on the plan's device: for each 32-lane
    segment of each group, the number of leading slot rows in which some
    lane of the segment holds a slot that is not padding (value 0 with
    column 0).  Every slot row past the count is padding in all 32 lanes."""
    s, g = values2d.shape
    dev = values2d.device
    live = ((values2d != 0) | (columns2d != 0)).reshape(
        s, g // SEGMENT, SEGMENT).any(-1)
    ends = torch.arange(1, s + 1, device=dev)[:, None] * live  # row + 1
    row_group = step_group.long().repeat_interleave(rows_per_step)
    last = torch.zeros((n_groups, g // SEGMENT), dtype=torch.int64,
                       device=dev)
    last.scatter_reduce_(0, row_group[:, None].expand_as(ends), ends, "amax")
    starts = group_step_ptr[:-1].long() * rows_per_step
    return (last - starts[:, None]).clamp_min_(0).int()


@dataclasses.dataclass(frozen=True)
class WorkList:
    """The work of K1 or K2 on one plan, cut into pieces of at
    most ``piece_rows`` slot rows of one group (``piece_rows`` is a multiple
    of the plan's step, so a piece is whole steps).  A group of one piece
    writes its output directly; each piece of a longer group writes an fp32
    partial row (``n_parts`` of them).

    ``items``, on the plan's device, is what the kernel reads:

    - K1 (``"rgcsr_spmv"``): ``(n_units, 4)`` int32, one record per warp, in
      group order: the (piece, 32-lane segment) pairs K1 runs — every
      segment of a one-piece group (its dead segments write zeros) and, of a
      split group's pieces, only the segments with slot rows in the piece —
      each as ``(first slot row of the plan, live slot rows, first lane,
      destination)``.  The live rows stop at the segment's ``seg_slots``
      count; the destination is the first output row ``g·G + lane`` of the
      segment, or ``~(part·G + lane)`` (negative) for a partial row.  One
      16-byte record, so a warp starts its loads after one dependent load.
    - K2 (``"rgcsr_spmm"``): ``(n_pieces, 2 + G/32)`` int32, one per CTA:
      each piece's first slot row of the plan, its destination (``g·G`` or
      ``~(part·G)``) and the live slot rows of each segment in the piece (0
      where the segment has none).  The ``n_direct`` pieces of one-piece
      groups come first, then the pieces of split groups, each in group
      order: K2 runs the two with different loops.

    ``combine`` ``(n_split, 2)`` int32: each group of several pieces and
    its first partial row; the combine sums the group's partials in a fixed
    order and rounds once.
    """

    piece_rows: int
    items: Any
    n_direct: int
    combine: Any
    n_parts: int


_WORK_KERNELS = ("rgcsr_spmv", "rgcsr_spmm")


def _pieces(group_rows: np.ndarray, piece_rows: int) -> np.ndarray:
    """Pieces per group; a group with no rows is still one piece, whose
    CTA writes the group's zero rows."""
    return np.maximum(1, -(-group_rows // piece_rows))


def _n_parts(group_rows: np.ndarray, piece_rows: int) -> int:
    n = _pieces(group_rows, piece_rows)
    return int(n[n > 1].sum())


def _piece_rows(group_rows: np.ndarray, rows_per_step: int, n_sm: int,
                part_bytes: int) -> int:
    """The piece-size rule: the plan's total slot rows over
    ``CTAS_PER_SM · n_sm``, rounded up to a whole step and to at least
    ``MIN_PIECE_ROWS``, then doubled while the partial workspace
    (``part_bytes`` per piece of a split group) would pass
    ``WORKSPACE_BYTES``."""
    target = CTAS_PER_SM * max(n_sm, 1) * rows_per_step
    p = max(1, -(-int(group_rows.sum()) // target)) * rows_per_step
    p = max(p, MIN_PIECE_ROWS)
    while _n_parts(group_rows, p) * part_bytes > WORKSPACE_BYTES:
        p *= 2
    return p


def _work_list(kernel: str, group_rows: np.ndarray, seg_slots: np.ndarray,
               piece_rows: int, device) -> WorkList:
    n = _pieces(group_rows, piece_rows)
    group = np.repeat(np.arange(len(n), dtype=np.int64), n)
    piece = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    split = n > 1
    parts = np.where(split, n, 0)
    first_part = np.cumsum(parts) - parts
    part = np.where(split[group], first_part[group] + piece, -1)
    first_row = piece * piece_rows
    # live slot rows of each segment in each piece
    g_size = seg_slots.shape[1] * SEGMENT
    piece_end = np.minimum(first_row + piece_rows, group_rows[group])
    rows = np.clip(np.minimum(seg_slots[group], piece_end[:, None])
                   - first_row[:, None], 0, None)
    row0 = np.concatenate([[0], np.cumsum(group_rows)])[group] + first_row
    dst = np.where(part < 0, group * g_size, ~(part * g_size))
    if kernel == "rgcsr_spmv":
        # the (piece, segment) pairs with rows, or of a one-piece group
        p, seg = np.nonzero((part[:, None] < 0) | (rows > 0))
        lane0 = seg * SEGMENT
        items = np.stack([row0[p], rows[p, seg], lane0,
                          np.where(dst[p] < 0, dst[p] - lane0,
                                   dst[p] + lane0)], 1)
    else:
        order = np.argsort(part >= 0, kind="stable")   # one-piece groups first
        items = np.concatenate([row0[:, None], dst[:, None], rows], 1)[order]
    combine = np.stack([np.flatnonzero(split), first_part[split]], 1)
    return WorkList(piece_rows=piece_rows,
                    items=_tensor(items.astype(np.int32), device),
                    n_direct=int((part < 0).sum()),
                    combine=_tensor(combine.astype(np.int32), device),
                    n_parts=int(parts.sum()))


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
    ``group_step_ptr`` is the same table as one step range per group, and
    ``seg_slots[g, j]`` counts the leading slot rows of group ``g`` in which
    lanes ``[32j, 32j+32)`` hold anything but padding; both are derived on
    the plan's device when not given.

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
    # --- the port's own, derived when not given ---
    group_step_ptr: Any = None     # (n_groups + 1,) int32 step range
    seg_slots: Any = None          # (n_groups, G/32) int32 live slot rows

    def __post_init__(self):
        if self.group_step_ptr is None:
            ptr = _group_step_ptr(_host(self.step_group),
                                  _host(self.step_first), self.n_groups)
            object.__setattr__(self, "group_step_ptr",
                               _tensor(ptr, self.values2d.device))
        if self.seg_slots is None:
            object.__setattr__(self, "seg_slots", _seg_slots(
                self.values2d, self.columns2d, self.step_group,
                self.group_step_ptr, self.rows_per_step, self.n_groups))
        object.__setattr__(self, "_work", {})

    @property
    def rows_per_step(self) -> int:
        return self.chunks_per_step * SUBLANES

    def work_list(self, kernel: str, *, n_sm: int, part_bytes: int,
                  piece_rows: int | None = None) -> WorkList:
        """``kernel``'s work list (``"rgcsr_spmv"`` or ``"rgcsr_spmm"``) on
        a card of ``n_sm`` SMs, whose partial rows take ``part_bytes`` each:
        built on the host at the first call, after a check that the plan's
        arrays are what the kernels take, and kept with the plan.
        ``piece_rows`` (a multiple of ``rows_per_step``) forces the piece
        size instead of the rule of :func:`_piece_rows`."""
        cache = self._work
        key = (kernel, n_sm, part_bytes, piece_rows)
        work = cache.get(key)
        if work is not None:
            return work
        r = self.rows_per_step
        if kernel not in _WORK_KERNELS:
            raise ValueError(f"no work list for kernel {kernel!r}")
        if piece_rows is not None and (piece_rows < r or piece_rows % r):
            raise ValueError(f"piece_rows must be a positive multiple of "
                             f"{r} (8·chunks_per_step), got {piece_rows}")
        if "rows" not in cache:
            self._check_kernel_arrays()
            cache["rows"] = np.diff(_host(self.group_step_ptr).astype(
                np.int64)) * r
            cache["seg_slots"] = _host(self.seg_slots)
        p = piece_rows or _piece_rows(cache["rows"], r, n_sm, part_bytes)
        work = cache[key] = _work_list(kernel, cache["rows"],
                                       cache["seg_slots"], p,
                                       self.values2d.device)
        return work

    def _check_kernel_arrays(self) -> None:
        s, g = self.values2d.shape
        if (tuple(self.columns2d.shape) != (s, g)
                or self.columns2d.dtype != torch.int32
                or self.group_step_ptr.dtype != torch.int32
                or tuple(self.seg_slots.shape) != (self.n_groups, g // SEGMENT)
                or self.seg_slots.dtype != torch.int32 or g % LANES
                or s != self.num_steps * self.rows_per_step):
            raise ValueError(
                f"plan arrays do not match the kernels (values2d "
                f"{tuple(self.values2d.shape)}, columns2d "
                f"{tuple(self.columns2d.shape)} {self.columns2d.dtype}, "
                f"seg_slots {tuple(self.seg_slots.shape)}, {self.num_steps} "
                f"steps of {self.rows_per_step})")

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
    none); the port's own ``group_step_ptr`` and ``seg_slots`` are derived
    from the step table and the slots, never taken from ``fields``."""
    dev = resolve_device(device)
    kwargs = {}
    for f in dataclasses.fields(RgCSRPlan):
        if f.name in ("group_step_ptr", "seg_slots") or f.name not in fields:
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
    y_flat = rgcsr_spmv_launch(plan, _gatherable(x)).reshape(-1)
    if plan.ordering != "adaptive":
        return y_flat[: plan.n_rows]
    return _adaptive_finish_spmv(y_flat, x, plan)


def rgcsr_spmm(plan: RgCSRPlan, x, *, d_tile: int = LANES):
    """Y = A @ X via K2. X: (n_cols, d) -> Y: (n_rows, d).

    ``d_tile`` is the kernel's d-chunk per CTA (capped at 128 columns); the
    kernel masks the d edge, so X is not padded.
    """
    _check_operand(plan, x, 2, "rgcsr_spmm")
    y = rgcsr_spmm_launch(plan, _gatherable(x), d_tile=d_tile)
    if plan.ordering != "adaptive":
        return y[: plan.n_rows]
    return _adaptive_finish_spmm(y, x, plan)


# ---------------------------------------------------------------------------
# Plans over SparseLinear parameters (serving path)
# ---------------------------------------------------------------------------


def plan_from_params(params, dtype, *, d_out: int, d_in: int,
                     group_size: int) -> RgCSRPlan:
    """RgCSRPlan over SparseLinear arrays — no repack: the parameters
    already hold the kernels' slot-major layout at ``chunks_per_step=1``
    (``chunk_group`` is the step table's ``step_group``, ``chunk_first``
    its ``step_first``), with ``values2d`` in ``dtype``.

    Built anew at every call, ``group_step_ptr`` (a host round trip) and
    ``seg_slots`` included: the caller keeps the plan —
    ``models.ffn.SparseLinear`` builds one per layer and compute dtype.
    The reference memoizes on the columns array's ``id``, which a fresh
    tensor view per call would never hit.
    """
    values = params["values2d"]
    if values.dtype != dtype:               # no copy at the same dtype
        values = values.to(dtype)
    return RgCSRPlan(
        values2d=values,
        columns2d=params["columns2d"],
        step_group=params["chunk_group"],
        step_first=params["chunk_first"],
        n_rows=d_out, n_cols=d_in, n_groups=-(-d_out // group_size),
        group_size=group_size, chunks_per_step=1)


def warm_plans_from_params(module, dtype=torch.float32) -> int:
    """Build the kept K2 plan, at ``dtype``, of every SparseLinear layer in
    ``module`` (a ``torch.nn.Module``: every submodule with a ``plan_for``
    method), so that the first call of each layer builds nothing.  Returns
    the number of plans warmed — one per layer, since the port holds one
    module per layer where the reference stacks layers (and warms none)."""
    warmed = 0
    for m in module.modules():
        plan_for = getattr(m, "plan_for", None)
        if plan_for is not None:
            plan_for(dtype)
            warmed += 1
    return warmed


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
