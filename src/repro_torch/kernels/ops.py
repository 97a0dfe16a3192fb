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
import hashlib
import threading
import weakref
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.formats import (ELLPACK, RgCSR, ShardedRgCSR, _host,
                                      _tensor, resolve_device, split_columns)
from repro_torch.core.ordering import descending_from_lengths, split_spill_rows
from repro_torch.kernels.ell_spmv import ell_spmv_launch
from repro_torch.kernels.rgcsr_spmm import rgcsr_spmm_launch
from repro_torch.kernels.rgcsr_spmv import (CHUNKS_PER_STEP_CHOICES, LANES,
                                            SUBLANES, rgcsr_spmv_launch)

__all__ = ["RgCSRPlan", "make_plan", "rgcsr_spmv", "rgcsr_spmm",
           "EllPlan", "make_ell_plan", "ell_spmv", "plan_from_numpy",
           "PlanCache", "PLAN_CACHE", "get_plan", "WorkList", "SEGMENT",
           "ShardedRgCSRPlan", "ShardView", "make_sharded_plan",
           "get_sharded_plan", "sharded_plan_cache_stats",
           "SHARDED_PLAN_CACHE", "sharded_rgcsr_spmv", "sharded_rgcsr_spmm",
           "gather_sharded_rows", "split_x", "mesh_shard",
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
        # K2 takes a group of whole 32-lane segments (a rank's lane slice,
        # models.ffn.SparseLinear.lane_plan); K1 whole 128-lane blocks
        unit = LANES if kernel == "rgcsr_spmv" else SEGMENT
        if self.values2d.shape[1] % unit:
            raise ValueError(f"{kernel}: group_size "
                             f"{self.values2d.shape[1]} is not a multiple "
                             f"of {unit}")
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
                or self.seg_slots.dtype != torch.int32 or g % SEGMENT
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
        return self.fetch(m, key, lambda: make_plan(
            m, chunks_per_step=chunks_per_step, ordering=ordering,
            spill_threshold=spill_threshold))

    def fetch(self, m, key: tuple, build):
        """The plan under ``key`` (whose first item is ``id(m)``), built by
        ``build()`` on a miss and evicted when ``m`` is collected."""
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self.hits += 1
                self._plans.move_to_end(key)
                return plan
        plan = build()
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
# Row-sharded SpMV/SpMM over torch.distributed (DESIGN.md §11–§12)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ShardView:
    """One shard's part of a :class:`ShardedRgCSRPlan`, on one device.

    ``plan`` is K1/K2's plan over the shard's slice of the stacked arrays
    (padding steps and padding slot rows included; its ``group_step_ptr``
    and ``seg_slots`` are derived on the device, so padding rows count as
    dead), in the shard's own ordering.  ``send_idx`` ``(D, e_max)`` holds
    the rows of this shard's x slice that it sends to each shard; the
    remote tail (``rem_*``, the shard's real entries only) adds
    ``rem_values · recv[rem_xidx]`` into rows ``rem_rows``.  ``recv_cols``
    is the count of real x entries the shard receives (the plan's
    ``edge_counts[:, shard].sum()``).
    """

    shard: int
    plan: RgCSRPlan
    n_rows: int                    # rows the shard truly owns (unpadded)
    send_idx: Any = None           # (D, e_max) int64
    rem_values: Any = None         # (E_d,)
    rem_rows: Any = None           # (E_d,) int64 local row ids
    rem_xidx: Any = None           # (E_d,) int64 receive-buffer slots
    recv_cols: int = 0

    @property
    def nbytes(self) -> int:
        """Bytes of the tensors the view holds on its device."""
        return _tensor_bytes(self.plan) + _tensor_bytes(self)


def _tensor_bytes(obj) -> int:
    """Bytes of the tensor fields of dataclass ``obj``."""
    return sum(v.nbytes for f in dataclasses.fields(obj)
               if isinstance(v := getattr(obj, f.name), torch.Tensor))


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedRgCSRPlan:
    """Stacked, shard-major execution plan for a :class:`ShardedRgCSR`.

    Each shard's :class:`RgCSRPlan` (built by ``make_plan`` at the shard's
    own ``(chunks_per_step, ordering, spill_threshold)`` from
    ``shard_configs``) is padded to the across-shard maxima and stacked on
    a leading shard axis, array for array the reference's layout.  Padding
    slot rows are exact zeros; padding *steps* repeat the shard's own last
    real group with ``step_first = 0``.  The kernel ``chunks_per_step`` is
    the gcd of the shard winners (powers of two, so their minimum): each
    shard's layout stays padded at its own granularity and its step table
    is expanded to the common one (DESIGN.md §12).

    ``x_mode`` fixes how the dense vector is reconciled:

    * ``'replicated'`` — every rank holds the whole x; columns keep global
      indices; no exchange.
    * ``'split'`` — each rank holds its own slice of ``cols_per_shard``
      entries.  Grouped storage keeps only each shard's *local*-column
      entries (columns remapped into ``[0, cols_per_shard)``), each
      shard's *remote* entries live in a COO remote tail (``rem_*``)
      indexed into the receive buffer of one ``all_to_all_single``, whose
      per-(src, dst) schedule is ``send_idx`` / ``edge_counts``, padded to
      the per-edge maximum ``e_max``.

    The stacked arrays are CPU tensors, whatever the matrix's device;
    ``remote_cols`` and ``edge_counts`` are host numpy, as in the
    reference.  A rank runs its shard through :meth:`local`, which moves
    only that shard's slice to its card, so each card holds its own rows'
    share of the matrix and no more.
    """

    values3d: Any        # (D, S_pad, G)
    columns3d: Any       # (D, S_pad, G) int32 (global; local-only in split)
    step_group2d: Any    # (D, T_max) int32
    step_first2d: Any    # (D, T_max) int32
    n_rows: int
    n_cols: int
    n_shards: int
    rows_per_shard: int
    cols_per_shard: int          # x entries owned per shard (split mode)
    n_groups: int                # max over shards
    group_size: int
    chunks_per_step: int = 1     # kernel cps (gcd of per-shard winners)
    ordering: str = "block"      # 'adaptive' when ANY shard is adaptive
    spill_threshold: int = 0     # the broadcast argument; per-shard truth
    #                              is shard_configs
    x_mode: str = "replicated"
    nnz: int = -1
    # per-shard (chunks_per_step, ordering, spill_threshold) actually built
    shard_configs: Tuple[Tuple[int, str, int], ...] = ()
    remote_cols: Any = None      # (D, R_max) int32, host (split)
    # --- sparse-exchange schedule (split mode with a non-empty exchange) ---
    send_idx: Any = None         # (D_src, D_dst, e_max) int32 local col idx
    edge_counts: Any = None      # (D_src, D_dst) int64, host
    e_max: int = 0               # per-edge pad (0 = no exchange)
    rem_values: Any = None       # (D, E_t) remote-entry COO tail values
    rem_rows: Any = None         # (D, E_t) int32 local row ids
    rem_xidx: Any = None         # (D, E_t) int32 index into recv buffer
    gather_idx: Any = None       # (D, rows_per_shard) int32 (adaptive)
    grouped_mask: Any = None     # (D, rows_per_shard) bool (adaptive)
    spill_values: Any = None     # (D, E_max) (adaptive + spill)
    spill_rows: Any = None       # (D, E_max) int32 local row ids
    spill_columns: Any = None    # (D, E_max) int32 (local in split mode)
    # true per-shard figures, before stacking
    shard_stored_slots: Tuple[int, ...] = ()
    shard_num_steps: Tuple[int, ...] = ()
    shard_remote_cols: Tuple[int, ...] = ()
    shard_remote_entries: Tuple[int, ...] = ()   # rem-tail nnz per shard
    shard_spill_counts: Tuple[int, ...] = ()     # spill-tail nnz per shard

    def __post_init__(self):
        object.__setattr__(self, "_views", {})

    @property
    def num_steps_max(self) -> int:
        return int(self.step_group2d.shape[1])

    @property
    def stored_slots_max(self) -> int:
        """Per-shard stored slot rows after stacking (= max over shards)."""
        return int(self.values3d.shape[1])

    @property
    def n_spilled_max(self) -> int:
        return 0 if self.spill_values is None else int(
            self.spill_values.shape[1])

    @property
    def stored_elements(self) -> int:
        """True (unstacked) grouped slots × lanes + COO tails of all shards,
        split mode's remote tails included (one entry per remote nonzero)."""
        return (sum(self.shard_stored_slots) * self.group_size
                + sum(self.shard_spilled_elements)
                + sum(self.shard_remote_entries))

    @property
    def shard_spilled_elements(self) -> Tuple[int, ...]:
        """True spill-tail entries per shard, as recorded at build."""
        if self.spill_values is None:
            return (0,) * self.n_shards
        return self.shard_spill_counts or (0,) * self.n_shards

    @property
    def padded_slot_fraction(self) -> float:
        if self.nnz < 0 or self.stored_elements == 0:
            return 0.0
        return (self.stored_elements - self.nnz) / self.stored_elements

    # ------------------------------------------------- exchange accounting
    @property
    def has_exchange(self) -> bool:
        """Whether the run path issues the exchange at all."""
        return self.x_mode == "split" and self.e_max > 0

    @property
    def shard_exchange_recv_cols(self) -> Tuple[int, ...]:
        """x entries shard d receives per the schedule — equal to
        ``shard_remote_cols[d]`` by construction."""
        if self.edge_counts is None:
            return (0,) * self.n_shards
        ec = np.asarray(self.edge_counts)
        return tuple(int(ec[:, d].sum()) for d in range(self.n_shards))

    @property
    def shard_exchange_send_cols(self) -> Tuple[int, ...]:
        """x entries shard d sends per the schedule."""
        if self.edge_counts is None:
            return (0,) * self.n_shards
        ec = np.asarray(self.edge_counts)
        return tuple(int(ec[d, :].sum()) for d in range(self.n_shards))

    @property
    def shard_exchange_bytes(self) -> Tuple[int, ...]:
        """Received x entries × the stored values' itemsize, per shard."""
        itemsize = self.values3d.element_size()
        return tuple(c * itemsize for c in self.shard_exchange_recv_cols)

    @property
    def exchange_padded_recv_cols(self) -> int:
        """Receive-buffer width ``D·e_max``: the exchange moves this many
        slots, of which ``shard_exchange_recv_cols`` are real."""
        return self.n_shards * self.e_max

    @property
    def nbytes(self) -> int:
        """Bytes of the stacked (host) tensors."""
        return _tensor_bytes(self)

    def fingerprint(self) -> str:
        """A digest of every field, arrays by their bytes: equal on two
        ranks exactly when they built the same plan."""
        h = hashlib.blake2b(digest_size=16)
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                v = _host(v)
            if isinstance(v, np.ndarray):
                h.update(f"{f.name}{v.dtype}{v.shape}".encode())
                h.update(np.ascontiguousarray(v).tobytes())
            else:
                h.update(f"{f.name}={v!r};".encode())
        return h.hexdigest()

    # ------------------------------------------------------ one shard
    def local(self, shard: int, device=None) -> ShardView:
        """Shard ``shard``'s view on ``device`` (default: the host, where
        the stacked arrays are), built from that shard's slices alone at
        the first call and kept with the plan."""
        dev = (self.values3d.device if device is None
               else resolve_device(device))
        key = (int(shard), str(dev))
        view = self._views.get(key)
        if view is not None:
            return view
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} of a {self.n_shards}-shard plan")
        cps, ordering, spill = self.shard_configs[shard]
        adaptive = ordering == "adaptive"
        n_sp = self.shard_spilled_elements[shard]

        def take(t, n=None):
            return None if t is None else t[shard, :n].to(dev)

        plan = RgCSRPlan(
            values2d=take(self.values3d), columns2d=take(self.columns3d),
            step_group=take(self.step_group2d),
            step_first=take(self.step_first2d),
            n_rows=self.rows_per_shard,
            n_cols=(self.cols_per_shard if self.x_mode == "split"
                    else self.n_cols),
            n_groups=self.n_groups, group_size=self.group_size,
            chunks_per_step=self.chunks_per_step, ordering=ordering,
            spill_threshold=spill,
            gather_idx=take(self.gather_idx) if adaptive else None,
            grouped_mask=take(self.grouped_mask) if adaptive else None,
            spill_values=take(self.spill_values, n_sp) if adaptive else None,
            spill_rows=take(self.spill_rows, n_sp) if adaptive else None,
            spill_columns=(take(self.spill_columns, n_sp) if adaptive
                           else None))
        lo = shard * self.rows_per_shard
        n_rows = max(0, min(lo + self.rows_per_shard, self.n_rows) - lo)
        kw = {}
        if self.has_exchange:
            n_e = self.shard_remote_entries[shard]
            kw = dict(send_idx=take(self.send_idx).long(),
                      rem_values=take(self.rem_values, n_e),
                      rem_rows=take(self.rem_rows, n_e).long(),
                      rem_xidx=take(self.rem_xidx, n_e).long(),
                      recv_cols=self.shard_exchange_recv_cols[shard])
        view = self._views[key] = ShardView(shard=int(shard), plan=plan,
                                            n_rows=n_rows, **kw)
        return view


def _normalize_shard_configs(shard_configs, n_shards: int,
                             chunks_per_step: int, ordering: str,
                             spill_threshold: int,
                             group_size: Optional[int] = None
                             ) -> Tuple[Tuple[int, str, int], ...]:
    """Per-shard (cps, ordering, spill) tuples; the global arguments
    broadcast when ``shard_configs`` is None.  Accepts TuneConfig-likes,
    dicts, or bare 3-tuples.  A config that carries a group size
    (TuneConfig/dict) must match the matrix's."""
    if shard_configs is None:
        return ((int(chunks_per_step), str(ordering),
                 int(spill_threshold)),) * n_shards
    norm = []
    for c in shard_configs:
        cfg_g = None
        if hasattr(c, "chunks_per_step"):          # autotune.TuneConfig
            cps, o, t = c.chunks_per_step, c.ordering, c.spill_threshold
            cfg_g = getattr(c, "group_size", None)
        elif isinstance(c, dict):
            # missing keys inherit the caller's broadcast arguments
            cps = c.get("chunks_per_step", chunks_per_step)
            o = c.get("ordering", ordering)
            t = c.get("spill_threshold", spill_threshold)
            cfg_g = c.get("group_size")
        else:
            cps, o, t = c
        if group_size is not None and cfg_g is not None \
                and int(cfg_g) != int(group_size):
            raise ValueError(
                f"shard config tuned at group_size={cfg_g} cannot build a "
                f"plan for a group_size={group_size} matrix — re-tune at "
                f"the matrix's group size")
        norm.append((int(cps), str(o), int(t)))
    if len(norm) != n_shards:
        raise ValueError(f"shard_configs has {len(norm)} entries for "
                         f"{n_shards} shards")
    return tuple(norm)


def _exchange_schedule(remotes, cstride: int, d_sh: int):
    """Per-(src, dst) send schedule from the per-dst remote column sets
    (each sorted and unique).

    Edge (s → d) holds dst d's remote columns owned by src s, in sorted
    order; every edge is padded to the across-edge maximum ``e_max``.
    Returns ``(send_idx (D, D, e_max) local column offsets at the src,
    edge_counts (D, D) true sizes, e_max, slot_of)``, where
    ``slot_of(d, cols)`` maps dst d's remote columns to their slots
    ``src·e_max + pos`` in its flattened receive buffer.
    """
    counts = np.zeros((d_sh, d_sh), np.int64)
    owners, starts = [], []
    for dst, remote in enumerate(remotes):
        owner = remote // cstride
        counts[:, dst] = np.bincount(owner, minlength=d_sh)
        owners.append(owner)
        starts.append(np.concatenate([[0], np.cumsum(counts[:, dst])]))
    e_max = int(counts.max()) if counts.size else 0
    send_idx = np.zeros((d_sh, d_sh, e_max), np.int32)
    pos = []
    for dst, (remote, owner) in enumerate(zip(remotes, owners)):
        p = np.arange(len(remote)) - starts[dst][owner]
        send_idx[owner, dst, p] = remote - owner * cstride
        pos.append(p)

    def slot_of(dst: int, cols: np.ndarray) -> np.ndarray:
        i = np.searchsorted(remotes[dst], cols)
        return (owners[dst][i] * e_max + pos[dst][i]).astype(np.int32)

    return send_idx, counts, e_max, slot_of


def make_sharded_plan(sm: ShardedRgCSR, *, chunks_per_step: int = 1,
                      ordering: str = "block", spill_threshold: int = 0,
                      x_mode: str = "replicated",
                      shard_configs=None) -> ShardedRgCSRPlan:
    """Build per-shard plans with :func:`make_plan`, then pad and stack
    them on the host, array for array the reference's
    ``make_sharded_plan``.

    ``shard_configs`` (one ``(chunks_per_step, ordering, spill_threshold)``
    per shard, e.g. the per-shard autotune winners) lets each shard keep
    its own schedule; step tables expand to the gcd kernel
    ``chunks_per_step``.  In ``x_mode='split'`` the grouped storage keeps
    only each shard's local-column entries, split from the shard's CSR
    (never densified); remote entries go to the ``rem_*`` tail indexed
    into the receive buffer of the ``send_idx`` schedule.
    """
    if x_mode not in ("replicated", "split"):
        raise ValueError(
            f"x_mode must be 'replicated' or 'split', got {x_mode!r}")
    d_sh = sm.n_shards
    n_rows, n_cols = sm.shape
    g = sm.group_size
    rps = sm.rows_per_shard
    cfgs = _normalize_shard_configs(shard_configs, d_sh, chunks_per_step,
                                    ordering, spill_threshold,
                                    group_size=g)
    for cps_d, o_d, _ in cfgs:
        if cps_d not in CHUNKS_PER_STEP_CHOICES:
            raise ValueError(
                f"chunks_per_step must be one of {CHUNKS_PER_STEP_CHOICES}, "
                f"got {cps_d}")
        if o_d not in ("block", "adaptive"):
            raise ValueError(f"ordering must be 'block' or 'adaptive', "
                             f"got {o_d!r}")
    # one kernel cps; per-shard winners keep their own padding granularity
    # and expand their step tables down to the gcd (powers of two: the min)
    kernel_cps = min(c[0] for c in cfgs)
    rows_per_step = kernel_cps * SUBLANES
    any_adaptive = any(c[1] == "adaptive" for c in cfgs)
    split = x_mode == "split"
    _, cstride = ShardedRgCSR.shard_layout(n_rows, n_cols, d_sh)

    remotes, rem_tails = [], []
    if split:
        sources = []
        for d, shard in enumerate(sm.shards):
            lo = d * cstride
            (v, c, ptr), tail = split_columns(*shard.to_csr_arrays(), lo,
                                              min(lo + cstride, n_cols))
            local = RgCSR.from_csr(v, c, ptr, (rps, cstride), group_size=g,
                                   slot_pad=sm.slot_pad,
                                   device=shard.values.device)
            # the host CSR holds bf16 values as float32: exact both ways
            sources.append(dataclasses.replace(
                local, values=local.values.to(shard.values.dtype)))
            remotes.append(np.unique(tail[2]))
            rem_tails.append(tail)
        send_idx, edge_counts, e_max, slot_of = _exchange_schedule(
            remotes, cstride, d_sh)
        e_tail = max(len(v) for v, _, _ in rem_tails)
        r_max = max(len(r) for r in remotes)
    else:
        sources = list(sm.shards)
        send_idx = edge_counts = None
        e_max = e_tail = r_max = 0

    plans = [make_plan(src, chunks_per_step=c[0], ordering=c[1],
                       spill_threshold=c[2])
             for src, c in zip(sources, cfgs)]
    # expand each shard's step table to the kernel cps: one coarse step of
    # cps_d chunks becomes cps_d/kernel_cps consecutive fine steps of the
    # same group, step_first only on the first
    tables = []
    for p, (cps_d, _, _) in zip(plans, cfgs):
        f = cps_d // kernel_cps
        sg = np.repeat(_host(p.step_group), f)
        sf = np.zeros(len(sg), np.int32)
        if len(sg):
            sf[::f] = _host(p.step_first)
        tables.append((sg, sf))
    n_groups = max(p.n_groups for p in plans)
    t_max = max(len(sg) for sg, _ in tables)
    s_pad = t_max * rows_per_step

    vals = torch.zeros((d_sh, s_pad, g), dtype=plans[0].values2d.dtype)
    cols = torch.zeros((d_sh, s_pad, g), dtype=plans[0].columns2d.dtype)
    sg2 = np.zeros((d_sh, t_max), np.int32)
    sf2 = np.zeros((d_sh, t_max), np.int32)
    remote_cols = np.zeros((d_sh, r_max), np.int32)
    v_dtype = _host(plans[0].values2d[:0]).dtype
    rm_v = np.zeros((d_sh, e_tail), v_dtype)
    rm_r = np.zeros((d_sh, e_tail), np.int32)
    rm_x = np.zeros((d_sh, e_tail), np.int32)
    sp_max = max(p.n_spilled_elements for p in plans) if any_adaptive else 0
    gidx = np.zeros((d_sh, rps), np.int32)
    gmask = np.zeros((d_sh, rps), bool)
    sp_v = np.zeros((d_sh, sp_max), v_dtype)
    sp_r = np.zeros((d_sh, sp_max), np.int32)
    sp_c = np.zeros((d_sh, sp_max), np.int32)

    for d, p in enumerate(plans):
        s_d = p.stored_slots
        sg, sf = tables[d]
        t_d = len(sg)
        vals[d, :s_d] = p.values2d.cpu()
        cols[d, :s_d] = p.columns2d.cpu()
        sg2[d, :t_d] = sg
        # padding steps extend the shard's own last group (step_first = 0,
        # zero values)
        sg2[d, t_d:] = int(sg[-1]) if t_d else 0
        sf2[d, :t_d] = sf
        if split:
            remote_cols[d, : len(remotes[d])] = remotes[d]
            rv, rr, rc = rem_tails[d]
            if len(rv):
                rm_v[d, : len(rv)] = rv
                rm_r[d, : len(rv)] = rr
                rm_x[d, : len(rv)] = slot_of(d, rc)
        if any_adaptive:
            if p.ordering == "adaptive":
                gidx[d] = _host(p.gather_idx)
                gmask[d] = _host(p.grouped_mask)
                e_d = p.n_spilled_elements
                if e_d:
                    sp_v[d, :e_d] = _host(p.spill_values)
                    sp_r[d, :e_d] = _host(p.spill_rows)
                    sp_c[d, :e_d] = _host(p.spill_columns)
            else:
                # a block shard in a mixed stack: identity gather
                gidx[d] = np.arange(rps, dtype=np.int32)
                gmask[d] = True

    def host_t(a, dtype=None):
        t = _tensor(a, torch.device("cpu"))
        return t if dtype is None else t.to(dtype)

    exchange = split and e_max > 0
    return ShardedRgCSRPlan(
        values3d=vals, columns3d=cols,
        step_group2d=host_t(sg2), step_first2d=host_t(sf2),
        n_rows=n_rows, n_cols=n_cols, n_shards=d_sh,
        rows_per_shard=rps, cols_per_shard=cstride,
        n_groups=n_groups, group_size=g, chunks_per_step=kernel_cps,
        ordering="adaptive" if any_adaptive else "block",
        spill_threshold=int(spill_threshold),
        x_mode=x_mode, nnz=sm.nnz, shard_configs=cfgs,
        remote_cols=remote_cols if split else None,
        send_idx=host_t(send_idx) if exchange else None,
        edge_counts=edge_counts,
        e_max=e_max,
        rem_values=host_t(rm_v, vals.dtype) if exchange else None,
        rem_rows=host_t(rm_r) if exchange else None,
        rem_xidx=host_t(rm_x) if exchange else None,
        gather_idx=host_t(gidx) if any_adaptive else None,
        grouped_mask=host_t(gmask) if any_adaptive else None,
        spill_values=host_t(sp_v, vals.dtype) if any_adaptive else None,
        spill_rows=host_t(sp_r) if any_adaptive else None,
        spill_columns=host_t(sp_c) if any_adaptive else None,
        shard_stored_slots=tuple(p.stored_slots for p in plans),
        shard_num_steps=tuple(len(sg) for sg, _ in tables),
        shard_remote_cols=(tuple(len(r) for r in remotes) if remotes
                           else (0,) * d_sh),
        shard_remote_entries=(tuple(len(v) for v, _, _ in rem_tails)
                              if rem_tails else (0,) * d_sh),
        shard_spill_counts=tuple(p.n_spilled_elements for p in plans),
    )


# The sharded plan memo: keys (id(matrix), shard count, x_mode, per-shard
# configs), GC-evicted like PLAN_CACHE.  The shard count is keyed so that a
# re-warm on a resized mesh never reuses a stale stacked plan; x_mode,
# because split mode stores local-only columns and the exchange schedule.
SHARDED_PLAN_CACHE = PlanCache(maxsize=64)


def get_sharded_plan(sm: ShardedRgCSR, *, chunks_per_step: int = 1,
                     ordering: str = "block", spill_threshold: int = 0,
                     x_mode: str = "replicated",
                     shard_configs=None) -> ShardedRgCSRPlan:
    """Fetch (or build and memoize) the stacked sharded plan for ``sm``."""
    cfgs = _normalize_shard_configs(shard_configs, sm.n_shards,
                                    chunks_per_step, ordering,
                                    spill_threshold,
                                    group_size=sm.group_size)
    key = (id(sm), sm.n_shards, x_mode, cfgs)
    return SHARDED_PLAN_CACHE.fetch(sm, key, lambda: make_sharded_plan(
        sm, chunks_per_step=chunks_per_step, ordering=ordering,
        spill_threshold=spill_threshold, x_mode=x_mode, shard_configs=cfgs))


def sharded_plan_cache_stats() -> Dict[str, int]:
    return SHARDED_PLAN_CACHE.stats()


def mesh_shard(mesh, axis: str, n_shards: Optional[int] = None):
    """``(shard, group)``: this rank's coordinate along ``axis`` of the
    ``DeviceMesh`` and the axis's process group.  The all-to-all sends
    block ``i`` to group rank ``i``, so the mesh's ranks must rise along
    the axis (group rank == coordinate)."""
    import torch.distributed as dist
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}: {names}")
    size = int(mesh.size(names.index(axis)))
    if n_shards is not None and size != n_shards:
        raise ValueError(f"plan built for {n_shards} shards but mesh axis "
                         f"{axis!r} has {size} ranks")
    shard = int(mesh.get_local_rank(axis))
    group = mesh.get_group(axis)
    if dist.get_rank(group) != shard:
        raise ValueError(f"rank {dist.get_rank()} is number "
                         f"{dist.get_rank(group)} of the {axis!r} group but "
                         f"at coordinate {shard} of the mesh: the mesh's "
                         f"ranks must rise along {axis!r}")
    return shard, group


def split_x(plan: ShardedRgCSRPlan, x, shard: int):
    """Shard ``shard``'s slice of a full ``x`` (``(n_cols,)`` or
    ``(n_cols, d)``) for split mode: ``cols_per_shard`` rows, zero past
    ``n_cols``, as the reference pads."""
    c = plan.cols_per_shard
    lo, hi = shard * c, min((shard + 1) * c, plan.n_cols)
    out = x.new_zeros((c,) + tuple(x.shape[1:]))
    if hi > lo:
        out[: hi - lo] = x[lo:hi]
    return out


def _exchange(view: ShardView, x, group):
    """Start the sparse exchange of a split-mode shard: one
    ``all_to_all_single`` sends ``x[send_idx[dst]]`` to each shard ``dst``
    and receives, from each shard ``src``, the entries of ``x`` this shard
    reads from it.  Returns ``(work, recv)``; after ``work.wait()``,
    ``recv`` ``(D, e_max[, d])`` holds in row ``src`` its first
    ``edge_counts[src, shard]`` entries for real."""
    import torch.distributed as dist
    send = x[view.send_idx].contiguous()                 # (D, e_max[, d])
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=group, async_op=True)
    return work, recv


def _sharded_run(plan: ShardedRgCSRPlan, x, mesh, axis: str, kind: str,
                 d_tile: int):
    shard, group = mesh_shard(mesh, axis, plan.n_shards)
    view = plan.local(shard, x.device)
    width = view.plan.n_cols
    if x.dim() != (1 if kind == "spmv" else 2) or x.shape[0] != width:
        raise ValueError(
            f"sharded_rgcsr_{kind}: expected x with {width} rows "
            f"({'the shard slice' if plan.x_mode == 'split' else 'all'} of "
            f"x, x_mode={plan.x_mode!r}), got shape {tuple(x.shape)}")
    work = None
    if plan.has_exchange:
        # only the remote x entries move, while K1/K2 read the own slice
        from repro_torch.sharding.layout import record_collective
        work, recv = _exchange(view, x, group)
        record_collective("all-to-all", axis, plan.n_shards,
                          recv.numel() * recv.element_size())
    if kind == "spmv":
        y = rgcsr_spmv(view.plan, x)
    else:
        y = rgcsr_spmm(view.plan, x, d_tile=d_tile)
    if work is not None:
        work.wait()
        recv = recv.reshape((-1,) + tuple(x.shape[1:]))
        rv = view.rem_values
        prods = recv[view.rem_xidx] * (rv if kind == "spmv" else rv[:, None])
        # K1/K2 return the values' dtype, as the reference's kernels do;
        # the tail adds at the promoted dtype, as its ``y + segment_sum``
        dt = torch.promote_types(y.dtype, prods.dtype)
        y = y.to(dt).index_add_(0, view.rem_rows, prods.to(dt))
    return y[: view.n_rows]


def sharded_rgcsr_spmv(plan: ShardedRgCSRPlan, x, *, mesh, axis: str):
    """This rank's rows of ``y = A @ x``: K1 over its shard, plus the
    remote tail over the exchanged x entries in split mode.

    ``mesh`` is the caller's ``DeviceMesh``; the rank's shard is its
    coordinate along ``axis`` and the exchange runs on the axis's process
    group, whatever its backend (NCCL for one rank per card; gloo, which
    stages CUDA tensors through the host, where ranks share a card).
    ``x``: the whole ``(n_cols,)`` vector in replicated mode, the rank's
    ``(cols_per_shard,)`` slice (:func:`split_x`) in split mode.  Returns
    the rows the shard truly owns, ``shard_rows(shard)`` of the matrix;
    :func:`gather_sharded_rows` assembles the full ``(n_rows,)``."""
    return _sharded_run(plan, x, mesh, axis, "spmv", LANES)


def sharded_rgcsr_spmm(plan: ShardedRgCSRPlan, x, *, mesh, axis: str,
                       d_tile: int = LANES):
    """This rank's rows of ``Y = A @ X`` (X dense ``(n_cols, d)``, or the
    rank's ``(cols_per_shard, d)`` slice in split mode) through K2; see
    :func:`sharded_rgcsr_spmv`."""
    return _sharded_run(plan, x, mesh, axis, "spmm", d_tile)


def gather_sharded_rows(plan: ShardedRgCSRPlan, y, *, mesh, axis: str):
    """The full ``(n_rows[, d])`` result on every rank of the axis, from
    each rank's own rows (one ``all_gather`` of blocks padded to
    ``rows_per_shard``) — what the reference's ``y[: n_rows]`` gives."""
    import torch.distributed as dist
    _, group = mesh_shard(mesh, axis, plan.n_shards)
    block = y.new_zeros((plan.rows_per_shard,) + tuple(y.shape[1:]))
    block[: y.shape[0]] = y
    parts = [torch.empty_like(block) for _ in range(plan.n_shards)]
    from repro_torch.sharding.layout import record_collective
    record_collective("all-gather", axis, plan.n_shards,
                      plan.n_shards * block.numel() * block.element_size())
    dist.all_gather(parts, block, group=group)
    return torch.cat(parts)[: plan.n_rows]


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
