"""Per-matrix autotuning of the RgCSR kernel pipeline (DESIGN.md §3.3).

The PyTorch counterpart of the single-device part of
``repro.kernels.autotune``: the same knobs, candidate sets, pruning rules,
winner memo and plan retention, with K1/K2 (the CUDA kernels) timed on the
card.  The knobs:

* ``chunks_per_step`` — the plan's step coarsening: fewer, fatter steps vs
  more padding on short groups;
* ``group_size``      — rows per RgCSR group: fill ratio vs lane use (the
  paper's Table 4 experiment, closed-loop);
* ``d_tile``          — SpMM's d-chunk per CTA.  K2 caps it at 128 columns,
  so the reference's candidates 128 and 256 run one kernel on the card;
  both are kept, so that the candidate sets stay the reference's;
* ``ordering``        — block (consecutive rows) vs adaptive (rows regrouped
  by descending length, DESIGN.md §5);
* ``spill_threshold`` — adaptive only: rows longer than this leave the
  grouped storage for a COO tail (:func:`spill_threshold_candidates`).

A search builds every candidate's plan first, prunes on structure alone
(fill-ratio blow-up past ``storage_cap`` × the baseline's stored elements;
an adaptive plan that moves no fewer bytes and runs no fewer steps than
the block plan of its ``(G, cps)``), then times the survivors: on the card
from one ``torch.profiler`` session (``core.timing.profiled_time_us_group``,
the card's own time of each candidate), else with this module's
:func:`time_us` — CUDA events around one call on the card, the host's clock
on the CPU.  ``TuneResult.timing_source`` records which.  The winner is
memoized per matrix signature and candidate set.

Every entry point takes the matrix as a dense array, a ``scipy.sparse``
matrix or a CSR tuple ``(values, columns, row_ptr, shape)``; stored zeros
are dropped, so all three give the dense path's signature, candidates and
plans.  No dense matrix is formed from sparse input (a 4,194,304-row
``fem2d_2048`` has none).  Matrices and plans live on ``device``.

Row-sharded tuning (DESIGN.md §12.2): :func:`shard_row_blocks` cuts a
matrix into the shards' CSR blocks, :func:`autotune_spmv_per_shard` tunes
each, and :func:`harmonize_shard_winners` picks configs that stack.  Where
the reference tunes every shard in one process, the port can also tune
across ranks (``group=``): the first rank holding each shard searches its
block on its own device, the results are gathered, and every rank
harmonizes the same list.  Ranks that share a card take turns (a barrier
between searches), so their profiled windows never overlap.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import socket
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import timing as _timing
from repro_torch.core.formats import RgCSR, _as_2d, _csr_arrays, \
    resolve_device, shard_csr_blocks
from repro_torch.kernels import ops
from repro_torch.kernels.rgcsr_spmv import (CHUNKS_PER_STEP_CHOICES, LANES,
                                            SUBLANES)

log = logging.getLogger(__name__)

__all__ = ["TuneConfig", "TuneResult", "matrix_signature", "candidate_configs",
           "spill_threshold_candidates", "autotune_spmv", "autotune_spmm",
           "tuned_plan", "clear_memo", "set_timing_source", "timing_source",
           "time_us", "shard_row_blocks", "autotune_spmv_per_shard",
           "harmonize_shard_winners", "take_turns", "DEFAULT_GROUP_SIZES",
           "DEFAULT_D_TILES", "DEFAULT_ORDERINGS"]

DEFAULT_GROUP_SIZES = (128, 256)
DEFAULT_D_TILES = (128, 256)
DEFAULT_ORDERINGS = ("block", "adaptive")


@dataclasses.dataclass(frozen=True, order=True)
class TuneConfig:
    """One point in the kernel schedule space.

    ``ordering``/``spill_threshold`` are the adaptive-grouping axes
    (DESIGN.md §5): ``'adaptive'`` regroups rows by descending length;
    ``spill_threshold > 0`` (adaptive only) additionally routes rows longer
    than the threshold to a COO tail.  ``0`` disables spilling.
    """
    chunks_per_step: int = 1
    group_size: int = 128
    d_tile: int = 128
    ordering: str = "block"
    spill_threshold: int = 0


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Winner of one search, with the full timing table for inspection.

    ``plan_stats`` parallels ``timings``: per measured candidate, the
    plan's ``(stored_slots, stored_elements, n_spilled_elements)``.
    ``timing_source`` names the clock of the timing table: ``"profiler"``
    (the card's time from a ``torch.profiler`` session) or ``"wallclock"``
    (:func:`time_us`).
    """
    config: TuneConfig
    us_per_call: float
    timings: Tuple[Tuple[TuneConfig, float], ...]
    signature: tuple
    from_memo: bool = False
    plan_stats: Tuple[Tuple[int, int, int], ...] = ()
    timing_source: str = "wallclock"

    @property
    def baseline_us(self) -> float:
        """Time of the uncoarsened default config (block, cps=1, g=128) —
        the baseline schedule the speedup is quoted against."""
        for cfg, us in self.timings:
            if (cfg.chunks_per_step == 1 and cfg.group_size == 128
                    and cfg.ordering == "block"):
                return us
        return self.timings[0][1]

    @property
    def speedup(self) -> float:
        return self.baseline_us / max(self.us_per_call, 1e-9)


# winner memo: (kind, signature, candidates, extra, device type) -> result
_MEMO: Dict[tuple, TuneResult] = {}
# the winning (matrix, plan) per (signature, config, matrix content,
# device) — the matrix is retained on purpose: PLAN_CACHE evicts a plan when
# its matrix is garbage-collected.  The reference keys this on (signature,
# config) alone and so hands a second matrix of the same signature bucket
# the first one's plan; the content fingerprint keeps each matrix's own.
_TUNED: Dict[tuple, Tuple[RgCSR, "ops.RgCSRPlan"]] = {}


def clear_memo() -> None:
    _MEMO.clear()
    _TUNED.clear()


# timing-source policy: "auto" prefers the profiler when it works,
# "wallclock" forces time_us, "profiler" insists (still falls back if the
# session records nothing — a search never errors out over provenance).
_TIMING_SOURCE = "auto"


def set_timing_source(mode: str) -> None:
    global _TIMING_SOURCE
    if mode not in ("auto", "wallclock", "profiler"):
        raise ValueError(f"timing source must be auto/wallclock/profiler, "
                         f"got {mode!r}")
    _TIMING_SOURCE = mode


def time_us(run, plan, cfg, *, repeats: int = 3, warmup: int = 1,
            device="cuda") -> float:
    """The fallback clock: the median µs of ``run(plan, cfg)``.  On a card,
    CUDA events around one call (``core.timing.time_us`` with
    ``calls=1``: what a caller waits); on the CPU, the host's clock."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return _timing.time_us(run, plan, cfg, repeats=repeats,
                               warmup=warmup, calls=1, device=dev)
    for _ in range(warmup):
        run(plan, cfg)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run(plan, cfg)
        times.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(times))


_WALLCLOCK = time_us


def timing_source() -> str:
    """The clock the next search on a card will try first.  Resolves to
    ``"wallclock"`` when forced, when no profiler session records CUDA
    kernels (always without a card), or when :func:`time_us` has been
    monkeypatched (deterministic test fixtures replace it with a
    structural cost model — the profiler would bypass the patch)."""
    if _TIMING_SOURCE == "wallclock":
        return "wallclock"
    if time_us is not _WALLCLOCK:
        return "wallclock"
    if not _timing.profiler_available():
        return "wallclock"
    return "profiler"


# ---------------------------------------------------------------------------
# matrices
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Csr:
    """A matrix as host CSR arrays with no stored zeros."""
    values: np.ndarray
    columns: np.ndarray
    row_ptr: np.ndarray
    shape: Tuple[int, int]

    @property
    def row_lens(self) -> np.ndarray:
        return np.diff(self.row_ptr)


def _as_csr(a) -> _Csr:
    """A dense array, a ``scipy.sparse`` matrix or a ``(values, columns,
    row_ptr, shape)`` tuple as host CSR without stored zeros."""
    if isinstance(a, _Csr):
        return a
    if isinstance(a, tuple):
        values, columns, row_ptr, shape = a
    elif hasattr(a, "tocsr"):
        c = a.tocsr()
        values, columns, row_ptr, shape = c.data, c.indices, c.indptr, c.shape
    else:
        dense = _as_2d(a)
        values, columns, _, row_ptr = _csr_arrays(dense)
        shape = dense.shape
    values, columns = np.asarray(values), np.asarray(columns)
    row_ptr = np.asarray(row_ptr).astype(np.int64)
    keep = values != 0
    if not keep.all():
        rows = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))
        row_ptr = np.concatenate([[0], np.cumsum(np.bincount(
            rows[keep], minlength=len(row_ptr) - 1))])
        values, columns = values[keep], columns[keep]
    return _Csr(values, columns, row_ptr, (int(shape[0]), int(shape[1])))


def _fingerprint(m: _Csr) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(m.shape, np.int64).tobytes())
    for arr in (m.row_ptr, m.columns, m.values):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _build(m: _Csr, group_size: int, device) -> RgCSR:
    return RgCSR.from_csr(m.values, m.columns, m.row_ptr, m.shape,
                          group_size=group_size, device=device)


def _log_bucket(v: float) -> int:
    return int(np.ceil(np.log2(v + 1.0)))


def _plan_bytes(plan: "ops.RgCSRPlan") -> int:
    """Bytes one SpMV streams for this plan's matrix storage: grouped slots
    at (itemsize + 4 col) each, COO tail at (itemsize + 8 idx)."""
    itemsize = plan.values2d.element_size()
    return (plan.stored_slots * plan.group_size * (itemsize + 4)
            + plan.n_spilled_elements * (itemsize + 8))


def matrix_signature(a) -> tuple:
    """Structural fingerprint driving winner reuse.

    Log2-bucketed (rows, cols, nnz, row-length max/mean/std) — the row
    statistics of the paper's Table 6, which decide the padding/step trade
    the tuner explores.  Near-identical matrices share a bucket and reuse
    the winner.  ``a``: dense, ``scipy.sparse`` or a CSR tuple.
    """
    m = _as_csr(a)
    row_lens = m.row_lens if m.shape[0] else np.zeros(1)
    return (
        _log_bucket(m.shape[0]),
        _log_bucket(m.shape[1]),
        _log_bucket(float(row_lens.sum())),
        _log_bucket(float(row_lens.max(initial=0))),
        _log_bucket(float(row_lens.mean() if row_lens.size else 0.0)),
        _log_bucket(float(row_lens.std() if row_lens.size else 0.0)),
    )


def spill_threshold_candidates(row_lens: np.ndarray,
                               max_candidates: int = 2) -> Tuple[int, ...]:
    """Matrix-derived spill thresholds worth measuring (plus 0 = no spill):
    powers of two at ~2× and ~8× the mean row length, each emitted only
    when the max row length's log2 bucket lies strictly above it.  The
    buckets are :func:`matrix_signature`'s, so every matrix of one
    signature gets the same candidate set (the set is part of the memo
    key)."""
    row_lens = np.asarray(row_lens)
    if row_lens.size == 0 or row_lens.max(initial=0) == 0:
        return (0,)
    mean_b = _log_bucket(float(row_lens.mean()))
    max_b = _log_bucket(float(row_lens.max()))
    cands = []
    for shift in (0, 2):
        if max_b > mean_b + shift:           # bucket-level "max > threshold"
            cands.append(1 << (mean_b + shift))
    return (0,) + tuple(cands[:max_candidates])


def candidate_configs(
        chunks: Sequence[int] = CHUNKS_PER_STEP_CHOICES,
        group_sizes: Sequence[int] = DEFAULT_GROUP_SIZES,
        d_tiles: Sequence[int] = (LANES,),
        orderings: Sequence[str] = ("block",),
        spill_thresholds: Sequence[int] = (0,)) -> Tuple[TuneConfig, ...]:
    """Cartesian schedule grid.  ``spill_thresholds`` applies to adaptive
    configs only (block grouping cannot spill); 0 = no spill."""
    out = []
    for g in group_sizes:
        for c in chunks:
            for d in d_tiles:
                for o in orderings:
                    for t in (spill_thresholds if o == "adaptive" else (0,)):
                        out.append(TuneConfig(c, g, d, o, t))
    return tuple(out)


def _search(m: _Csr, run, kind: str, *, candidates, repeats: int,
            storage_cap: float, device: torch.device,
            memo_key_extra: tuple = ()) -> TuneResult:
    sig = matrix_signature(m)
    if candidates is None:
        candidates = candidate_configs(
            d_tiles=DEFAULT_D_TILES if kind == "spmm" else (LANES,),
            orderings=DEFAULT_ORDERINGS,
            spill_thresholds=spill_threshold_candidates(m.row_lens))
    # block configs sort (and so are timed) first, so that the pruning
    # baseline and TuneResult.baseline_us are the block schedule
    candidates = sorted(set(candidates),
                        key=lambda c: (c.ordering != "block", c))
    # the candidate set is part of the memo key: a restricted search must
    # never be answered with a winner outside its own candidate set
    memo_key = (kind, sig, tuple(candidates), *memo_key_extra, device.type)
    hit = _MEMO.get(memo_key)
    if hit is not None:
        return dataclasses.replace(hit, from_memo=True)

    # pass 1 — selection: build plans and prune on structure (no timing,
    # so the survivors share one profiler session in pass 2)
    mats: Dict[int, RgCSR] = {}
    plans: Dict[tuple, ops.RgCSRPlan] = {}
    block_bytes: Dict[Tuple[int, int], Tuple[int, int]] = {}
    baseline_slots = None
    selected = []
    for cfg in candidates:
        if cfg.group_size not in mats:
            mats[cfg.group_size] = _build(m, cfg.group_size, device)
        pkey = (cfg.group_size, cfg.chunks_per_step, cfg.ordering,
                cfg.spill_threshold)
        if pkey not in plans:
            plans[pkey] = ops.PLAN_CACHE.get(
                mats[cfg.group_size], chunks_per_step=cfg.chunks_per_step,
                ordering=cfg.ordering, spill_threshold=cfg.spill_threshold)
        plan = plans[pkey]
        if baseline_slots is None:
            baseline_slots = plan.stored_elements
        if cfg.ordering == "block":
            block_bytes[(cfg.group_size, cfg.chunks_per_step)] = \
                (_plan_bytes(plan), plan.num_steps)
        else:
            # dominance pruning: an adaptive plan that moves no fewer bytes
            # and runs no fewer steps than the block plan of the same
            # (G, cps) still pays the output gather — it cannot win
            bb = block_bytes.get((cfg.group_size, cfg.chunks_per_step))
            if bb is not None and _plan_bytes(plan) >= bb[0] \
                    and plan.num_steps >= bb[1]:
                continue
        # fill-ratio pruning: a config that multiplies stored bytes on a
        # memory-bound op cannot win — skip it without timing
        if plan.stored_elements > storage_cap * max(baseline_slots, 1) \
                and selected:
            continue
        selected.append((cfg, plan))

    # pass 2 — measurement: the card's time from one shared profiler
    # session when it works, time_us otherwise; record which
    source = timing_source() if device.type == "cuda" else "wallclock"
    us_list = None
    if source == "profiler":
        fns = [(lambda plan=plan, cfg=cfg: run(plan, cfg))
               for cfg, plan in selected]
        us_list = _timing.profiled_time_us_group(fns, repeats=repeats,
                                                 warmup=1)
        if us_list is None:
            source = "wallclock"
    if us_list is None:
        us_list = [time_us(run, plan, cfg, repeats=repeats, warmup=1,
                           device=device) for cfg, plan in selected]
    timings = [(cfg, us) for (cfg, _), us in zip(selected, us_list)]
    stats = [(plan.stored_slots, plan.stored_elements,
              plan.n_spilled_elements) for _, plan in selected]

    best_cfg, best_us = min(timings, key=lambda t: t[1])
    result = TuneResult(config=best_cfg, us_per_call=best_us,
                        timings=tuple(timings), signature=sig,
                        plan_stats=tuple(stats), timing_source=source)
    _MEMO[memo_key] = result
    return result


def autotune_spmv(a, *, candidates: Optional[Iterable[TuneConfig]] = None,
                  repeats: int = 3, storage_cap: float = 4.0,
                  device="cuda") -> TuneResult:
    """Search (chunks_per_step, group_size, ordering, spill_threshold) for
    K1 on ``a`` (dense, ``scipy.sparse`` or a CSR tuple), on ``device``.

    The first candidate (the block cps=1 baseline) is always timed; later
    candidates are pruned when their padded storage exceeds
    ``storage_cap ×`` the baseline's.  Winners are memoized per
    :func:`matrix_signature`.
    """
    dev = resolve_device(device)
    m = _as_csr(a)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        m.shape[1]).astype(np.float32)).to(dev)

    def run(plan, cfg):
        return ops.rgcsr_spmv(plan, x)

    return _search(m, run, "spmv", candidates=candidates, repeats=repeats,
                   storage_cap=storage_cap, device=dev)


def autotune_spmm(a, d: int, *,
                  candidates: Optional[Iterable[TuneConfig]] = None,
                  repeats: int = 3, storage_cap: float = 4.0,
                  device="cuda") -> TuneResult:
    """Search (chunks_per_step, group_size, d_tile, ordering,
    spill_threshold) for K2 at width ``d``."""
    dev = resolve_device(device)
    m = _as_csr(a)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (m.shape[1], d)).astype(np.float32)).to(dev)

    def run(plan, cfg):
        return ops.rgcsr_spmm(plan, x, d_tile=cfg.d_tile)

    return _search(m, run, "spmm", candidates=candidates, repeats=repeats,
                   storage_cap=storage_cap, device=dev,
                   memo_key_extra=(_log_bucket(d),))


def shard_row_blocks(a, n_shards: int, x_mode: str = "replicated") -> list:
    """The per-shard blocks a :class:`ShardedRgCSR` over ``n_shards`` would
    group, as CSR tuples ``(values, columns, row_ptr, shape)``: each padded
    to ``rows_per_shard`` rows, matching the shard layout exactly, and cut
    from ``a``'s CSR arrays (never densified).

    ``x_mode='split'`` restricts each block to the shard's local column
    slice (columns shifted to start at 0, width ``cols_per_shard``): split
    grouped storage holds only local-column entries, so that is the matrix
    the schedule knobs shape.
    """
    m = _as_csr(a)
    return shard_csr_blocks(m.values, m.columns, m.row_ptr, m.shape,
                            n_shards, x_mode=x_mode)


def take_turns(device, fn):
    """``fn()`` on every rank of the default process group, which all call
    it together: at once when each rank has its own device, one rank at a
    time (a barrier between turns) when ranks share a CUDA card, so that
    their profiled windows never overlap."""
    import torch.distributed as dist
    device = torch.device(device)
    world, me = dist.get_world_size(), dist.get_rank()
    where = (socket.gethostname(), "cpu")
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        where = (where[0], str(getattr(props, "uuid", device.index)))
    places = [None] * world
    dist.all_gather_object(places, where)
    if device.type != "cuda" or len(set(places)) == world:
        return fn()
    log.info("rank %d of %d: ranks share a card (%s); each search runs one "
             "rank at a time", me, world, where[1])
    out = None
    for turn in range(world):
        if turn == me:
            out = fn()
            torch.cuda.synchronize(device)
        dist.barrier()
    return out


def autotune_spmv_per_shard(a, n_shards: int, *, group_size: int = 128,
                            repeats: int = 3, storage_cap: float = 4.0,
                            x_mode: str = "replicated", device="cuda",
                            group=None) -> Tuple[TuneResult, ...]:
    """Tune each row shard independently (DESIGN.md §12.2).

    One global winner wastes the skewed case: the shard holding the heavy
    rows wants spill/adaptive while light shards want plain block cps>1.
    Each shard's block (:func:`shard_row_blocks`; its local-column slice in
    split mode) runs its own :func:`autotune_spmv` search over
    ``(chunks_per_step, ordering, spill_threshold)`` at the fixed
    ``group_size`` (the stacked plan needs one G across shards), with spill
    candidates from the shard's own row lengths.  The returned configs feed
    ``make_sharded_plan(shard_configs=...)`` after
    :func:`harmonize_shard_winners`.

    With ``group`` (a process group of ``n_shards`` ranks, rank ``i``
    owning shard ``i``), the search runs across ranks: every rank of the
    default process group calls it together, each in one such group (the
    groups of a mesh axis); the first rank that holds a shard searches
    its block on ``device``, and the results are gathered over all ranks,
    so every rank returns the same tuple, whichever group it is in.
    """
    dev = resolve_device(device)
    blocks = shard_row_blocks(a, n_shards, x_mode=x_mode)

    def tune(blk):
        m = _as_csr(blk)
        cands = candidate_configs(
            group_sizes=(group_size,), orderings=DEFAULT_ORDERINGS,
            spill_thresholds=spill_threshold_candidates(m.row_lens))
        return autotune_spmv(m, candidates=cands, repeats=repeats,
                             storage_cap=storage_cap, device=dev)

    if group is None:
        return tuple(tune(blk) for blk in blocks)
    import torch.distributed as dist
    if dist.get_world_size(group) != n_shards:
        raise ValueError(f"{n_shards} shards but the group has "
                         f"{dist.get_world_size(group)} ranks")
    shard = dist.get_rank(group)
    holders = [None] * dist.get_world_size()
    dist.all_gather_object(holders, shard)
    searches = holders.index(shard) == dist.get_rank()
    mine = take_turns(dev, lambda: tune(blocks[shard]) if searches
                      else None)
    every = [None] * len(holders)
    dist.all_gather_object(every, mine)
    return tuple(every[holders.index(d)] for d in range(n_shards))


def harmonize_shard_winners(results: Sequence[TuneResult]) -> list:
    """Per-shard configs that *stack* well (DESIGN.md §12.2).

    The kernel cps is the gcd of the per-shard cps values, every shard's
    step table expands by ``cps_d / gcd``, and the stacked plan runs the
    *max* step count over shards — so only the bottleneck shard's step
    count at kernel cps ``k`` matters, which per-shard measured µs cannot
    see.  The stacked cost is therefore scored structurally first from the
    searches' ``plan_stats``: for each candidate kernel cps ``k``, each
    shard contributes its best config at ``chunks_per_step == k`` (else
    above ``k``, runnable at ``k`` by step-table expansion) ranked by steps
    at ``k``, then stored elements, then measured µs; ``k`` itself is
    scored by ``(max steps, total stored, bottleneck µs)``, ties to larger
    ``k``.  Ordering and spill still specialize freely per shard.
    """
    if not results:
        raise ValueError("harmonize_shard_winners needs >= 1 shard result")
    best = None
    for k in sorted(CHUNKS_PER_STEP_CHOICES):
        rows_per_step = SUBLANES * k
        picks = []
        for r in results:
            stats = r.plan_stats or ((0, 0, 0),) * len(r.timings)
            cands = [(slots // rows_per_step, elems, us, cfg)
                     for (cfg, us), (slots, elems, _) in zip(r.timings,
                                                             stats)
                     if cfg.chunks_per_step == k]
            if not cands:
                cands = [(slots // rows_per_step, elems, us, cfg)
                         for (cfg, us), (slots, elems, _) in zip(r.timings,
                                                                 stats)
                         if cfg.chunks_per_step > k]
            if not cands:
                picks = None
                break
            picks.append(min(cands))
        if picks is None:
            continue
        key = (max(p[0] for p in picks), sum(p[1] for p in picks),
               max(p[2] for p in picks), -k)
        if best is None or key < best[0]:
            best = (key, [p[3] for p in picks])
    if best is None:
        raise ValueError("no measured candidates to harmonize")
    return best[1]


def tuned_plan(a, *, repeats: int = 3, device="cuda"
               ) -> Tuple[ops.RgCSRPlan, TuneResult]:
    """Autotune K1 for ``a`` and return the winning cached plan.

    The winning matrix and plan are retained (``_TUNED``), so the
    PLAN_CACHE entry survives this call and a later call for the same
    matrix builds nothing.
    """
    dev = resolve_device(device)
    m = _as_csr(a)
    result = autotune_spmv(m, repeats=repeats, device=dev)
    key = (result.signature, result.config, _fingerprint(m), dev.type)
    hit = _TUNED.get(key)
    if hit is not None:
        return hit[1], result
    mat = _build(m, result.config.group_size, dev)
    plan = ops.PLAN_CACHE.get(
        mat, chunks_per_step=result.config.chunks_per_step,
        ordering=result.config.ordering,
        spill_threshold=result.config.spill_threshold)
    _TUNED[key] = (mat, plan)
    return plan, result
