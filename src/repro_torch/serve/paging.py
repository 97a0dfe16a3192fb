"""Paged KV-cache subsystem: page pool allocator + cache commit/sync ops.

The PyTorch counterpart of ``repro.serve.paging``: GQA layers page their
``k``/``v`` (and int8 scales), MLA layers their latent ``ckv`` and rope
key ``krope``; every routine below walks the pool keys a cache has.
Fixed-size pages trade bounded per-slot padding (at most
``page_size - 1`` dead token slots per request, inside its last page) for
regular addressing, as RgCSR's uniform groups trade per-group padding for
regular strides; residency follows *actual* sequence lengths: a slot
holding a 37-token request owns ``ceil(37 / page_size)`` pages, not
``S_max`` rows.

Split of responsibilities:

* **Device side** (``models/attention.py``): each paged attention layer's
  cache is a shared page pool ``(n_pages, page_size, ...)`` plus per-slot
  ``block_table`` / ``index`` vectors.
* **Host side** (this module): :class:`PageAllocator` owns the free list
  and the authoritative block table (numpy), under one of two admission
  policies — ``"worst_case"`` reserves each request's worst case up front
  (admissions defer when the pool cannot cover it), ``"prompt"`` reserves
  the resident tokens' pages only and raises :class:`PoolExhausted` at a
  decode boundary that finds the pool dry, the engine's signal to
  recompute-preempt a victim.  Page 0 is the null page free slots point at.

The allocator is a copy of the reference's (it is plain numpy).  The cache
operations differ in one way: the reference's caches are immutable and
each operation returns new ones, while here :func:`commit_prefill`,
:func:`sync_block_tables` and :func:`corrupt_page` write into the live
tensors in place and return nothing.  The serving session's fused decode
loop is a CUDA graph on the card, which reads every cache tensor at the
address it had when the graph was captured, so a cache tensor is never
replaced.

The caches here are the port's: one dict per layer, in layer order (the
reference stacks the body's layers on a leading axis).  A recurrent
layer's cache is its per-slot state (``conv``, ``ssm`` or ``h``): it holds
no page, so the page routines pass it by, as they pass the rings of
windowed layers.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.attention import PageGeometry
from repro_torch.models.recurrent import STATE_KEYS
from repro_torch.obs import metrics as obs_metrics

__all__ = ["PageGeometry", "PageAllocator", "PoolExhausted", "geometry",
           "commit_prefill", "sync_block_tables", "page_fingerprints",
           "pages_nonfinite", "corrupt_page", "crc_order",
           "SERVE_MERGE_SPEC", "merge_replica_stats"]

# cache keys that live in page pools (everything else is per-slot dense)
_POOL_KEYS = ("k", "v", "k_scale", "v_scale", "ckv", "krope")


def geometry(max_seq: int, page_size: int, n_slots: int,
             n_pages: int = 0) -> PageGeometry:
    """Resolve a :class:`PageGeometry`.  ``n_pages=0`` auto-sizes the pool
    to dense capacity (every slot can reach ``max_seq``) plus the null
    page — admission then never defers; smaller pools trade deferrals for
    memory."""
    pages_per_slot = -(-max_seq // page_size)
    if n_pages <= 0:
        n_pages = 1 + n_slots * pages_per_slot
    return PageGeometry(n_pages=n_pages, page_size=page_size,
                        pages_per_slot=pages_per_slot)


class PoolExhausted(RuntimeError):
    """Raised by :meth:`PageAllocator.ensure` under ``policy="prompt"``
    when a slot must grow but the free list is empty — the engine's
    signal to recompute-preempt a victim slot and retry."""


class PageAllocator:
    """Host-side page bookkeeping for one serving session.

    Invariants (asserted on every mutation, see :meth:`_check`):

    * ``sum(reserved) <= usable_pages`` — admission control;
    * ``len(free) + pages_in_use == usable_pages`` — pages are never lost
      or double-owned (a double :meth:`release` would otherwise hand the
      same page to two slots);
    * each slot's physical pages never exceed its own worst-case cap.

    ``policy="worst_case"`` reserves the request's whole worst case at
    admission, so :meth:`ensure` can always pop a free page and decode
    never stalls.  ``policy="prompt"`` reserves only what the resident
    tokens need (the reservation tracks the allocation); :meth:`ensure`
    then raises :class:`PoolExhausted` when the pool runs dry and the
    caller must evict a victim (``release(evicted=True)``) before
    retrying.

    **Integrity extensions**: :meth:`quarantine` takes a page out of
    circulation permanently (suspected device-memory corruption) — a
    quarantined page shrinks :attr:`usable` so the accounting invariant
    keeps holding; :meth:`record_checksum` / :attr:`checksums` store
    per-page ``(committed_tokens, crc32)`` fingerprints recorded by the
    engine at chunk-commit boundaries.  ``strict=True`` upgrades the
    (counted) idempotent double-release near-miss into a hard error.
    """

    POLICIES = ("worst_case", "prompt")

    def __init__(self, geom: PageGeometry, n_slots: int,
                 policy: str = "worst_case", strict: bool = False):
        if policy not in self.POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}: "
                             f"expected one of {self.POLICIES}")
        self.geom = geom
        self.n_slots = n_slots
        self.policy = policy
        self.strict = strict
        # LIFO free list over pages 1..n_pages-1 (page 0 = null page);
        # popping the lowest id first keeps allocation deterministic
        self.free: List[int] = list(range(geom.n_pages - 1, 0, -1))
        self.table = np.zeros((n_slots, geom.pages_per_slot), np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
        self.reserved = [0] * n_slots
        self.worst_cap = [geom.pages_per_slot] * n_slots
        self.high_water = 0
        # eviction accounting (preemption observability)
        self.evictions = 0
        self.pages_evicted = 0
        # integrity accounting
        self.double_release = 0
        self.quarantined: set = set()          # out of circulation for good
        self._pending_quarantine: set = set()  # owned by a slot; withheld
        #                                        from the free list at release
        self.checksums: Dict[int, Tuple[int, int]] = {}
        # observability hook: the owning session points these at its
        # tracer so quarantines land on the replica's track.  None while
        # tracing is off (and during restore-replay, where the quarantines
        # were already traced by the process that found them).
        self.tracer = None
        self.trace_track = None

    # ------------------------------------------------------------- queries
    @property
    def usable(self) -> int:
        """Pages the allocator may hand out: the geometric pool minus
        pages quarantined after corruption (pending ones still sit in a
        slot, so they count as in-use until released)."""
        return self.geom.usable_pages - len(self.quarantined)

    @property
    def pages_in_use(self) -> int:
        return sum(len(p) for p in self.slot_pages)

    @property
    def free_pages(self) -> int:
        """Pages available right now — the router's load-balance signal."""
        return len(self.free)

    def pages_for(self, n_tokens: int) -> int:
        return self.geom.pages_for(n_tokens)

    def admission_pages(self, n_tokens: int, worst_pages: int) -> int:
        """Pages admission will reserve for a request under this policy:
        the full worst case, or just the resident prompt's pages."""
        if self.policy == "prompt":
            return self.pages_for(n_tokens)
        return worst_pages

    def can_admit(self, pages: int) -> bool:
        return sum(self.reserved) + pages <= self.usable

    def _check(self) -> None:
        assert sum(self.reserved) <= self.usable, \
            "admission invariant violated: reservations exceed the pool"
        assert len(self.free) + self.pages_in_use == self.usable, \
            "page accounting violated: free list + in-use != usable " \
            "(double release or leaked page)"
        for s, pages in enumerate(self.slot_pages):
            assert len(pages) <= self.worst_cap[s], \
                f"slot {s} holds more pages than its worst case"

    # ------------------------------------------------------------- updates
    def admit(self, slot: int, n_tokens: int, worst_pages: int) -> bool:
        """Reserve pages for the slot per the admission policy and
        allocate the prompt's pages.  Returns False (nothing changed) when
        the pool can't cover the reservation — the caller defers the
        request."""
        need = self.admission_pages(n_tokens, worst_pages)
        if not self.can_admit(need):
            return False
        self.worst_cap[slot] = worst_pages
        self.reserved[slot] = need
        self.ensure(slot, n_tokens)
        return True

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow the slot's pages to cover ``n_tokens``; True if the block
        table changed (the engine then re-syncs device tables).  Under
        ``policy="prompt"`` the reservation grows with the allocation, and
        :class:`PoolExhausted` is raised if the free list runs dry — the
        partial growth is kept (the slot owns what it got) so the caller
        can evict a victim and retry the same call."""
        need = self.pages_for(n_tokens)
        if self.policy == "prompt":
            assert need <= self.worst_cap[slot], \
                f"slot {slot} grew past its worst-case cap"
        else:
            assert need <= self.reserved[slot], \
                f"slot {slot} grew past its admission reservation"
        changed = False
        pages = self.slot_pages[slot]
        try:
            while len(pages) < need:
                if self.policy == "prompt" and not self.free:
                    raise PoolExhausted(
                        f"slot {slot} needs page {len(pages) + 1}/{need} "
                        f"but the pool is dry")
                page = self.free.pop()
                self.table[slot, len(pages)] = page
                pages.append(page)
                if self.policy == "prompt":
                    self.reserved[slot] = len(pages)
                changed = True
        finally:
            if self.pages_in_use > self.high_water:
                self.high_water = self.pages_in_use
            self._check()
        return changed

    def release(self, slot: int, evicted: bool = False) -> int:
        """Free the slot on completion/eviction: pages return to the pool,
        the table row points back at the null page, the reservation lifts.
        The *cache contents* are untouched — slot reuse needs no reset.

        Idempotent: releasing an already-free slot is a no-op (it must
        not re-extend the free list — that would hand the same page to
        two slots).  Returns the number of pages freed; ``evicted=True``
        additionally counts the free toward the preemption accounting."""
        freed = len(self.slot_pages[slot])
        if freed == 0 and self.reserved[slot] == 0:
            # near-miss: harmless today, but a second release of a live
            # slot would double-own pages — count it so accounting bugs
            # upstream are observable (raise when strict)
            self.double_release += 1
            if self.strict:
                raise RuntimeError(
                    f"double release of already-free slot {slot}")
            return 0
        for page in reversed(self.slot_pages[slot]):
            self.checksums.pop(page, None)
            if page in self._pending_quarantine:
                self._pending_quarantine.discard(page)
                self.quarantined.add(page)
            else:
                self.free.append(page)
        self.slot_pages[slot] = []
        self.table[slot] = 0
        self.reserved[slot] = 0
        self.worst_cap[slot] = self.geom.pages_per_slot
        if evicted:
            self.evictions += 1
            self.pages_evicted += freed
        self._check()
        return freed

    # ---------------------------------------------------------- integrity
    def owner_of(self, page: int) -> Optional[int]:
        """Slot currently holding ``page``, or None (free/quarantined)."""
        for slot, pages in enumerate(self.slot_pages):
            if page in pages:
                return slot
        return None

    def quarantine(self, page: int) -> bool:
        """Take a (suspected-corrupt) page out of circulation for the
        rest of this allocator's life.  A free page leaves the free list
        immediately; a page still owned by a slot is marked pending and
        withheld from the free list when that slot releases.  Returns
        False if the page was already quarantined (idempotent)."""
        if not 0 < page < self.geom.n_pages:
            raise ValueError(f"page {page} outside pool "
                             f"(1..{self.geom.n_pages - 1})")
        if page in self.quarantined or page in self._pending_quarantine:
            return False
        self.checksums.pop(page, None)
        if page in self.free:
            self.free.remove(page)
            self.quarantined.add(page)
        else:
            self._pending_quarantine.add(page)
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.instant("page_quarantine", self.trace_track,
                                page=page)
        self._check()
        return True

    @property
    def pages_quarantined(self) -> int:
        return len(self.quarantined) + len(self._pending_quarantine)

    def record_checksum(self, page: int, n_tokens: int, crc: int) -> None:
        """Record the fingerprint of a page's committed contents (engine
        calls this at chunk-commit boundaries; n_tokens is how many of
        the page's token rows the crc covers)."""
        self.checksums[page] = (int(n_tokens), int(crc))

    def stats(self) -> dict:
        return {
            "n_pages": self.geom.n_pages,
            "page_size": self.geom.page_size,
            "usable_pages": self.usable,
            "pages_in_use": self.pages_in_use,
            "page_high_water": self.high_water,
            "reserved_pages": sum(self.reserved),
            "admission_policy": self.policy,
            "evictions": self.evictions,
            "pages_evicted": self.pages_evicted,
            "double_release": self.double_release,
            "pages_quarantined": self.pages_quarantined,
        }


# ---------------------------------------------------------------------------
# cache ops (host-driven, eager — once per admission / table change), all
# in place
# ---------------------------------------------------------------------------


def _paged(cache) -> bool:
    return "block_table" in cache


def commit_prefill(caches, slot_cache, slot: int, length: int,
                   table: Optional[np.ndarray] = None,
                   page_size: Optional[int] = None) -> None:
    """Install a batch-1 prefill cache into slot ``slot`` of the live
    decode caches, in place.  Paged layers scatter the prompt's ``length``
    tokens into the slot's pages via ``table`` (the allocator's
    authoritative block table; token t -> (table[slot, t // ps], t % ps))
    and take the whole table; a recurrent layer's state (conv tail and
    SSM or LRU state) is installed whole, so nothing of the slot's last
    request survives; every other layer (dense slab, ring) copies the
    batch-1 cache into its slot row, index included; a decoder layer's
    ``{"self", "ck", "cv"}`` commits its self cache so and copies the cross
    keys and values into the slot.  In dense mode pass
    ``table=None`` — no paged layer exists (a stack with no paged layer
    ignores the table)."""
    page_ids = offs = table_dev = None
    paged = [c for c in caches if _paged(c)]
    if table is not None and paged:
        dev = paged[0]["block_table"].device
        pos = np.arange(length)
        row = np.asarray(table)[slot]
        page_ids = torch.from_numpy(row[pos // page_size].astype(np.int64)
                                    ).to(dev)
        offs = torch.from_numpy((pos % page_size).astype(np.int64)).to(dev)
        table_dev = torch.from_numpy(np.asarray(table, np.int32)).to(dev)
    for full, one in zip(caches, slot_cache, strict=True):
        if "self" in full:                  # dec_attn: self + cross k/v
            for key in ("ck", "cv"):
                full[key][slot].copy_(one[key][0])
            full, one = full["self"], one["self"]
        if _paged(full):
            for key in _POOL_KEYS:
                if key in full:
                    full[key][page_ids, offs] = one[key][0, :length].to(
                        full[key].dtype)
            full["index"][slot] = length
            full["block_table"].copy_(table_dev)
        elif any(key in full for key in STATE_KEYS):
            for key, t in full.items():
                src = one[key][0]
                if src.shape != t.shape[1:]:
                    raise ValueError(
                        f"recurrent state {key!r} of shape "
                        f"{tuple(src.shape)} does not fill a slot's "
                        f"{tuple(t.shape[1:])}")
                t[slot].copy_(src)
        else:
            # a dense slab may be one row longer (the session's spare row)
            for key, t in full.items():
                dst, src = t[slot], one[key][0]
                (dst[:src.shape[0]] if dst.dim() else dst).copy_(src)


def sync_block_tables(caches, table: np.ndarray) -> None:
    """Push the allocator's host block table into every paged layer's
    ``block_table``, in place (decode-boundary page allocations, slot
    frees): one copy to the card, then one on the card per layer."""
    paged = [c for c in caches if _paged(c)]
    if not paged:
        return
    t = torch.from_numpy(np.asarray(table, np.int32)).to(
        paged[0]["block_table"].device)
    for cache in paged:
        cache["block_table"].copy_(t)


# Authoritative merge schema for session stats.  Counters sum across
# replicas; capacity gauges take the fleet-wide extreme (with per-replica
# lists kept so a skewed router policy shows up, not just in the max); pool
# geometry comes from the first replica (replicas share one config);
# latency histograms merge by sample concatenation.  peak_live_tokens rides
# the page_high_water gate: it is reported whenever any replica reports
# paging high-water figures, even for sessions that never recorded a live
# peak.
SERVE_MERGE_SPEC: Dict[str, obs_metrics.MergeRule] = {
    **{k: obs_metrics.MergeRule("sum") for k in (
        "requests", "completed", "preemptions", "recompute_tokens",
        "rejected", "failed", "timed_out", "decode_steps",
        "decode_dispatches", "admission_deferrals", "evictions",
        "pages_evicted", "double_release", "pages_quarantined",
        "nonfinite_logits", "restores", "restore_recompute_tokens")},
    "straggler_decode_steps": obs_metrics.MergeRule(
        "sum", list_as="straggler_decode_steps_per_replica"),
    **{k: obs_metrics.MergeRule("first") for k in (
        "n_pages", "page_size", "usable_pages", "admission_policy",
        "kv_layout", "dense_equiv_tokens")},
    "page_high_water": obs_metrics.MergeRule(
        "max", list_as="page_high_water_per_replica"),
    "peak_live_tokens": obs_metrics.MergeRule(
        "max", gate="page_high_water"),
    "request_timing": obs_metrics.MergeRule("hist_map"),
}


def merge_replica_stats(per_replica: list) -> dict:
    """Aggregate per-replica session stats into one router-level view — a
    straight application of :data:`SERVE_MERGE_SPEC` through
    :func:`repro_torch.obs.metrics.merge_stats`."""
    return obs_metrics.merge_stats(per_replica, SERVE_MERGE_SPEC)


def crc_order(cfg) -> List[List[int]]:
    """The layers in the order the reference's fingerprints read them:
    each prefix layer on its own, then for each pattern position the
    layers of every repeat (the reference stacks them on a leading axis).
    The port's layers run repeat-major (``models/model.py``)."""
    n_pre, n_pat = len(cfg.prefix_pattern), len(cfg.layer_pattern)
    return [[i] for i in range(n_pre)] + [
        [n_pre + r * n_pat + j for r in range(cfg.pattern_repeats)]
        for j in range(n_pat)]


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A CPU copy of ``t`` as raw bytes, last axis widened to bytes."""
    t = t.detach().cpu().contiguous()
    return t.view(torch.uint8).numpy()


def page_fingerprints(caches, committed: Dict[int, int],
                      order: Optional[List[List[int]]] = None
                      ) -> Dict[int, int]:
    """crc32 fingerprint of each page's committed contents.

    ``committed`` maps page id -> number of token rows committed into that
    page; the crc covers exactly those rows (a page's tail beyond the
    committed length holds garbage from slot reuse, so it must not feed
    the fingerprint).  The crc chains over every pool tensor of every
    paged layer, so corruption in any layer/head is caught.  ``order``
    (:func:`crc_order` of the model's config; default: one group, the
    layers in order) groups the layers as the reference stacks them, so
    that the same bytes give the reference's crc: per group, per pool key,
    the group's layers in turn.
    """
    crcs = {page: 0 for page in committed}
    if not crcs:
        return crcs
    pages = sorted(committed)
    if order is None:
        order = [list(range(len(caches)))]
    for group in order:
        group = [i for i in group if _paged(caches[i])]
        if not group:
            continue
        for key in _POOL_KEYS:
            if key not in caches[group[0]]:
                continue
            for i in group:
                pool = caches[i][key]
                idx = torch.tensor(pages, device=pool.device)
                sel = _host_bytes(pool[idx])           # (n, ps, ..., bytes)
                for j, page in enumerate(pages):
                    crcs[page] = zlib.crc32(
                        sel[j, :committed[page]].tobytes(), crcs[page])
    return crcs


def pages_nonfinite(caches, pages) -> set:
    """Subset of ``pages`` holding any NaN/Inf in a float pool tensor —
    precise localization for the commit-loop logit screen (NaN leaks
    through the attention mask from *any* position of a touched page, so
    detection can't rely on the committed-region checksums alone)."""
    pages = list(pages)
    if not pages:
        return set()
    bad = np.zeros(len(pages), bool)
    for cache in caches:
        if not _paged(cache):
            continue
        for key in _POOL_KEYS:
            pool = cache.get(key)
            if pool is None or not pool.is_floating_point():
                continue
            sel = pool[torch.tensor(pages, device=pool.device)]
            bad |= (~torch.isfinite(sel)).reshape(len(pages), -1).any(
                1).cpu().numpy()
    return {p for p, b in zip(pages, bad) if b}


def corrupt_page(caches, page: int, nan: bool = False) -> None:
    """Scribble over KV page ``page`` in every pool tensor, in place — the
    ``("page", idx)`` fault payload (simulated device-memory corruption).
    ``nan=True`` writes NaN into float pools (poisons logits, caught by
    the engine's commit-time screen); otherwise writes finite garbage
    (silent — caught only by the checksum verify)."""
    for cache in caches:
        if not _paged(cache):
            continue
        for key in _POOL_KEYS:
            pool = cache.get(key)
            if pool is None:
                continue
            if pool.is_floating_point():
                pool[page] = float("nan") if nan else 1e4
            else:
                pool[page] = torch.iinfo(pool.dtype).max
