"""Sparse-matrix storage formats from the paper, as frozen dataclasses of tensors.

The PyTorch counterpart of ``repro.core.formats``, array for array:

* :class:`CSR`            — common Compressed Sparse Rows (Fig. 1).
* :class:`COO`            — coordinate format (Fig. 4).
* :class:`ELLPACK`        — fixed-K padded format (Fig. 3), stored slot-major
                            ``(K, N)`` — the coalesced GPU layout.
* :class:`HybridEllCoo`   — Bell–Garland Hybrid (ELL + COO spill) [1].
* :class:`BlockedCSR`     — 4x4-style BSR (Fig. 2) [Buatois et al.].
* :class:`SlicedEllpack`  — Monakov et al. sliced ELLPACK (no rowLengths).
* :class:`RgCSR`          — the paper's Row-grouped CSR (Fig. 5): slot-major
                            groups + ``group_pointers`` + ``row_lengths``.
* :class:`ShardedRgCSR`   — RgCSR partitioned by rows, one RgCSR per shard
                            of a 1-D mesh axis (DESIGN.md §11).

Every format is built on the host in numpy from CSR arrays
(:func:`from_csr`), with no per-row Python loop, so a matrix with millions
of rows builds in seconds; :func:`from_dense` is a thin wrapper that walks
the dense matrix once into CSR.  The finished arrays move to ``device``,
which defaults to ``"cuda"`` and raises when no card is present — pass
``device="cpu"`` to stay on the host.

Group geometry (DESIGN.md §2): within one RgCSR group of ``G`` rows the data
for slot ``k`` occupies ``G`` consecutive elements, so one CTA of ``G``
threads reads each slot coalesced.  Each group's slot count is padded to a
multiple of ``slot_pad`` (default 8); the padding is accounted exactly like
the paper's "artificial zeros".
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, Tuple

import numpy as np
import torch

# Rows per RgCSR group: one CTA of 128 threads, one thread per row.
DEFAULT_GROUP_SIZE = 128
# Slots per group are padded to a multiple of this (the step granularity).
DEFAULT_SLOT_PAD = 8

__all__ = [
    "CSR",
    "COO",
    "ELLPACK",
    "HybridEllCoo",
    "BlockedCSR",
    "SlicedEllpack",
    "RgCSR",
    "ShardedRgCSR",
    "shard_csr_blocks",
    "split_columns",
    "from_dense",
    "from_csr",
    "from_numpy",
    "resolve_device",
    "FORMATS",
]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for (the default) but no CUDA card is "
            "present; pass device='cpu' to run on the host")
    return dev


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _as_2d(dense: np.ndarray) -> np.ndarray:
    dense = np.asarray(dense)
    if dense.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got shape {dense.shape}")
    return dense


def _csr_arrays(dense: np.ndarray):
    """Host-side CSR triplet from a dense matrix (row-major nonzero walk)."""
    rows, cols = np.nonzero(dense)
    values = dense[rows, cols]
    n_rows = dense.shape[0]
    row_ptr = np.zeros(n_rows + 1, dtype=np.int32)
    np.add.at(row_ptr, rows + 1, 1)
    row_ptr = np.cumsum(row_ptr, dtype=np.int64).astype(np.int32)
    return values, cols.astype(np.int32), rows.astype(np.int32), row_ptr


@dataclasses.dataclass(frozen=True)
class _Csr:
    """Validated host CSR with columns sorted within each row."""

    values: np.ndarray     # (nnz,)
    columns: np.ndarray    # (nnz,) int64
    row_ptr: np.ndarray    # (n_rows + 1,) int64
    rows: np.ndarray       # (nnz,) int64 row of each entry
    slot: np.ndarray       # (nnz,) int64 position of each entry in its row
    row_lens: np.ndarray   # (n_rows,) int64
    shape: Tuple[int, int]


def _canonical_csr(values, columns, row_ptr, shape) -> _Csr:
    """Check a CSR triplet and sort its columns within each row.

    Explicit entries are kept as given, stored zeros included: the format
    holds what the caller stored.
    """
    n_rows, n_cols = (int(s) for s in shape)
    values = np.asarray(values)
    columns = np.asarray(columns).astype(np.int64, copy=False)
    row_ptr = np.asarray(row_ptr).astype(np.int64, copy=False)
    if values.ndim != 1 or columns.shape != values.shape:
        raise ValueError("values and columns must be 1-D arrays of one length")
    if row_ptr.shape != (n_rows + 1,):
        raise ValueError(
            f"row_ptr must have n_rows + 1 = {n_rows + 1} entries, "
            f"got {row_ptr.shape}")
    if row_ptr[0] != 0 or row_ptr[-1] != len(values) or np.any(
            np.diff(row_ptr) < 0):
        raise ValueError("row_ptr must rise from 0 to len(values)")
    if len(columns) and (columns.min() < 0 or columns.max() >= n_cols):
        raise ValueError(f"column index outside [0, {n_cols})")
    row_lens = np.diff(row_ptr)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), row_lens)
    key = rows * max(n_cols, 1) + columns
    if np.any(key[1:] < key[:-1]):
        order = np.lexsort((columns, rows))
        values, columns = values[order], columns[order]
    slot = np.arange(len(values), dtype=np.int64) - np.repeat(
        row_ptr[:-1], row_lens)
    return _Csr(values=values, columns=columns, row_ptr=row_ptr, rows=rows,
                slot=slot, row_lens=row_lens, shape=(n_rows, n_cols))


def _arr():
    return dataclasses.field(metadata={"array": True})


def _static():
    return dataclasses.field(metadata={"array": False})


class _Format:
    """``from_dense`` for every format: dense → CSR → ``from_csr``."""

    @classmethod
    def from_dense(cls, dense: np.ndarray, *, device="cuda", **kwargs):
        dense = _as_2d(dense)
        values, cols, _, row_ptr = _csr_arrays(dense)
        return cls.from_csr(values, cols, row_ptr, dense.shape,
                            device=device, **kwargs)


# ---------------------------------------------------------------------------
# CSR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class CSR(_Format):
    """Common CSR (paper §3.1). ``row_ids`` is derived, used only by the
    segment-sum oracle, and NOT counted in the storage footprint."""

    values: Any = _arr()
    columns: Any = _arr()
    row_pointers: Any = _arr()
    row_ids: Any = _arr()
    shape: Tuple[int, int] = _static()

    name: ClassVar[str] = "csr"

    @classmethod
    def from_csr(cls, values, columns, row_ptr, shape, *,
                 device="cuda") -> "CSR":
        dev = resolve_device(device)
        c = _canonical_csr(values, columns, row_ptr, shape)
        return cls(values=_tensor(c.values, dev),
                   columns=_tensor(c.columns.astype(np.int32), dev),
                   row_pointers=_tensor(c.row_ptr.astype(np.int32), dev),
                   row_ids=_tensor(c.rows.astype(np.int32), dev),
                   shape=c.shape)

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def stored_elements(self) -> int:
        return self.nnz

    def storage_bytes(self) -> int:
        """values + columns + rowPointers, per the paper's byte accounting."""
        itemsize = self.values.element_size()
        return self.nnz * itemsize + self.nnz * 4 + (self.shape[0] + 1) * 4

    def to_dense(self) -> np.ndarray:
        vals = _host(self.values)
        out = np.zeros(self.shape, dtype=vals.dtype)
        np.add.at(out, (_host(self.row_ids), _host(self.columns)), vals)
        return out


# ---------------------------------------------------------------------------
# COO
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class COO(_Format):
    """Coordinate format (paper Fig. 4): fully explicit (row, col, value)."""

    values: Any = _arr()
    rows: Any = _arr()
    columns: Any = _arr()
    shape: Tuple[int, int] = _static()

    name: ClassVar[str] = "coo"

    @classmethod
    def from_csr(cls, values, columns, row_ptr, shape, *,
                 device="cuda") -> "COO":
        dev = resolve_device(device)
        c = _canonical_csr(values, columns, row_ptr, shape)
        return cls(values=_tensor(c.values, dev),
                   rows=_tensor(c.rows.astype(np.int32), dev),
                   columns=_tensor(c.columns.astype(np.int32), dev),
                   shape=c.shape)

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def stored_elements(self) -> int:
        return self.nnz

    def storage_bytes(self) -> int:
        return self.nnz * (self.values.element_size() + 8)

    def to_dense(self) -> np.ndarray:
        vals = _host(self.values)
        out = np.zeros(self.shape, dtype=vals.dtype)
        np.add.at(out, (_host(self.rows), _host(self.columns)), vals)
        return out


# ---------------------------------------------------------------------------
# ELLPACK
# ---------------------------------------------------------------------------


def _slot_major_to_dense(values: np.ndarray, columns: np.ndarray,
                         out: np.ndarray) -> None:
    """Add a slot-major ``(K, N)`` tile's nonzeros into ``out``."""
    n_rows = out.shape[0]
    for slot in range(values.shape[0]):
        mask = values[slot, :n_rows] != 0
        out[np.arange(n_rows)[mask], columns[slot, :n_rows][mask]] += \
            values[slot, :n_rows][mask]


@dataclasses.dataclass(frozen=True, eq=False)
class ELLPACK(_Format):
    """ELLPACK (paper Fig. 3), stored slot-major ``(K, N)``: slot ``k`` of
    all rows is one contiguous vector, so one thread per row reads it
    coalesced.  Padding has value 0 and column 0 (a ghost index that keeps
    the gather in bounds)."""

    values: Any = _arr()   # (K, N)
    columns: Any = _arr()  # (K, N) int32
    shape: Tuple[int, int] = _static()

    name: ClassVar[str] = "ellpack"

    @classmethod
    def from_csr(cls, values, columns, row_ptr, shape, *,
                 device="cuda") -> "ELLPACK":
        dev = resolve_device(device)
        c = _canonical_csr(values, columns, row_ptr, shape)
        n_rows = c.shape[0]
        k = max(int(c.row_lens.max()) if n_rows else 0, 1)
        vals = np.zeros((k, n_rows), dtype=c.values.dtype)
        cols = np.zeros((k, n_rows), dtype=np.int32)
        vals[c.slot, c.rows] = c.values
        cols[c.slot, c.rows] = c.columns
        return cls(values=_tensor(vals, dev), columns=_tensor(cols, dev),
                   shape=c.shape)

    @property
    def nnz(self) -> int:
        return int((self.values != 0).sum())

    @property
    def stored_elements(self) -> int:
        return int(self.values.numel())

    def storage_bytes(self) -> int:
        return self.stored_elements * (self.values.element_size() + 4)

    def to_dense(self) -> np.ndarray:
        vals = _host(self.values)
        out = np.zeros(self.shape, dtype=vals.dtype)
        _slot_major_to_dense(vals, _host(self.columns), out)
        return out


# ---------------------------------------------------------------------------
# Hybrid (ELL + COO)
# ---------------------------------------------------------------------------


def _hybrid_split_k(row_lens: np.ndarray, relative_speed: float = 3.0,
                    breakeven_threshold: int = 4096) -> int:
    """Bell–Garland / CUSP heuristic for K1 (paper §3.3).

    Choose the largest K such that at least ``max(N/relative_speed,
    breakeven_threshold)`` rows still have >= K nonzeros — i.e. the ELL part
    stays mostly dense and the spill goes to COO.
    """
    n = len(row_lens)
    if n == 0:
        return 0
    hist = np.bincount(np.minimum(row_lens, row_lens.max()), minlength=row_lens.max() + 2)
    # rows_with_at_least[k] = number of rows with >= k nonzeros
    rows_with_at_least = n - np.cumsum(hist)[:-1]
    threshold = min(n, max(n / relative_speed, breakeven_threshold))
    ks = np.nonzero(rows_with_at_least >= threshold)[0]
    return int(ks.max()) if len(ks) else 0


@dataclasses.dataclass(frozen=True, eq=False)
class HybridEllCoo(_Format):
    """Hybrid format [Bell & Garland 2008] (paper §3.3): ELLPACK for the first
    ``k1`` nonzeros of each row, COO for the spill."""

    ell_values: Any = _arr()   # (K1, N)
    ell_columns: Any = _arr()  # (K1, N)
    coo_values: Any = _arr()
    coo_rows: Any = _arr()
    coo_columns: Any = _arr()
    shape: Tuple[int, int] = _static()
    k1: int = _static()

    name: ClassVar[str] = "hybrid"

    @classmethod
    def from_csr(cls, values, columns, row_ptr, shape, *, k1: int | None = None,
                 device="cuda") -> "HybridEllCoo":
        dev = resolve_device(device)
        c = _canonical_csr(values, columns, row_ptr, shape)
        n_rows = c.shape[0]
        if k1 is None:
            k1 = _hybrid_split_k(c.row_lens)
        k1 = int(max(k1, 0))
        head = c.slot < k1
        ell_values = np.zeros((max(k1, 1), n_rows), dtype=c.values.dtype)
        ell_columns = np.zeros((max(k1, 1), n_rows), dtype=np.int32)
        ell_values[c.slot[head], c.rows[head]] = c.values[head]
        ell_columns[c.slot[head], c.rows[head]] = c.columns[head]
        tail = ~head
        return cls(
            ell_values=_tensor(ell_values, dev),
            ell_columns=_tensor(ell_columns, dev),
            coo_values=_tensor(c.values[tail], dev),
            coo_rows=_tensor(c.rows[tail].astype(np.int32), dev),
            coo_columns=_tensor(c.columns[tail].astype(np.int32), dev),
            shape=c.shape,
            k1=k1,
        )

    @property
    def nnz(self) -> int:
        return int((self.ell_values != 0).sum()) + int(self.coo_values.shape[0])

    @property
    def stored_elements(self) -> int:
        return int(self.ell_values.numel()) + int(self.coo_values.shape[0])

    def storage_bytes(self) -> int:
        itemsize = self.ell_values.element_size()
        ell = int(self.ell_values.numel()) * (itemsize + 4)
        coo = int(self.coo_values.shape[0]) * (itemsize + 8)
        return ell + coo

    def to_dense(self) -> np.ndarray:
        vals = _host(self.ell_values)
        out = np.zeros(self.shape, dtype=vals.dtype)
        _slot_major_to_dense(vals, _host(self.ell_columns), out)
        np.add.at(out, (_host(self.coo_rows), _host(self.coo_columns)),
                  _host(self.coo_values))
        return out


# ---------------------------------------------------------------------------
# Blocked CSR (BSR)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class BlockedCSR(_Format):
    """Blocked CSR (paper §3.2, Fig. 2): dense ``bs x bs`` blocks of the matrix
    itself (not of the compressed rows) — the format the paper criticizes for
    low fill efficiency (27% in Fig. 2)."""

    values: Any = _arr()              # (n_blocks, bs, bs)
    block_columns: Any = _arr()       # (n_blocks,)
    block_row_pointers: Any = _arr()  # (n_block_rows + 1,)
    block_row_ids: Any = _arr()       # derived, for the oracle
    shape: Tuple[int, int] = _static()
    block_size: int = _static()

    name: ClassVar[str] = "blocked_csr"

    @classmethod
    def from_csr(cls, values, columns, row_ptr, shape, *, block_size: int = 4,
                 device="cuda") -> "BlockedCSR":
        dev = resolve_device(device)
        c = _canonical_csr(values, columns, row_ptr, shape)
        bs = int(block_size)
        nbr, nbc = -(-c.shape[0] // bs), -(-c.shape[1] // bs)
        keys, block_of = np.unique((c.rows // bs) * nbc + c.columns // bs,
                                   return_inverse=True)
        brows, bcols = keys // max(nbc, 1), keys % max(nbc, 1)
        vals = np.zeros((len(keys), bs, bs), dtype=c.values.dtype)
        np.add.at(vals, (block_of, c.rows % bs, c.columns % bs), c.values)
        ptr = np.zeros(nbr + 1, dtype=np.int32)
        np.add.at(ptr, brows + 1, 1)
        ptr = np.cumsum(ptr).astype(np.int32)
        return cls(
            values=_tensor(vals, dev),
            block_columns=_tensor(bcols.astype(np.int32), dev),
            block_row_pointers=_tensor(ptr, dev),
            block_row_ids=_tensor(brows.astype(np.int32), dev),
            shape=c.shape,
            block_size=bs,
        )

    @property
    def nnz(self) -> int:
        return int((self.values != 0).sum())

    @property
    def stored_elements(self) -> int:
        return int(self.values.numel())

    def storage_bytes(self) -> int:
        itemsize = self.values.element_size()
        nb = int(self.values.shape[0])
        return (self.stored_elements * itemsize + nb * 4
                + len(self.block_row_pointers) * 4)

    def to_dense(self) -> np.ndarray:
        bs = self.block_size
        nbr = len(self.block_row_pointers) - 1
        nbc = (self.shape[1] + bs - 1) // bs
        vals = _host(self.values)
        out = np.zeros((nbr * bs, nbc * bs), dtype=vals.dtype)
        brows = _host(self.block_row_ids)
        bcols = _host(self.block_columns)
        for b in range(vals.shape[0]):
            r0, c0 = brows[b] * bs, bcols[b] * bs
            out[r0:r0 + bs, c0:c0 + bs] += vals[b]
        return out[: self.shape[0], : self.shape[1]]


# ---------------------------------------------------------------------------
# Row-grouped CSR — the paper's format — and Sliced ELLPACK
# ---------------------------------------------------------------------------


def _rgcsr_arrays(c: _Csr, group_size: int, slot_pad: int) -> Dict[str, Any]:
    """Slot-major grouped arrays, as numpy.

    Layout: group ``g`` covers rows ``[g*G, min((g+1)*G, N))``; its data is a
    dense ``(K_g, G)`` tile flattened into ``values``/``columns`` starting at
    ``group_pointers[g]``, where element ``(slot, r)`` sits at
    ``group_pointers[g] + slot*G + r``.  ``K_g`` = max row length in the
    group, rounded up to ``slot_pad`` (the paper pads to the max row length
    only — the extra pad is accounted as artificial zeros too).  The last
    group is padded to a full ``G`` rows.  Padding has value 0, column 0
    (the paper's "ghost index") and, in ``row_of_element``, the row of its
    lane — or the group's first row for lanes past the last row.
    """
    n_rows = c.shape[0]
    g_size = int(group_size)
    n_groups = max(1, -(-n_rows // g_size))
    lens = np.zeros(n_groups * g_size, dtype=np.int64)
    lens[:n_rows] = c.row_lens
    k_g = np.maximum(lens.reshape(n_groups, g_size).max(axis=1), 1)
    if slot_pad > 1:
        k_g = -(-k_g // slot_pad) * slot_pad
    group_ptr = np.zeros(n_groups + 1, dtype=np.int64)
    np.cumsum(k_g * g_size, out=group_ptr[1:])

    total = int(group_ptr[-1])
    values = np.zeros(total, dtype=c.values.dtype)
    columns = np.zeros(total, dtype=np.int32)
    idx = group_ptr[c.rows // g_size] + c.slot * g_size + c.rows % g_size
    values[idx] = c.values
    columns[idx] = c.columns
    lane_row = np.arange(n_groups * g_size, dtype=np.int64)
    lane_row = np.where(lane_row < n_rows, lane_row,
                        lane_row // g_size * g_size)
    row_of_element = np.repeat(lane_row.reshape(n_groups, g_size), k_g,
                               axis=0).reshape(-1).astype(np.int32)
    return dict(
        values=values,
        columns=columns,
        group_pointers=group_ptr.astype(np.int32),
        row_lengths=c.row_lens.astype(np.int32),
        slots_per_group=k_g.astype(np.int32),
        row_of_element=row_of_element,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class RgCSR(_Format):
    """Row-grouped CSR — the paper's contribution (§3.4, Fig. 5).

    ``values``/``columns``: flat slot-major grouped storage.
    ``group_pointers``:     offset of each group (paper's groupPointers).
    ``row_lengths``:        true entries per row (paper's rowLengths — the
                            delta vs sliced ELLPACK).
    ``slots_per_group``:    K_g per group (derivable from group_pointers;
                            kept for the plan's step table).
    ``row_of_element``:     derived row index per stored element — used only
                            by the segment-sum oracle, excluded from storage
                            accounting (a CUDA thread derives it from its id).
    """

    values: Any = _arr()
    columns: Any = _arr()
    group_pointers: Any = _arr()
    row_lengths: Any = _arr()
    slots_per_group: Any = _arr()
    row_of_element: Any = _arr()
    shape: Tuple[int, int] = _static()
    group_size: int = _static()
    slot_pad: int = _static()

    name: ClassVar[str] = "rgcsr"

    @classmethod
    def from_csr(cls, values, columns, row_ptr, shape, *,
                 group_size: int = DEFAULT_GROUP_SIZE,
                 slot_pad: int = DEFAULT_SLOT_PAD, device="cuda") -> "RgCSR":
        dev = resolve_device(device)
        c = _canonical_csr(values, columns, row_ptr, shape)
        arrs = _rgcsr_arrays(c, group_size, slot_pad)
        return cls(**{k: _tensor(v, dev) for k, v in arrs.items()},
                   shape=c.shape, group_size=int(group_size),
                   slot_pad=int(slot_pad))

    @property
    def n_groups(self) -> int:
        return int(self.slots_per_group.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.row_lengths.sum())

    @property
    def stored_elements(self) -> int:
        return int(self.values.shape[0])

    def fill_ratio(self) -> float:
        """Paper's "artificial zeros" metric: pad/nnz as a percentage.
        100% = as many artificial zeros as true nonzeros."""
        nnz = self.nnz
        if nnz == 0:
            return 0.0
        return 100.0 * (self.stored_elements - nnz) / nnz

    def storage_bytes(self) -> int:
        itemsize = self.values.element_size()
        n_rows = self.shape[0]
        return (self.stored_elements * (itemsize + 4)
                + (self.n_groups + 1) * 4 + n_rows * 4)

    def to_dense(self) -> np.ndarray:
        vals = _host(self.values)
        out = np.zeros(self.shape, dtype=vals.dtype)
        mask = vals != 0
        np.add.at(out, (_host(self.row_of_element)[mask],
                        _host(self.columns)[mask]), vals[mask])
        return out

    def csr_positions(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(flat, row_ptr)``: where CSR entry ``i`` sits in ``values``.

        Positional: row ``r`` owns slots ``[0, row_lengths[r])`` of its lane,
        i.e. flat indices ``group_pointers[r // G] + slot·G + (r % G)``.
        Selecting by stored value (``!= 0``) would misalign every later row
        if a true element equals 0.0, so positions define membership.
        """
        g = self.group_size
        row_lens = _host(self.row_lengths).astype(np.int64)
        gp = _host(self.group_pointers).astype(np.int64)
        row_ptr = np.concatenate([[0], np.cumsum(row_lens)])
        rows = np.repeat(np.arange(len(row_lens), dtype=np.int64), row_lens)
        slot = np.arange(int(row_ptr[-1]), dtype=np.int64) - np.repeat(
            row_ptr[:-1], row_lens)
        return gp[rows // g] + slot * g + (rows % g), row_ptr

    def to_csr_arrays(self):
        """Host CSR triplet ``(values, columns, row_ptr)`` recovered from the
        grouped slot-major storage — no densification (see
        :meth:`csr_positions`)."""
        flat, row_ptr = self.csr_positions()
        return _host(self.values)[flat], _host(self.columns)[flat], row_ptr


@dataclasses.dataclass(frozen=True, eq=False)
class SlicedEllpack(_Format):
    """Sliced ELLPACK [Monakov et al. 2010] (paper §3.4): same grouped
    slot-major layout as RgCSR but WITHOUT ``row_lengths`` — every row in a
    group performs K_g multiply-adds including the padding (the paper's
    "meaningless arithmetic").  Storage equals RgCSR minus the rowLengths
    array; compute is modeled accordingly in :mod:`repro_torch.core.analyze`."""

    values: Any = _arr()
    columns: Any = _arr()
    group_pointers: Any = _arr()
    slots_per_group: Any = _arr()
    row_of_element: Any = _arr()
    shape: Tuple[int, int] = _static()
    group_size: int = _static()
    slot_pad: int = _static()

    name: ClassVar[str] = "sliced_ellpack"

    @classmethod
    def from_csr(cls, values, columns, row_ptr, shape, *,
                 group_size: int = DEFAULT_GROUP_SIZE,
                 slot_pad: int = DEFAULT_SLOT_PAD,
                 device="cuda") -> "SlicedEllpack":
        dev = resolve_device(device)
        c = _canonical_csr(values, columns, row_ptr, shape)
        arrs = _rgcsr_arrays(c, group_size, slot_pad)
        del arrs["row_lengths"]
        return cls(**{k: _tensor(v, dev) for k, v in arrs.items()},
                   shape=c.shape, group_size=int(group_size),
                   slot_pad=int(slot_pad))

    @property
    def nnz(self) -> int:
        return int((self.values != 0).sum())

    @property
    def stored_elements(self) -> int:
        return int(self.values.shape[0])

    def storage_bytes(self) -> int:
        itemsize = self.values.element_size()
        n_groups = int(self.slots_per_group.shape[0])
        return self.stored_elements * (itemsize + 4) + (n_groups + 1) * 4

    def to_dense(self) -> np.ndarray:
        vals = _host(self.values)
        out = np.zeros(self.shape, dtype=vals.dtype)
        mask = vals != 0
        np.add.at(out, (_host(self.row_of_element)[mask],
                        _host(self.columns)[mask]), vals[mask])
        return out


# ---------------------------------------------------------------------------
# Row-sharded RgCSR — one RgCSR per shard (multi-device SpMV)
# ---------------------------------------------------------------------------


def split_columns(values, columns, row_ptr, lo: int, hi: int):
    """A CSR block's entries split by column: those in ``[lo, hi)`` as a
    CSR ``(values, columns - lo, row_ptr)`` over the same rows, the others
    as ``(values, rows, columns)`` with their global columns."""
    values, columns = np.asarray(values), np.asarray(columns)
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    n = len(row_ptr) - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(row_ptr))
    keep = (columns >= lo) & (columns < hi)
    ptr = np.concatenate([[0], np.cumsum(np.bincount(rows[keep],
                                                     minlength=n))])
    return ((values[keep], columns[keep] - lo, ptr),
            (values[~keep], rows[~keep], columns[~keep]))


def shard_csr_blocks(values, columns, row_ptr, shape, n_shards: int, *,
                     x_mode: str = "replicated") -> list:
    """Each shard's CSR row block under :meth:`ShardedRgCSR.shard_layout`,
    as ``(values, columns, row_ptr, shape)`` over ``rows_per_shard`` rows
    (the rows past the matrix empty), columns sorted within each row, with
    no dense matrix.  In ``x_mode='split'`` a block keeps only the entries
    of the shard's own column slice (:func:`split_columns`), shifted to
    start at 0, width ``cols_per_shard``.
    """
    if x_mode not in ("replicated", "split"):
        raise ValueError(
            f"x_mode must be 'replicated' or 'split', got {x_mode!r}")
    c = _canonical_csr(values, columns, row_ptr, shape)
    n_rows, n_cols = c.shape
    rps, cstride = ShardedRgCSR.shard_layout(n_rows, n_cols, n_shards)
    out = []
    for d in range(n_shards):
        lo, hi = d * rps, min((d + 1) * rps, n_rows)
        p0, p1 = (int(c.row_ptr[lo]), int(c.row_ptr[hi])) if hi > lo \
            else (0, 0)
        ptr = np.full(rps + 1, p1 - p0, dtype=np.int64)
        if hi > lo:
            ptr[: hi - lo + 1] = c.row_ptr[lo: hi + 1] - p0
        vals, cols = c.values[p0:p1], c.columns[p0:p1]
        if x_mode == "split":
            clo = d * cstride
            (vals, cols, ptr), _ = split_columns(
                vals, cols, ptr, clo, min(clo + cstride, n_cols))
            out.append((vals, cols, ptr, (rps, cstride)))
        else:
            out.append((vals, cols, ptr, (rps, n_cols)))
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedRgCSR:
    """RgCSR partitioned by rows over a 1-D mesh axis (DESIGN.md §11).

    Shard ``d`` owns the contiguous row block ``[d·rows_per_shard,
    (d+1)·rows_per_shard)`` and stores it as its own :class:`RgCSR`, so
    block/adaptive grouping, slot padding and the step table all apply per
    shard.  Columns keep their **global** indices here; the local / remote
    split (columns owned by this shard vs. columns whose x entries must be
    exchanged) is computed at plan time
    (:func:`repro_torch.kernels.ops.make_sharded_plan`), because it depends
    on the execution mode.

    Every shard is built over exactly ``rows_per_shard`` rows (the trailing
    shard is padded with empty rows), so all shards have the same group
    count.
    """

    shards: Tuple[RgCSR, ...] = _arr()
    shape: Tuple[int, int] = _static()
    n_shards: int = _static()
    rows_per_shard: int = _static()
    group_size: int = _static()
    slot_pad: int = _static()

    name: ClassVar[str] = "sharded_rgcsr"

    @staticmethod
    def shard_layout(n_rows: int, n_cols: int,
                     n_shards: int) -> Tuple[int, int]:
        """``(rows_per_shard, cols_per_shard)`` ceil-div layout.

        The single source of the shard geometry: the row blocks
        (:func:`shard_csr_blocks`), the local/remote column split
        (:func:`split_columns`), plan
        construction (``ops.make_sharded_plan``) and per-shard tuning
        (``autotune.shard_row_blocks``) all derive from it.
        """
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        return (max(1, -(-n_rows // n_shards)),
                max(1, -(-n_cols // n_shards)))

    @classmethod
    def from_csr(cls, values, columns, row_ptr, shape, n_shards: int, *,
                 group_size: int = DEFAULT_GROUP_SIZE,
                 slot_pad: int = DEFAULT_SLOT_PAD,
                 device="cuda") -> "ShardedRgCSR":
        """Each shard from its CSR row block (:func:`shard_csr_blocks`),
        padded to ``rows_per_shard`` rows: no dense matrix and no per-row
        Python loop."""
        shards = tuple(
            RgCSR.from_csr(*block, group_size=group_size, slot_pad=slot_pad,
                           device=device)
            for block in shard_csr_blocks(values, columns, row_ptr, shape,
                                          n_shards))
        rps, _ = cls.shard_layout(int(shape[0]), int(shape[1]), n_shards)
        return cls(shards=shards, shape=(int(shape[0]), int(shape[1])),
                   n_shards=int(n_shards), rows_per_shard=rps,
                   group_size=int(group_size), slot_pad=int(slot_pad))

    @classmethod
    def from_dense(cls, dense: np.ndarray, n_shards: int, *,
                   group_size: int = DEFAULT_GROUP_SIZE,
                   slot_pad: int = DEFAULT_SLOT_PAD,
                   device="cuda") -> "ShardedRgCSR":
        dense = _as_2d(dense)
        values, cols, _, row_ptr = _csr_arrays(dense)
        return cls.from_csr(values, cols, row_ptr, dense.shape, n_shards,
                            group_size=group_size, slot_pad=slot_pad,
                            device=device)

    @property
    def nnz(self) -> int:
        return sum(s.nnz for s in self.shards)

    @property
    def stored_elements(self) -> int:
        return sum(s.stored_elements for s in self.shards)

    def storage_bytes(self) -> int:
        return sum(s.storage_bytes() for s in self.shards)

    def shard_rows(self, d: int) -> Tuple[int, int]:
        """(lo, hi) global row range truly owned by shard ``d`` (unpadded;
        ``hi <= lo`` for a shard past the last row)."""
        lo = d * self.rows_per_shard
        return lo, min(lo + self.rows_per_shard, self.shape[0])

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=_host(self.shards[0].values).dtype)
        for d, s in enumerate(self.shards):
            lo, hi = self.shard_rows(d)
            if hi > lo:
                out[lo:hi] = s.to_dense()[: hi - lo]
        return out


FORMATS = {
    "csr": CSR,
    "coo": COO,
    "ellpack": ELLPACK,
    "hybrid": HybridEllCoo,
    "blocked_csr": BlockedCSR,
    "sliced_ellpack": SlicedEllpack,
    "rgcsr": RgCSR,
}


def _format_class(fmt: str):
    try:
        return FORMATS[fmt]
    except KeyError:
        raise ValueError(f"unknown format {fmt!r}; options: {sorted(FORMATS)}")


def from_dense(dense: np.ndarray, fmt: str = "rgcsr", **kwargs):
    """Build any of the paper's formats from a dense matrix."""
    return _format_class(fmt).from_dense(dense, **kwargs)


def from_csr(values, columns, row_ptr, shape, fmt: str = "rgcsr", **kwargs):
    """Build any of the paper's formats from CSR arrays (host, any order of
    columns within a row; explicit entries are kept)."""
    return _format_class(fmt).from_csr(values, columns, row_ptr, shape,
                                       **kwargs)


def from_numpy(fmt: str, fields: Dict[str, Any], *, device="cuda"):
    """A format from the fields of ``repro.core.formats``' dataclass of the
    same name, with every array field given as a numpy array.  For
    ``"sharded_rgcsr"``, ``shards`` holds each shard's RgCSR fields, as a
    mapping or as any object with those attributes."""
    if fmt == ShardedRgCSR.name:
        shards = tuple(
            from_numpy("rgcsr", sh if isinstance(sh, dict) else {
                f.name: (np.array(getattr(sh, f.name)) if f.metadata["array"]
                         else getattr(sh, f.name))
                for f in dataclasses.fields(RgCSR)}, device=device)
            for sh in fields["shards"])
        return ShardedRgCSR(
            shards=shards, shape=tuple(int(v) for v in fields["shape"]),
            **{k: int(fields[k]) for k in ("n_shards", "rows_per_shard",
                                            "group_size", "slot_pad")})
    cls = _format_class(fmt)
    dev = resolve_device(device)
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = fields[f.name]
        if f.metadata["array"]:
            kwargs[f.name] = _tensor(np.asarray(v), dev)
        elif f.name == "shape":
            kwargs[f.name] = tuple(int(s) for s in v)
        else:
            kwargs[f.name] = int(v)
    return cls(**kwargs)
