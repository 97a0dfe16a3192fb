"""Segment-sum SpMV / SpMM oracles for every format, and the dispatch.

The PyTorch counterpart of ``repro.core.spmv``: the fourteen oracles are
vectorized gathers followed by ``index_add_`` segment sums, identical to
``A @ x`` up to floating-point reassociation.  They run on whatever device
the matrix lives on.  RgCSR matrices dispatch to the hand-written CUDA
kernels (:mod:`repro_torch.kernels`) through the process-wide plan cache
when their tensors are on a CUDA card.

On CUDA ``index_add_`` sums with atomics, so an oracle's result may differ
from run to run in the last bits; compare against it with a tolerance.
"""
from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F

from repro_torch.core.formats import (
    COO,
    CSR,
    ELLPACK,
    BlockedCSR,
    HybridEllCoo,
    RgCSR,
    SlicedEllpack,
)

Matrix = Union[CSR, COO, ELLPACK, HybridEllCoo, BlockedCSR, RgCSR,
               SlicedEllpack]

__all__ = ["spmv", "spmm"]


def _segment_sum(prods: torch.Tensor, row_ids: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    out = prods.new_zeros((n_rows,) + tuple(prods.shape[1:]))
    if n_rows == 0:       # padding rows point at row 0, which does not exist
        return out
    return out.index_add_(0, row_ids.long(), prods)


def _segment_matvec(values, columns, row_ids, x, n_rows):
    """y[r] = sum_{i: row_ids[i]==r} values[i] * x[columns[i]]."""
    return _segment_sum(values * x[columns.long()], row_ids, n_rows)


def _segment_matmat(values, columns, row_ids, x, n_rows):
    """Y[r, :] = sum values[i] * X[columns[i], :]."""
    return _segment_sum(x[columns.long()] * values[:, None], row_ids, n_rows)


# ---------------------------------------------------------------------------
# per-format spmv
# ---------------------------------------------------------------------------


def spmv_csr(a: CSR, x):
    return _segment_matvec(a.values, a.columns, a.row_ids, x, a.shape[0])


def spmv_coo(a: COO, x):
    return _segment_matvec(a.values, a.columns, a.rows, x, a.shape[0])


def spmv_ellpack(a: ELLPACK, x):
    # slot-major: y = sum_k values[k, :] * x[columns[k, :]]
    y = (a.values * x[a.columns.long()]).sum(dim=0)
    return y[: a.shape[0]]


def spmv_hybrid(a: HybridEllCoo, x):
    y = (a.ell_values * x[a.ell_columns.long()]).sum(dim=0)[: a.shape[0]]
    if a.coo_values.shape[0]:
        y = y + _segment_matvec(a.coo_values, a.coo_columns, a.coo_rows, x,
                                a.shape[0])
    return y


def spmv_blocked_csr(a: BlockedCSR, x):
    bs = a.block_size
    xb = F.pad(x, (0, (-a.shape[1]) % bs)).reshape(-1, bs)
    gathered = xb[a.block_columns.long()]                  # (n_blocks, bs)
    prods = torch.einsum("bij,bj->bi", a.values, gathered)
    nbr = a.block_row_pointers.shape[0] - 1
    yb = _segment_sum(prods, a.block_row_ids, nbr)
    return yb.reshape(-1)[: a.shape[0]]


def spmv_rgcsr(a: RgCSR, x):
    """Slot-major grouped SpMV.  Padding values are exact zeros, so summing
    them is a no-op — semantically identical to the paper's rowLengths
    early-exit (which saves *work*, not correctness)."""
    return _segment_matvec(a.values, a.columns, a.row_of_element, x,
                           a.shape[0])


def spmv_sliced_ellpack(a: SlicedEllpack, x):
    return _segment_matvec(a.values, a.columns, a.row_of_element, x,
                           a.shape[0])


# ---------------------------------------------------------------------------
# per-format spmm (A @ X, X dense (n, d)) — needed by SparseLinear
# ---------------------------------------------------------------------------


def spmm_csr(a: CSR, x):
    return _segment_matmat(a.values, a.columns, a.row_ids, x, a.shape[0])


def spmm_coo(a: COO, x):
    return _segment_matmat(a.values, a.columns, a.rows, x, a.shape[0])


def spmm_ellpack(a: ELLPACK, x):
    y = (a.values[..., None] * x[a.columns.long()]).sum(dim=0)
    return y[: a.shape[0]]


def spmm_hybrid(a: HybridEllCoo, x):
    y = (a.ell_values[..., None] * x[a.ell_columns.long()]).sum(
        dim=0)[: a.shape[0]]
    if a.coo_values.shape[0]:
        y = y + _segment_matmat(a.coo_values, a.coo_columns, a.coo_rows, x,
                                a.shape[0])
    return y


def spmm_blocked_csr(a: BlockedCSR, x):
    bs = a.block_size
    d = x.shape[1]
    xb = F.pad(x, (0, 0, 0, (-a.shape[1]) % bs)).reshape(-1, bs, d)
    gathered = xb[a.block_columns.long()]                 # (n_blocks, bs, d)
    prods = torch.einsum("bij,bjd->bid", a.values, gathered)
    nbr = a.block_row_pointers.shape[0] - 1
    yb = _segment_sum(prods, a.block_row_ids, nbr)
    return yb.reshape(-1, d)[: a.shape[0]]


def spmm_rgcsr(a: RgCSR, x):
    return _segment_matmat(a.values, a.columns, a.row_of_element, x,
                           a.shape[0])


def spmm_sliced_ellpack(a: SlicedEllpack, x):
    return _segment_matmat(a.values, a.columns, a.row_of_element, x,
                           a.shape[0])


_SPMV = {
    CSR: spmv_csr,
    COO: spmv_coo,
    ELLPACK: spmv_ellpack,
    HybridEllCoo: spmv_hybrid,
    BlockedCSR: spmv_blocked_csr,
    RgCSR: spmv_rgcsr,
    SlicedEllpack: spmv_sliced_ellpack,
}

_SPMM = {
    CSR: spmm_csr,
    COO: spmm_coo,
    ELLPACK: spmm_ellpack,
    HybridEllCoo: spmm_hybrid,
    BlockedCSR: spmm_blocked_csr,
    RgCSR: spmm_rgcsr,
    SlicedEllpack: spmm_sliced_ellpack,
}


def _use_kernel(a, impl: str) -> bool:
    """Kernel dispatch policy.

    ``impl='ref'`` — always the oracle.  ``impl='kernel'`` — the kernel via
    the process-wide PlanCache (its plain PyTorch version for CPU tensors).
    ``impl='auto'`` — the kernel for matrices on a CUDA card, the oracle for
    CPU matrices.  On the card ``make_plan`` raises outside the kernels'
    domain (group_size a multiple of 128 rows, slots padded to multiples of
    8), so a CUDA matrix never quietly runs the oracle instead.
    """
    if impl not in ("auto", "ref", "kernel"):   # validate unconditionally,
        raise ValueError(                        # even on oracle-only paths
            f"unknown impl {impl!r}; options: auto/ref/kernel")
    if impl == "ref" or not isinstance(a, RgCSR):
        return False
    return impl == "kernel" or a.values.is_cuda


def spmv(a: Matrix, x, *, impl: str = "auto", chunks_per_step: int = 1,
         ordering: str = "block", spill_threshold: int = 0):
    """``y = A @ x`` for any of the paper's formats.

    RgCSR matrices can dispatch to the kernel through the process-wide
    :data:`repro_torch.kernels.ops.PLAN_CACHE` (see ``impl`` in
    :func:`_use_kernel`), so repeated SpMV on the same matrix — the
    iterative-solver pattern — builds its execution plan exactly once.

    ``ordering='adaptive'`` selects the length-aware regrouped plan (and,
    with ``spill_threshold > 0``, the pathological-row COO spill); results
    are identical up to fp reassociation.  Oracle paths ignore both knobs.
    """
    if _use_kernel(a, impl):
        from repro_torch.kernels import ops as kops
        plan = kops.get_plan(a, chunks_per_step=chunks_per_step,
                             ordering=ordering,
                             spill_threshold=spill_threshold)
        return kops.rgcsr_spmv(plan, x)
    return _SPMV[type(a)](a, x)


def spmm(a: Matrix, x, *, impl: str = "auto", chunks_per_step: int = 1,
         ordering: str = "block", spill_threshold: int = 0):
    """``Y = A @ X`` (X dense ``(n, d)``) for any of the paper's formats,
    with the same PlanCache-backed kernel dispatch as :func:`spmv`."""
    if _use_kernel(a, impl):
        from repro_torch.kernels import ops as kops
        plan = kops.get_plan(a, chunks_per_step=chunks_per_step,
                             ordering=ordering,
                             spill_threshold=spill_threshold)
        return kops.rgcsr_spmm(plan, x)
    return _SPMM[type(a)](a, x)
