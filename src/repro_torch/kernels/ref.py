"""Oracles for the kernels.

These re-export the segment-sum SpMV/SpMM from :mod:`repro_torch.core.spmv`
— the kernels must match them to float tolerance on every shape/dtype sweep.
Keeping the oracle in core/ means every caller exercises the *same*
semantics the kernels are validated against.
"""
from __future__ import annotations

from repro_torch.core.spmv import (  # noqa: F401
    spmv as spmv_ref,
    spmm as spmm_ref,
    spmv_csr,
    spmv_coo,
    spmv_ellpack,
    spmv_hybrid,
    spmv_blocked_csr,
    spmv_rgcsr,
    spmv_sliced_ellpack,
    spmm_rgcsr,
    spmm_ellpack,
)

__all__ = [
    "spmv_ref", "spmm_ref",
    "spmv_csr", "spmv_coo", "spmv_ellpack", "spmv_hybrid",
    "spmv_blocked_csr", "spmv_rgcsr", "spmv_sliced_ellpack",
    "spmm_rgcsr", "spmm_ellpack",
]
