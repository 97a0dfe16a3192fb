"""Format analytics: fill, byte models, modeled throughput (paper Table 1).

The paper's peak-performance model (§3.4): per nonzero, an SpMV step reads one
int32 column index + one value + one x element; with a perfectly effective
cache for x, the x read is free.  GFLOPS = 2·nnz / (bytes / bandwidth).

We generalize to any format via ``storage_bytes()`` (which includes the
format's pointer/padding overhead — exactly what the paper identifies as the
thing formats must minimize) and provide the paper's GTX280 numbers, the TPU
v5e constants of the JAX package, and the H100 the port runs on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

__all__ = [
    "HardwareModel",
    "GTX280",
    "TPU_V5E",
    "H100_SXM",
    "row_stats",
    "format_report",
    "modeled_gflops",
    "peak_model_gflops",
]


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    name: str
    mem_bandwidth_gbs: float     # HBM / global-memory bandwidth
    peak_flops_tf32: float       # peak dense single-precision TFLOPS
    x_cache_bytes: int           # texture cache (GPU) / VMEM (TPU) for x

# The paper's card (§2, §4.1).
GTX280 = HardwareModel(name="gtx280", mem_bandwidth_gbs=141.0,
                       peak_flops_tf32=1.0, x_cache_bytes=16 * 1024)
# Our target chip (system-prompt constants: 197 TF bf16, 819 GB/s HBM).
TPU_V5E = HardwareModel(name="tpu_v5e", mem_bandwidth_gbs=819.0,
                        peak_flops_tf32=197.0, x_cache_bytes=16 * 2 ** 20)
# The port's card (NVIDIA data sheet, SXM part at 700 W): 3.35 TB/s HBM3,
# 495 TFLOP/s dense TF32; the 50 MB L2 plays the texture cache's role for x.
H100_SXM = HardwareModel(name="h100_sxm", mem_bandwidth_gbs=3350.0,
                         peak_flops_tf32=495.0, x_cache_bytes=50 * 2 ** 20)


def row_stats(dense: np.ndarray) -> Dict[str, float]:
    """max/mean/min nonzeros per row — the paper's Table 6 characterization."""
    row_lens = (np.asarray(dense) != 0).sum(axis=1)
    return {
        "rows": int(dense.shape[0]),
        "nnz": int(row_lens.sum()),
        "row_nnz_max": int(row_lens.max()) if len(row_lens) else 0,
        "row_nnz_mean": float(row_lens.mean()) if len(row_lens) else 0.0,
        "row_nnz_min": int(row_lens.min()) if len(row_lens) else 0,
        "row_nnz_std": float(row_lens.std()) if len(row_lens) else 0.0,
        "density_pct": 100.0 * row_lens.sum() / max(1, dense.shape[0] * dense.shape[1]),
    }


def modeled_gflops(matrix: Any, hw: HardwareModel = TPU_V5E,
                   x_cached: bool = True, dtype_bytes: int = 4,
                   n_cols: int | None = None) -> float:
    """Bandwidth-roofline GFLOPS for one SpMV with this stored format.

    bytes = format storage traffic (+ x traffic if not cached) + y writeback.
    flops = 2·nnz.  This is the paper's §3.4 estimate generalized: for common
    CSR with one value+one index per nonzero it reduces to m/12 (sp,
    uncached → plus 8B x read = 12B per nonzero with 4B index... the paper
    counts 12B = 4B idx + 4B val + 4B x for sp) and m/8 cached.
    """
    nnz = matrix.nnz
    if nnz == 0:
        return 0.0
    n_cols = n_cols if n_cols is not None else matrix.shape[1]
    traffic = matrix.storage_bytes()
    if x_cached:
        traffic += n_cols * dtype_bytes          # x streamed exactly once
    else:
        traffic += matrix.stored_elements * dtype_bytes  # one x read per stored element
    traffic += matrix.shape[0] * dtype_bytes     # y writeback
    seconds = traffic / (hw.mem_bandwidth_gbs * 1e9)
    return 2.0 * nnz / seconds / 1e9


def peak_model_gflops(hw: HardwareModel, dtype_bytes: int, x_cached: bool) -> float:
    """The paper's Table 1 closed form: m/(idx+val[+x]) GFLOPS."""
    per_elem = 4 + dtype_bytes + (0 if x_cached else dtype_bytes)
    return 2.0 * hw.mem_bandwidth_gbs / per_elem


def format_report(matrix: Any, hw: HardwareModel = TPU_V5E,
                  dtype_bytes: int = 4) -> Dict[str, float]:
    nnz = matrix.nnz
    stored = matrix.stored_elements
    fill = 100.0 * (stored - nnz) / max(1, nnz)
    return {
        "format": type(matrix).name,
        "nnz": nnz,
        "stored_elements": stored,
        "artificial_zeros_pct": fill,
        "storage_bytes": matrix.storage_bytes(),
        "gflops_cached": modeled_gflops(matrix, hw, True, dtype_bytes),
        "gflops_uncached": modeled_gflops(matrix, hw, False, dtype_bytes),
    }
