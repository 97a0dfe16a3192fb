"""K3: ELLPACK SpMV — the CUDA kernel ``csrc/ell_spmv.cu``, its launcher and
its plain PyTorch version.

Replaces ``repro.kernels.ell_spmv.ell_spmv_kernel`` (the Pallas TPU kernel),
the ELL half of the paper's Hybrid comparison format.  On the H100 it is
bound by bytes (value + int32 column per slot read, 2 flops).  The plan's
arrays are padded to ``K_pad``, a multiple of 8, for the TPU's ``(8, 128)``
tile; the kernel reads only the live slots: each warp walks 128 consecutive
rows, each thread four of them with 16-byte column loads, and stops each
32-row segment after the plan's ``seg_slots`` count of it (see the CUDA
source).  The skipped slots are value 0 at column 0, so the result differs
from the TPU kernel's only where ``x[0]`` is not finite.  The COO tail of
Hybrid stays a PyTorch segment sum, as in the reference.

The launcher takes the plan (``ops.EllPlan``, or one with its values cast)
and reads the counts the plan derived once; it never derives them during a
call, and never reads every slot instead.  The plain version reads every
slot, so comparing the two also checks the counts.

Each launch adds one to ``_build.launches["ell_spmv"]``; the plain
version, taken for CPU tensors, does not count.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SUBLANES = 8
LANES = 128
# Rows of one warp's segment, the unit of the plan's seg_slots.
SEGMENT = 32
# The kernel's 16-byte loads need this alignment of every array it reads.
ALIGN = 16

__all__ = ["ell_spmv_launch", "ell_spmv_plain"]

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_void_p]


def ell_spmv_plain(values2d, columns2d, x):
    """Plain PyTorch K3: ``y = Σ_k values[k] · x[columns[k]]`` in fp32."""
    prods = values2d.float() * x.float()[columns2d.long()]
    return prods.sum(dim=0).to(values2d.dtype)


def _check(plan, x) -> None:
    vals, cols, seg = plan.values2d, plan.columns2d, plan.seg_slots
    k_pad, n_pad = vals.shape
    if (cols.shape != (k_pad, n_pad) or cols.dtype != torch.int32
            or k_pad % SUBLANES or n_pad % LANES or x.dim() != 1):
        raise ValueError("ell_spmv: plan arrays do not match (values2d "
                         f"{tuple(vals.shape)}, columns2d "
                         f"{tuple(cols.shape)} {cols.dtype}, x "
                         f"{tuple(x.shape)})")
    if seg.dtype != torch.int32 or tuple(seg.shape) != (n_pad // SEGMENT,):
        raise ValueError(f"ell_spmv: seg_slots must be ({n_pad // SEGMENT},)"
                         f" int32, one count per {SEGMENT} rows; got "
                         f"{tuple(seg.shape)} {seg.dtype}")


def ell_spmv_launch(plan, x):
    """``(N_pad,)`` result of ``plan`` (an ``ops.EllPlan``) times ``x``.

    CPU tensors run the plain version; CUDA tensors launch the kernel, or
    raise when it cannot take them.
    """
    _check(plan, x)
    vals, cols, seg = plan.values2d, plan.columns2d, plan.seg_slots
    dev = _build.cuda_device("ell_spmv", (vals, cols, seg, x))
    if dev is None:
        return ell_spmv_plain(vals, cols, x)
    if vals.data_ptr() % ALIGN or cols.data_ptr() % ALIGN:
        raise ValueError(f"ell_spmv: values2d and columns2d must start on "
                         f"{ALIGN}-byte boundaries")
    y = torch.empty(vals.shape[1], dtype=vals.dtype, device=dev)
    fn = _build.function(
        "ell_spmv", _build.symbol("ell_spmv", vals.dtype, x.dtype),
        _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(vals.data_ptr(), cols.data_ptr(), seg.data_ptr(),
                 x.data_ptr(), y.data_ptr(), vals.shape[1], stream)
    _build.check(err, "ell_spmv")
    _build.launches["ell_spmv"] += 1
    return y
