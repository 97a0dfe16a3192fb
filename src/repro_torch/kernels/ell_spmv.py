"""K3: ELLPACK SpMV — the CUDA kernel ``csrc/ell_spmv.cu``, its launcher and
its plain PyTorch version.

Replaces ``repro.kernels.ell_spmv.ell_spmv_kernel`` (the Pallas TPU kernel),
the ELL half of the paper's Hybrid comparison format.  On the H100 it is
bound by bytes (value + int32 column per stored slot, 2 flops); one thread
per row walks the slot-major ``(K_pad, N_pad)`` arrays, so every slot is one
coalesced read across neighbouring rows (see the CUDA source).  The COO tail
of Hybrid stays a PyTorch segment sum, as in the reference.

Each launch adds one to ``_build.launches["ell_spmv"]``; the plain
version, taken for CPU tensors, does not count.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SUBLANES = 8
LANES = 128

__all__ = ["ell_spmv_launch", "ell_spmv_plain"]

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64]
             + [ctypes.c_void_p])


def ell_spmv_plain(values2d, columns2d, x):
    """Plain PyTorch K3: ``y = Σ_k values[k] · x[columns[k]]`` in fp32."""
    prods = values2d.float() * x.float()[columns2d.long()]
    return prods.sum(dim=0).to(values2d.dtype)


def ell_spmv_launch(values2d, columns2d, x):
    """``(N_pad,)`` result of one ELL plan (``K_pad % 8 == 0``).

    CPU tensors run the plain version; CUDA tensors launch the kernel, or
    raise when it cannot take them.
    """
    tensors = (values2d, columns2d, x)
    dev = _build.cuda_device("ell_spmv", tensors)
    if dev is None:
        return ell_spmv_plain(values2d, columns2d, x)
    k_pad, n_pad = values2d.shape
    if (columns2d.shape != (k_pad, n_pad) or columns2d.dtype != torch.int32
            or k_pad % SUBLANES or x.dim() != 1):
        raise ValueError("ell_spmv: plan arrays do not match (values2d "
                         f"{tuple(values2d.shape)}, columns2d "
                         f"{tuple(columns2d.shape)} {columns2d.dtype})")
    y = torch.empty(n_pad, dtype=values2d.dtype, device=dev)
    fn = _build.function(
        "ell_spmv", _build.symbol("ell_spmv", values2d.dtype, x.dtype),
        _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(values2d.data_ptr(), columns2d.data_ptr(), x.data_ptr(),
                 y.data_ptr(), k_pad, n_pad, stream)
    _build.check(err, "ell_spmv")
    _build.launches["ell_spmv"] += 1
    return y
