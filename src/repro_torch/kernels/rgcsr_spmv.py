"""K1: RgCSR SpMV — the CUDA kernel ``csrc/rgcsr_spmv.cu``, its launcher and
its plain PyTorch version.

Replaces ``repro.kernels.rgcsr_spmv.rgcsr_spmv_kernel`` (the Pallas TPU
kernel).  On the H100 the kernel is bound by bytes: every stored slot is read
once (value + int32 column) for 2 flops.  Its design (one CTA per group, one
thread per row, coalesced slot-major reads, x through the read-only cache,
an in-order fp32 sum per row) is described in the CUDA source.

The Pallas kernel walks a step table in grid order and accumulates across
steps; GPU blocks run in no order, so each CTA instead walks its own group's
steps, found through the plan's ``group_step_ptr``.  The plain version below
walks the reference's ``step_group`` table instead, so comparing the two
also checks the derived pointer.

Each launch adds one to ``_build.launches["rgcsr_spmv"]``; the plain
version, taken for CPU tensors, does not count.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SUBLANES = 8
LANES = 128

# Candidate coarsening factors: how many 8-slot chunks one step covers.
CHUNKS_PER_STEP_CHOICES = (1, 2, 4, 8)

__all__ = ["rgcsr_spmv_launch", "rgcsr_spmv_plain",
           "CHUNKS_PER_STEP_CHOICES", "SUBLANES", "LANES"]

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def rgcsr_spmv_plain(values2d, columns2d, step_group, x, *,
                     n_groups: int, chunks_per_step: int = 1):
    """Plain PyTorch K1: slot row ``i`` belongs to step ``i // R``, which
    belongs to group ``step_group[i // R]``; the group's output row is the
    fp32 segment sum of ``values · x[columns]`` over its slot rows."""
    rows_per_step = chunks_per_step * SUBLANES
    g = values2d.shape[1]
    slot_group = step_group.long().repeat_interleave(rows_per_step)
    prods = values2d.float() * x.float()[columns2d.long()]
    y = torch.zeros((n_groups, g), dtype=torch.float32,
                    device=values2d.device)
    return y.index_add_(0, slot_group, prods).to(values2d.dtype)


def rgcsr_spmv_launch(values2d, columns2d, step_group, group_step_ptr, x,
                      *, chunks_per_step: int = 1):
    """``(n_groups, G)`` per-group result rows of one RgCSR plan.

    CPU tensors run the plain version; CUDA tensors launch the kernel, or
    raise when it cannot take them.
    """
    n_groups = group_step_ptr.shape[0] - 1
    tensors = (values2d, columns2d, step_group, group_step_ptr, x)
    dev = _build.cuda_device("rgcsr_spmv", tensors)
    if dev is None:
        return rgcsr_spmv_plain(values2d, columns2d, step_group, x,
                                n_groups=n_groups,
                                chunks_per_step=chunks_per_step)
    rows_per_step = chunks_per_step * SUBLANES
    s, g = values2d.shape
    if (columns2d.shape != (s, g) or columns2d.dtype != torch.int32
            or group_step_ptr.dtype != torch.int32 or x.dim() != 1
            or s != step_group.shape[0] * rows_per_step):
        raise ValueError("rgcsr_spmv: plan arrays do not match "
                         f"(values2d {tuple(values2d.shape)}, columns2d "
                         f"{tuple(columns2d.shape)} {columns2d.dtype}, "
                         f"{step_group.shape[0]} steps of {rows_per_step})")
    y = torch.empty((n_groups, g), dtype=values2d.dtype, device=dev)
    symbol = _build.symbol("rgcsr_spmv", values2d.dtype, x.dtype)
    fn = _build.function("rgcsr_spmv", symbol, _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(values2d.data_ptr(), columns2d.data_ptr(),
                 group_step_ptr.data_ptr(), x.data_ptr(), y.data_ptr(),
                 n_groups, g, rows_per_step, stream)
    _build.check(err, "rgcsr_spmv")
    _build.launches["rgcsr_spmv"] += 1
    return y
