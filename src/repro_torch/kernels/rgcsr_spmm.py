"""K2: RgCSR SpMM — the CUDA kernel ``csrc/rgcsr_spmm.cu``, its launcher and
its plain PyTorch version.

Replaces ``repro.kernels.rgcsr_spmm.rgcsr_spmm_kernel`` (the Pallas TPU
kernel), the kernel behind the pruned-weight ``SparseLinear`` layer.  On the
H100 it is bound by bytes: per stored slot it gathers one d-wide row of X
for 2·d flops.  One CTA per (group, d-chunk); lanes run along d so X row
reads and Y row writes are coalesced; each pass stages eight slot rows of
the group in shared memory; sums are fp32 in slot order (see the CUDA
source).  The chunk is ``d_tile`` columns, capped at 128 and at ``d``
rounded up to 32; the kernel masks the d edge, so X is not padded.

Each launch adds one to ``_build.launches["rgcsr_spmm"]``; the plain
version, taken for CPU tensors, does not count.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SUBLANES = 8
LANES = 128
# Widest d-chunk of one CTA: 32 lanes × up to 4 columns each.
MAX_D_CHUNK = 128

__all__ = ["rgcsr_spmm_launch", "rgcsr_spmm_plain"]

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

# Gathered X elements one plain-version pass holds, to bound its memory.
_PLAIN_CHUNK_ELEMS = 1 << 24


def rgcsr_spmm_plain(values2d, columns2d, step_group, x, *,
                     n_groups: int, chunks_per_step: int = 1):
    """Plain PyTorch K2: ``(n_groups·G, d)`` fp32 segment sums of
    ``values[k, lane] · X[columns[k, lane]]`` into row
    ``step_group[k // R]·G + lane``, taken over slot rows in passes."""
    rows_per_step = chunks_per_step * SUBLANES
    s, g = values2d.shape
    d = x.shape[1]
    slot_group = step_group.long().repeat_interleave(rows_per_step)
    lanes = torch.arange(g, device=values2d.device)
    xf = x.float()
    out = torch.zeros((n_groups * g, d), dtype=torch.float32,
                      device=values2d.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(g * d, 1))
    for a in range(0, s, step):
        b = min(s, a + step)
        prods = xf[columns2d[a:b].long()] * values2d[a:b].float()[..., None]
        rows = (slot_group[a:b, None] * g + lanes).reshape(-1)
        out.index_add_(0, rows, prods.reshape(-1, d))
    return out.to(values2d.dtype)


def rgcsr_spmm_launch(values2d, columns2d, step_group, group_step_ptr, x, *,
                      chunks_per_step: int = 1, d_tile: int = LANES):
    """``(n_groups·G, d)`` result rows of one RgCSR plan times ``x``.

    CPU tensors run the plain version; CUDA tensors launch the kernel, or
    raise when it cannot take them.
    """
    n_groups = group_step_ptr.shape[0] - 1
    tensors = (values2d, columns2d, step_group, group_step_ptr, x)
    dev = _build.cuda_device("rgcsr_spmm", tensors)
    if dev is None:
        return rgcsr_spmm_plain(values2d, columns2d, step_group, x,
                                n_groups=n_groups,
                                chunks_per_step=chunks_per_step)
    rows_per_step = chunks_per_step * SUBLANES
    s, g = values2d.shape
    if (columns2d.shape != (s, g) or columns2d.dtype != torch.int32
            or group_step_ptr.dtype != torch.int32 or x.dim() != 2
            or g % LANES or s != step_group.shape[0] * rows_per_step):
        raise ValueError("rgcsr_spmm: plan arrays do not match "
                         f"(values2d {tuple(values2d.shape)}, columns2d "
                         f"{tuple(columns2d.shape)} {columns2d.dtype}, "
                         f"{step_group.shape[0]} steps of {rows_per_step})")
    if d_tile < 32 or d_tile % 32:
        raise ValueError(f"rgcsr_spmm: d_tile must be a multiple of 32, "
                         f"got {d_tile}")
    d = x.shape[1]
    d_chunk = min(d_tile, MAX_D_CHUNK, -(-max(d, 1) // 32) * 32)
    y = torch.empty((n_groups * g, d), dtype=values2d.dtype, device=dev)
    fn = _build.function(
        "rgcsr_spmm", _build.symbol("rgcsr_spmm", values2d.dtype, x.dtype),
        _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(values2d.data_ptr(), columns2d.data_ptr(),
                 group_step_ptr.data_ptr(), x.data_ptr(), y.data_ptr(),
                 n_groups, g, rows_per_step, d, d_chunk // 32, stream)
    _build.check(err, "rgcsr_spmm")
    _build.launches["rgcsr_spmm"] += 1
    return y
