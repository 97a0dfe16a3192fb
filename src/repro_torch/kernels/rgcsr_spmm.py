"""K2: RgCSR SpMM — the CUDA kernel ``csrc/rgcsr_spmm.cu``, its launcher and
its plain PyTorch version.

Replaces ``repro.kernels.rgcsr_spmm.rgcsr_spmm_kernel`` (the Pallas TPU
kernel), the kernel behind the pruned-weight ``SparseLinear`` layer.  On the
H100 it is bound by bytes: per live slot it gathers one d-wide row of X for
2·d flops.  Its design, set out in the CUDA source:

- long groups are split as in K1: one CTA per (piece, d-chunk) of the
  plan's work list; the piece size is also capped so that the fp32 partial
  workspace (pieces of split groups × G × d × 4 bytes) stays within
  ``ops.WORKSPACE_BYTES``; a last launch, the combine K1 also uses, sums
  the partials in a fixed order and rounds once — no atomics;
- lanes run along d, so X row reads and Y row writes are coalesced; the
  chunk is ``d_tile`` columns, capped at 128 and at ``d`` rounded up to 32,
  and the kernel masks the d edge, so X is not padded;
- eight slot rows per stage are staged in shared memory with ``cp.async``
  (one buffer: a second was measured slower); a segment's slot rows past
  its ``seg_slots`` count are never read from memory, and no slot row past
  the row block's last live row is staged or computed on;
- the pieces of one-piece groups and of split groups go out as two
  launches with two loops.  In the first, a warp issues the gathers of its
  16 rows for a slot row together, and padding inside the live rows is
  summed as ``0·X[0]``, as the TPU kernel does.  In the second, a warp
  skips each of its rows whose staged slots are all padding and gathers a
  live row's eight slot rows together.  Either way the result differs from
  the TPU kernel's only where ``X[0]`` is not finite.

Each launcher call adds one to ``_build.launches["rgcsr_spmm"]``, whether
it sends out one launch or several (two loops and the combine); the plain
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

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
             + [ctypes.c_void_p, ctypes.c_int]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

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


def rgcsr_spmm_launch(plan, x, *, d_tile: int = LANES,
                      piece_rows: int | None = None):
    """``(n_groups·G, d)`` result rows of ``plan`` (an ``ops.RgCSRPlan``)
    times ``x``.

    CPU tensors run the plain version; CUDA tensors launch the kernel, or
    raise when it cannot take them.  ``piece_rows`` forces the size of the
    pieces that long groups are split into (a multiple of
    ``8·chunks_per_step``); by default the plan's rule picks it from its
    slot rows, the card's SM count and the workspace cap.
    """
    vals, cols = plan.values2d, plan.columns2d
    tensors = (vals, cols, plan.group_step_ptr, plan.seg_slots, x)
    dev = _build.cuda_device("rgcsr_spmm", tensors)
    if dev is None:
        return rgcsr_spmm_plain(vals, cols, plan.step_group, x,
                                n_groups=plan.n_groups,
                                chunks_per_step=plan.chunks_per_step)
    if x.dim() != 2:
        raise ValueError(f"rgcsr_spmm: X must be 2-D, got {tuple(x.shape)}")
    if vals.data_ptr() % 16 or cols.data_ptr() % 16:
        raise ValueError("rgcsr_spmm: values2d and columns2d must start on "
                         "a 16-byte boundary (the kernel stages them with "
                         "16-byte copies)")
    if d_tile < 32 or d_tile % 32:
        raise ValueError(f"rgcsr_spmm: d_tile must be a multiple of 32, "
                         f"got {d_tile}")
    g, d = vals.shape[1], x.shape[1]
    if g * d >= 2**31:
        raise ValueError(f"rgcsr_spmm: G·d must stay below 2^31 (the "
                         f"combine's 32-bit indices), got {g}·{d}")
    d_chunk = min(d_tile, MAX_D_CHUNK, -(-max(d, 1) // 32) * 32)
    work = plan.work_list("rgcsr_spmm", n_sm=_build.sm_count(dev),
                          part_bytes=g * d * 4, piece_rows=piece_rows)
    y = torch.empty((plan.n_groups * g, d), dtype=vals.dtype, device=dev)
    # the fp32 partial workspace, none when no group is split.  Allocated
    # per call: under a decode graph's capture it lands in that graph's
    # private pool, so engines that share a plan (router replicas) never
    # share a workspace; their replays run in turn on one stream, each
    # chunk ending in a sync.
    ws = (torch.empty((work.n_parts, g, d), dtype=torch.float32, device=dev)
          if work.n_parts else None)
    fn = _build.function(
        "rgcsr_spmm", _build.symbol("rgcsr_spmm", vals.dtype, x.dtype),
        _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(vals.data_ptr(), cols.data_ptr(), plan.seg_slots.data_ptr(),
                 work.items.data_ptr(), work.items.shape[0], work.n_direct,
                 work.combine.data_ptr(), work.combine.shape[0],
                 x.data_ptr(), y.data_ptr(),
                 None if ws is None else ws.data_ptr(), g, work.piece_rows,
                 d, d_chunk // 32, stream)
    _build.check(err, "rgcsr_spmm")
    _build.launches["rgcsr_spmm"] += 1
    return y
