"""K1: RgCSR SpMV — the CUDA kernel ``csrc/rgcsr_spmv.cu``, its launcher and
its plain PyTorch version.

Replaces ``repro.kernels.rgcsr_spmv.rgcsr_spmv_kernel`` (the Pallas TPU
kernel).  On the H100 the kernel is bound by bytes: every slot it reads
costs a value and an int32 column for 2 flops.  Its design, set out in the
CUDA source:

- long groups are split: the plan's work list (``RgCSRPlan.work_list``)
  cuts each group into pieces of at most ``piece_rows`` slot rows and names
  the live (piece, 32-lane segment) units, one warp each, four to a CTA; a
  group of one piece writes ``y`` directly, the pieces of a longer group
  write fp32 partials that a second launch sums in a fixed order and rounds
  once — no atomics, so two calls agree bit for bit;
- trailing padding is skipped: each warp (one 32-lane segment) stops after
  the plan's ``seg_slots`` count of its segment.  The skipped slots are
  value 0 at column 0, so the result differs from the TPU kernel's only
  where ``x[0]`` is not finite.

The Pallas kernel walks a step table in grid order and accumulates across
steps; GPU blocks run in no order, so each CTA instead walks its piece of
its group's steps, found through the plan's ``group_step_ptr``.  The plain
version below walks the reference's ``step_group`` table and every slot,
so comparing the two also checks the derived pointer, the segment counts
and the work list.

Each launcher call adds one to ``_build.launches["rgcsr_spmv"]``, whether
it sends out one launch or the piece launch and its combine; the plain
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

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_int]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


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


def rgcsr_spmv_launch(plan, x, *, piece_rows: int | None = None):
    """``(n_groups, G)`` per-group result rows of ``plan`` (an
    ``ops.RgCSRPlan``) times ``x``.

    CPU tensors run the plain version; CUDA tensors launch the kernel, or
    raise when it cannot take them.  ``piece_rows`` forces the size of the
    pieces that long groups are split into (a multiple of
    ``8·chunks_per_step``); by default the plan's rule picks it from its
    slot rows and the card's SM count.
    """
    vals, cols = plan.values2d, plan.columns2d
    tensors = (vals, cols, plan.group_step_ptr, plan.seg_slots, x)
    dev = _build.cuda_device("rgcsr_spmv", tensors)
    if dev is None:
        return rgcsr_spmv_plain(vals, cols, plan.step_group, x,
                                n_groups=plan.n_groups,
                                chunks_per_step=plan.chunks_per_step)
    if x.dim() != 1:
        raise ValueError(f"rgcsr_spmv: x must be 1-D, got {tuple(x.shape)}")
    g = vals.shape[1]
    work = plan.work_list("rgcsr_spmv", n_sm=_build.sm_count(dev),
                          part_bytes=g * 4, piece_rows=piece_rows)
    y = torch.empty((plan.n_groups, g), dtype=vals.dtype, device=dev)
    # the fp32 partial workspace, none when no group is split
    ws = (torch.empty((work.n_parts, g), dtype=torch.float32, device=dev)
          if work.n_parts else None)
    fn = _build.function(
        "rgcsr_spmv", _build.symbol("rgcsr_spmv", vals.dtype, x.dtype),
        _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(vals.data_ptr(), cols.data_ptr(), plan.seg_slots.data_ptr(),
                 work.items.data_ptr(), work.items.shape[0],
                 work.combine.data_ptr(), work.combine.shape[0],
                 x.data_ptr(), y.data_ptr(),
                 None if ws is None else ws.data_ptr(), g, work.piece_rows, stream)
    _build.check(err, "rgcsr_spmv")
    _build.launches["rgcsr_spmv"] += 1
    return y
