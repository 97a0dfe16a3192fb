"""Paged GQA decode attention — the CUDA kernel ``csrc/paged_attention.cu``,
its launcher and its plain PyTorch version.

Replaces no TPU kernel: the JAX package decodes from a paged KV cache in
plain ``jnp``, over a dense view gathered through the block table
(``attention._paged_view``) with every position past a slot's length
masked.  The kernel computes the same function for one query token per
slot, reading in place only each slot's live rows: positions
``[0, min(index + 1, pages_per_slot · page_size))``, the positions that
``MaskInfo(causal, q_offset=index, valid_len=index + 1)`` admits (a free
slot, whose table points at the null page 0, attends to that page's
position 0; a slot whose index ran past the table attends to all of it).
On the H100 it is bound by bytes (each live K and V row read once); its
design is set out in the CUDA source.

Arithmetic, as ``attention.attend``: stored K and V rounded to the value
dtype (q's), logits ``scale · q·k`` with ``scale = D^-0.5``, max and sum in
fp32, probabilities normalised in fp32 and rounded to the value dtype,
``P · V`` summed in fp32 and rounded once.  The plain version, taken for
CPU tensors, is that chain itself: ``attend`` over ``_paged_view`` under
the paged decode's mask.

The launcher cuts each slot's live pages into parts of ``part_pages``
pages, a CTA each (the kernel finds on the card how many parts a slot's
length fills): at most ``PART_ROWS`` rows a part, fewer where a batch's
full tables would not give every SM two CTAs.  It allocates the fp32
scratch of the multi-part slots (their parts' logits, (max, sum) and
shares of ``P · V``) per call; under a decode graph's capture it lands in
the graph's private pool.  Each launcher call adds one to
``_build.launches["paged_attention"]``, whether it sends out one launch or
three; the plain version does not count.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

__all__ = ["paged_attention", "paged_attention_plain", "Geometry",
           "geometry"]

# The CUDA source's constants: threads a CTA, elements of D a lane owns,
# (head, chunk) pairs a thread sums, shared memory a CTA may have.
THREADS = 128
CHUNK = 8
MAX_PAIRS = 4
MAX_SMEM = 227 * 1024
MAX_DIM = 256
# Tiles of the ring in shared memory, and the bytes of rows each holds.
STAGES = 2
TILE_BYTES = 8192
# Most rows a part (a CTA) takes of a slot.
PART_ROWS = 256
# Shared memory a CTA is given before the launcher cuts its parts
# smaller.
SMEM_BUDGET = 56 * 1024

_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])


class Geometry(NamedTuple):
    """A launch's shape: pages a part, parts a full table, rows a tile,
    and the CTA's shared memory in bytes."""
    part_pages: int
    parts: int
    tile_rows: int
    smem: int


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def geometry(batch: int, hkv: int, group: int, dim: int, page_size: int,
             pages: int, store_bytes: int, n_sm: int,
             part_pages: Optional[int] = None) -> Geometry:
    """The launch geometry of one call (the CUDA source's layout: q and
    the heads' (max, sum) in fp32, the ring of tiles of rows, a part's
    logits).  ``part_pages`` forces the pages a part (the tests reach
    every path of the kernel with it, through ``_launch``); its logits
    must fit."""
    lanes = 1
    while lanes < dim // CHUNK:
        lanes *= 2
    row_bytes = dim * store_bytes
    tile_rows = max(THREADS // lanes, TILE_BYTES // row_bytes)
    fixed = (_align16(group * (dim + 2) * 4)
             + _align16(STAGES * tile_rows * row_bytes))

    def smem(n: int) -> int:
        return fixed + n * page_size * group * 4

    if smem(1) > MAX_SMEM:
        raise ValueError(f"paged_attention: a page of logits "
                         f"({page_size * group * 4} bytes) does not fit in "
                         f"a CTA's shared memory")
    if part_pages is None:
        part_pages = max(1, min(PART_ROWS // page_size,
                                pages * batch * hkv // (2 * n_sm)))
        while part_pages > 1 and smem(part_pages) > SMEM_BUDGET:
            part_pages -= 1
    elif part_pages < 1 or smem(part_pages) > MAX_SMEM:
        raise ValueError(f"paged_attention: part_pages must be at least 1 "
                         f"and its logits fit in shared memory, got "
                         f"{part_pages}")
    part_pages = min(part_pages, pages)
    return Geometry(part_pages, -(-pages // part_pages), tile_rows,
                    smem(part_pages))


def paged_attention_plain(q, k, v, block_table, index):
    """Plain PyTorch paged decode attention: the chain the kernel replaces,
    every slot's whole table gathered (``_paged_view``), loaded to q's
    dtype and attended under the paged decode's mask."""
    # the model layer imports this module: its helpers are looked up here
    from repro_torch.models.attention import MaskInfo, _paged_view, attend
    kv = [_paged_view(pool, block_table.long()).to(q.dtype)
          for pool in (k, v)]
    return attend(q, *kv, mask_info=MaskInfo(causal=True, q_offset=index,
                                             valid_len=index + 1))


def _check(q, k, v, block_table, index) -> None:
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4:
        raise ValueError(f"paged_attention: q must be (B, 1, Hq, D) and the "
                         f"pools (n_pages, page_size, Hkv, D); got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    if v.shape != k.shape or v.dtype != k.dtype or k.shape[3] != d:
        raise ValueError(f"paged_attention: k {tuple(k.shape)} {k.dtype} "
                         f"and v {tuple(v.shape)} {v.dtype} must match, "
                         f"with q's head dim {d}")
    if hq % hkv:
        raise ValueError(f"paged_attention: {hq} query heads do not group "
                         f"over {hkv} kv heads")
    if (block_table.dim() != 2 or block_table.shape[0] != b
            or block_table.dtype != torch.int32
            or tuple(index.shape) != (b,) or index.dtype != torch.int32):
        raise ValueError(f"paged_attention: block_table must be (B, pages) "
                         f"int32 and index (B,) int32 for B = {b}; got "
                         f"{tuple(block_table.shape)} {block_table.dtype}, "
                         f"{tuple(index.shape)} {index.dtype}")
    if q.dtype not in _TAGS or k.dtype not in _TAGS:
        raise ValueError(f"paged_attention: q and the pools must be float32, "
                         f"bfloat16 or float16; got {q.dtype} and {k.dtype}")


def paged_attention(q, k, v, block_table, index):
    """``(B, 1, Hq, D)`` attention of each slot's query ``q`` (roped, in
    the value dtype) over its live rows of the pools ``k``, ``v``
    ``(n_pages, page_size, Hkv, D)``, addressed through ``block_table``
    ``(B, pages)``; ``index`` ``(B,)`` counts each slot's tokens before
    this step's, whose K and V the pools already hold.

    CPU tensors run the plain version; CUDA tensors launch the kernel, or
    raise when it cannot take them.
    """
    _check(q, k, v, block_table, index)
    dev = _build.cuda_device("paged_attention",
                             (q, k, v, block_table, index))
    if dev is None:
        return paged_attention_plain(q, k, v, block_table, index)
    b, _, hq, d = q.shape
    _, ps, hkv, _ = k.shape
    g = hq // hkv
    if d % CHUNK or not 0 < d <= MAX_DIM or g * (d // CHUNK) > \
            MAX_PAIRS * THREADS:
        raise ValueError(f"paged_attention: the kernel takes a head dim "
                         f"that is a multiple of {CHUNK} up to {MAX_DIM}, "
                         f"and G·D/{CHUNK} up to {MAX_PAIRS * THREADS}; "
                         f"got D {d}, G {g}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("paged_attention: q and the pools must start on "
                         "16-byte boundaries (the kernel's 16-byte copies)")
    return _launch(q, k, v, block_table, index,
                   geometry(b, hkv, g, d, ps, block_table.shape[1],
                            k.element_size(), _build.sm_count(dev)))


def _launch(q, k, v, block_table, index, geom: Geometry):
    """The kernel on checked CUDA inputs, cut as ``geom`` says."""
    b, _, hq, d = q.shape
    _, ps, hkv, _ = k.shape
    out = torch.empty_like(q)
    logits = stats = share = None
    if geom.parts > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        logits = torch.empty((b, hkv, geom.parts,
                              geom.part_pages * ps * (hq // hkv)), **f32)
        stats = torch.empty((geom.parts, b, hq, 2), **f32)
        share = torch.empty((geom.parts, b, hq, d), **f32)
    fn = _build.function(
        "paged_attention",
        f"paged_attention_{_TAGS[k.dtype]}_{_TAGS[q.dtype]}", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 block_table.data_ptr(), index.data_ptr(), out.data_ptr(),
                 *(None if t is None else t.data_ptr()
                   for t in (logits, stats, share)),
                 b, hkv, hq // hkv, d, ps, block_table.shape[1],
                 geom.part_pages, geom.parts, geom.tile_rows, d ** -0.5,
                 stream)
    _build.check(err, "paged_attention")
    _build.launches["paged_attention"] += 1
    return out
