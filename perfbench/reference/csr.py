"""The plain reference of a sparse product: ``Y = A · X`` from CSR arrays.

Frozen: the benchmark judges the program's products against it.  It is
plain PyTorch, runs on whatever device its inputs are on, and reads only
the CSR arrays the benchmark made and the vectors it multiplies.  Products
and sums are taken in float64, in blocks of nonzeros so that a block's
gathered rows stay small.

:func:`product_tf32` is the same product computed a precision below the
float32 a configuration states (its inputs rounded to TF32, products and
sums in float32): the control, which the comparison has to find wrong.
"""
from __future__ import annotations

import torch

BLOCK_NNZ = 1 << 21


def row_ids(row_ptr: torch.Tensor) -> torch.Tensor:
    """The row of each nonzero, int64."""
    n = row_ptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(n, device=row_ptr.device),
        (row_ptr[1:] - row_ptr[:-1]).long())


def _segment_sums(values, columns, rows, x, n_rows, dtype, rounding=None,
                  scale=True):
    lead = (n_rows,) + tuple(x.shape[1:])
    y = torch.zeros(lead, dtype=dtype, device=x.device)
    mag = torch.zeros(lead, dtype=dtype, device=x.device) if scale else None
    xs = x.to(dtype) if rounding is None else rounding(x).to(dtype)
    for a in range(0, values.numel(), BLOCK_NNZ):
        b = min(values.numel(), a + BLOCK_NNZ)
        v = values[a:b].to(dtype) if rounding is None \
            else rounding(values[a:b]).to(dtype)
        g = xs[columns[a:b].long()]
        if g.dim() > 1:
            v = v[:, None]
        t = v * g
        y.index_add_(0, rows[a:b], t)
        if scale:
            mag.index_add_(0, rows[a:b], t.abs())
    return y, mag


def product(values, columns, row_ptr, x, rows=None):
    """``(A · x, |A| · |x|)`` in float64; ``x`` is ``(n,)`` or ``(n, d)``.
    The second is each element's scale: the sum of its terms' sizes."""
    rows = row_ids(row_ptr) if rows is None else rows
    return _segment_sums(values, columns, rows, x, row_ptr.numel() - 1,
                         torch.float64)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest even."""
    b = t.float().contiguous().view(torch.int32).to(torch.int64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.to(torch.int32).view(torch.float32)


def product_tf32(values, columns, row_ptr, x, rows=None):
    """``A · x`` in float32 from inputs rounded to TF32."""
    rows = row_ids(row_ptr) if rows is None else rows
    return _segment_sums(values, columns, rows, x, row_ptr.numel() - 1,
                         torch.float32, round_tf32, scale=False)[0]


def relative_error(got, want, scale) -> float:
    """The largest ``|got - want| / scale`` (float64); an element whose
    scale is 0 reads 0 when it is exact and infinity when it is not."""
    err = (got.double() - want).abs()
    rel = torch.where(scale > 0, err / scale.clamp_min(1e-300),
                      torch.where(err > 0, torch.inf, 0.0))
    return float(rel.max()) if rel.numel() else 0.0
