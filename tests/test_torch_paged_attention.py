"""The paged decode attention's plain version (``kernels/paged_attention.py``),
taken for CPU tensors: bit for bit ``attention.attend`` over the gathered
view ``_paged_view``, the chain the CUDA kernel replaces, and within the
bars below of a float64 attention over each slot's live rows alone; and the
launcher's geometry and refusals.

Bars against float64: fp32 within 1e-5; a bf16 or fp16 value dtype within
2e-2 or 4e-3 (K, V and the probabilities rounded to it, the output rounded
once).  The CUDA kernel against this plain version:
``tests/test_torch_gpu.py -k paged``.
"""
import numpy as np
import pytest
import torch

from _torch_parity import paged_case
from repro_torch.kernels.paged_attention import (SMEM_BUDGET, geometry,
                                                 paged_attention,
                                                 paged_attention_plain)
from repro_torch.models.attention import MaskInfo, _paged_view, attend

torch.set_num_threads(1)

# Live lengths (index + 1) at page size 16 and 4 pages a table: one token,
# a page boundary (16, 17), mid-page, the whole table, an index past it, a
# free slot on the null page at index 0 and one whose index has grown.
LENGTHS = [1, 16, 17, 9, 64, 90, None, 0]
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


def _live_rows_f64(q, k, v, table, index):
    """float64 attention of each slot over its live rows alone, positions
    ``[0, min(index + 1, pages · page_size))`` looked up through its table;
    K and V rounded to q's dtype first, as the cache's load does."""
    b, _, hq, d = q.shape
    ps, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, 1, hq, d), dtype=torch.float64)
    for i in range(b):
        n = min(int(index[i]) + 1, table.shape[1] * ps)
        pos = torch.arange(n)
        rows = table[i].long()[pos // ps], pos % ps
        kk, vv = (pool[rows].to(q.dtype).double() for pool in (k, v))
        for h in range(hq):
            w = torch.softmax(kk[:, h * hkv // hq] @ q[i, 0, h].double()
                              * d ** -0.5, 0)
            out[i, 0, h] = w @ vv[:, h * hkv // hq]
    return out


@pytest.mark.parametrize("store,value,tol", [(F32, F32, 1e-5),
                                             (BF16, BF16, 2e-2),
                                             (BF16, F32, 1e-5),
                                             (F16, F16, 4e-3)])
@pytest.mark.parametrize("dim", [16, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 6])
def test_plain_matches_attend_over_the_paged_view(group, dim, store, value,
                                                  tol):
    case = paged_case(group * 1000 + dim, LENGTHS, 2, group, dim,
                      store=store, value=value)
    got = paged_attention(*case)          # CPU tensors: the plain version
    q, k, v, table, index = case
    view = [_paged_view(pool, table.long()).to(value) for pool in (k, v)]
    want = attend(q, *view, mask_info=MaskInfo(
        causal=True, q_offset=index, valid_len=index + 1))
    assert got.shape == want.shape and got.dtype == want.dtype == value
    assert torch.equal(got, want)
    torch.testing.assert_close(got.double(), _live_rows_f64(*case),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plain_free_slots_read_position_0_of_the_null_page(dtype):
    """A free slot (null page, index 0) reads position 0 of page 0:
    softmax over one row, its V row."""
    q, k, v, table, index = paged_case(8, [None, 5], 2, 2, 16, store=dtype,
                                       value=dtype)
    got = paged_attention_plain(q, k, v, table, index)
    torch.testing.assert_close(got[0, 0].reshape(2, 2, 16),
                               v[0, 0][:, None].expand(2, 2, 16),
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape,part_pages", [
    # granite-3-2b's decode step: parts of 256 rows, 8 to a full table
    ((64, 8, 4, 64, 16, 128, 2), 16),
    # two slots of two kv heads: a page a part, so that full tables would
    # give the SMs as many CTAs as they can
    ((2, 2, 2, 16, 4, 16, 4), 1),
    ((1, 8, 4, 64, 16, 128, 2), 3),
    # 64 query heads a kv head: 256 rows of logits (64 KB) pass the
    # budget, the parts are cut to 5 pages
    ((64, 1, 64, 64, 16, 128, 2), 5),
])
def test_geometry_cuts_parts_where_the_card_needs_it(shape, part_pages):
    geom = geometry(*shape, n_sm=132)
    assert geom.part_pages == part_pages
    assert geom.parts == -(-shape[5] // part_pages)
    assert geom.smem <= SMEM_BUDGET
    # the tiles hold the row groups' sums of P · V at the end (4 KB)
    dim, store = shape[3], shape[6]
    assert geom.tile_rows * dim * store >= 4096


def test_geometry_takes_a_forced_part_size():
    assert geometry(64, 8, 4, 64, 16, 128, 2, 132, part_pages=128) == \
        geometry(64, 8, 4, 64, 16, 128, 2, 132, part_pages=500)
    assert geometry(64, 8, 4, 64, 16, 128, 2, 132, part_pages=128).parts == 1
    for bad in (0, 4096):
        with pytest.raises(ValueError, match="part_pages"):
            geometry(64, 8, 64, 256, 16, 4096, 4, 132, part_pages=bad)
    assert geometry(64, 8, 4, 64, 16, 128, 2, 132, part_pages=3).parts == 43


def test_refuses_inputs_it_does_not_take():
    q, k, v, table, index = paged_case(9, [3, 20], 2, 2, 16)
    bad = [
        (torch.cat([q, q], 1), k, v, table, index),       # two query tokens
        (q[:, :, :3], k, v, table, index),                # 3 heads over 2
        (q, k, v[..., :8], table, index),                 # v's head dim
        (q, k, v.to(BF16), table, index),                 # k and v differ
        (q, k, v, table.long(), index),                   # int64 table
        (q, k, v, table, index[:1]),                      # one index
        (q.double(), k, v, table, index),                 # float64
    ]
    for args in bad:
        with pytest.raises(ValueError, match="paged_attention"):
            paged_attention(*args)
    assert np.isfinite(paged_attention(q, k, v, table, index).numpy()).all()
