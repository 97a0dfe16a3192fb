"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test is marked ``gpu`` and skips itself when no CUDA card is present
(decided in the ``cuda`` fixture, never at import).  This file imports
neither jax nor the JAX package, so it runs where only PyTorch is
installed::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: fp32 within rtol = atol = 1e-5, bf16 within 3e-2; kernel and
plain version both sum in fp32 and differ only in summation order.  K1–K3
skip padding slots (value 0 at column 0) that the plain version sums as
``0·x[0]``; the two differ there only where ``x[0]`` is not finite, and
these tests use finite x.  ``piece_rows`` forces the split of long groups
at each piece size.  K3's tests alone::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py -k k3
"""
import contextlib
import copy
import dataclasses
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_dist import (BATCH, MOE_CASES, SEQ, moe_trainer, run_ranks,
                         sharded_cfg, sweep, train_config, train_ranks)
from _torch_parity import (ell_counts_csr, paged_case, rand_sparse,
                           row_shards, skewed)

from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import SparsityConfig
from repro_torch.core import ShardedRgCSR, from_csr, from_dense, spmm, spmv
from repro_torch.core.timing import time_us
from repro_torch.kernels import (launch_counts, ops, plan_from_params,
                                 reset_launch_counts)
from repro_torch.kernels import paged_attention as paged_module
from repro_torch.kernels.ell_spmv import ell_spmv_launch, ell_spmv_plain
from repro_torch.kernels.paged_attention import (geometry, paged_attention,
                                                 paged_attention_plain)
from repro_torch.kernels.rgcsr_spmm import rgcsr_spmm_launch, rgcsr_spmm_plain
from repro_torch.kernels.rgcsr_spmv import rgcsr_spmv_launch, rgcsr_spmv_plain
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import LanguageModel, attention, ffn, moe
from repro_torch.models.attention import _paged_view
from repro_torch.models.spec import init_from_spec
from repro_torch.serve import Engine, Request, Router, RouterConfig, \
    ServeConfig
from repro_torch.train.fault import FaultConfig, FaultInjector

REPO = Path(__file__).resolve().parents[1]
# the launcher's module (the package's ``rgcsr_spmm`` attribute is the
# ``ops`` wrapper)
k2_module = importlib.import_module("repro_torch.kernels.rgcsr_spmm")


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cuda_plan(a, dev, **kw):
    return ops.make_plan(from_dense(a, "rgcsr", device=dev), **kw)


# Piece sizes, in steps of the plan: 1 (the smallest), 2, 3, None (the
# plan's rule) and 10**4 (no group split).
PIECES = [1, 2, 3, None, 10**4]


def _piece_rows(plan, steps):
    return None if steps is None else steps * plan.rows_per_step


def _stored_zeros(seed, n=400, m=300):
    """A skewed matrix whose format holds explicit zeros: some at column 0
    (indistinguishable from padding, so skipped) and some elsewhere."""
    a = skewed(seed, n=n, m=m)
    a[::5, 0] = 1.0
    a[::3, 7] = 1.0
    return a


def _with_stored_zeros(m):
    vals = m.values.clone()
    for col in (0, 7):
        nz = torch.nonzero((m.columns == col) & (vals != 0)).flatten()
        vals[nz[::2]] = 0.0
    return dataclasses.replace(m, values=vals)


@pytest.mark.gpu
@pytest.mark.parametrize("steps", PIECES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("cps,ordering,spill", [(1, "block", 0),
                                                (4, "block", 0),
                                                (2, "adaptive", 6),
                                                (1, "adaptive", 0)])
def test_k1_cuda_matches_plain(cuda, cps, ordering, spill, dtype, tol,
                               steps):
    """With long groups split at every piece size (finite x: skipped
    padding would differ only where x[0] is not)."""
    plan = _cuda_plan(skewed(13, n=700, m=650), cuda, chunks_per_step=cps,
                      ordering=ordering, spill_threshold=spill)
    plan = dataclasses.replace(plan, values2d=plan.values2d.to(dtype))
    x = torch.from_numpy(_x(14, 768)).to(cuda, dtype)
    before = launch_counts()["rgcsr_spmv"]
    got = rgcsr_spmv_launch(plan, x, piece_rows=_piece_rows(plan, steps))
    assert launch_counts()["rgcsr_spmv"] == before + 1
    want = rgcsr_spmv_plain(plan.values2d, plan.columns2d, plan.step_group,
                            x, n_groups=plan.n_groups, chunks_per_step=cps)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("steps", PIECES)
@pytest.mark.parametrize("d,d_tile,dtype,tol", [
    (1, 128, torch.float32, 1e-5), (64, 128, torch.float32, 1e-5),
    (129, 128, torch.float32, 1e-5), (100, 64, torch.float32, 1e-5),
    (64, 128, torch.bfloat16, 3e-2)])
def test_k2_cuda_matches_plain(cuda, d, d_tile, dtype, tol, steps):
    plan = _cuda_plan(skewed(15, n=400, m=300), cuda, chunks_per_step=2)
    plan = dataclasses.replace(plan, values2d=plan.values2d.to(dtype))
    x = torch.from_numpy(_x(16, 300, d)).to(cuda, dtype)
    before = launch_counts()["rgcsr_spmm"]
    got = rgcsr_spmm_launch(plan, x, d_tile=d_tile,
                            piece_rows=_piece_rows(plan, steps))
    assert launch_counts()["rgcsr_spmm"] == before + 1
    want = rgcsr_spmm_plain(plan.values2d, plan.columns2d, plan.step_group,
                            x, n_groups=plan.n_groups, chunks_per_step=2)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("steps", PIECES)
def test_k1_k2_cuda_with_stored_zeros(cuda, steps):
    """Stored zeros at column 0 are skipped like padding, those elsewhere
    are summed; with finite x both match the plain version, which sums
    every slot."""
    m = _with_stored_zeros(from_dense(_stored_zeros(25), "rgcsr",
                                      device=cuda))
    plan = ops.make_plan(m)
    x = torch.from_numpy(_x(26, 300, 5)).to(cuda)
    args = (plan.values2d, plan.columns2d, plan.step_group)
    kw = dict(n_groups=plan.n_groups, chunks_per_step=1)
    p = _piece_rows(plan, steps)
    x1 = x[:, 0].contiguous()
    torch.testing.assert_close(rgcsr_spmv_launch(plan, x1, piece_rows=p),
                               rgcsr_spmv_plain(*args, x1, **kw),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rgcsr_spmm_launch(plan, x, piece_rows=p),
                               rgcsr_spmm_plain(*args, x, **kw),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [1, None])
def test_split_launches_are_bitwise_repeatable(cuda, steps):
    """No atomics: two calls give the same bits, split or not."""
    plan = _cuda_plan(skewed(27, n=900, m=700), cuda)
    p = _piece_rows(plan, steps)
    x = torch.from_numpy(_x(28, 700, 33)).to(cuda)
    x1 = x[:, 0].contiguous()
    assert torch.equal(rgcsr_spmv_launch(plan, x1, piece_rows=p),
                       rgcsr_spmv_launch(plan, x1, piece_rows=p))
    assert torch.equal(rgcsr_spmm_launch(plan, x, piece_rows=p),
                       rgcsr_spmm_launch(plan, x, piece_rows=p))


@pytest.mark.gpu
def test_k3_cuda_matches_plain(cuda):
    a = rand_sparse(17, 1000, 900, 0.01)
    plan = ops.make_ell_plan(from_dense(a, "ellpack", device=cuda))
    x_pad = torch.from_numpy(_x(18, 1024)).to(cuda)
    before = launch_counts()["ell_spmv"]
    got = ell_spmv_launch(plan, x_pad)
    assert launch_counts()["ell_spmv"] == before + 1
    want = ell_spmv_plain(plan.values2d, plan.columns2d, x_pad)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _k3_mixed_plan(cuda, k_max, seed):
    """A plan made on the card whose 32-row segments hold every live-slot
    count from 0 to ``K_pad = k_max``, and its number of columns."""
    csr, counts = ell_counts_csr(seed, k_max, 6 * (k_max + 1) + 5)
    plan = ops.make_ell_plan(from_csr(*csr, "ellpack", device=cuda))
    assert plan.values2d.shape[0] == k_max
    got = plan.seg_slots.cpu().numpy()
    np.testing.assert_array_equal(got[:len(counts)], counts)
    assert not got[len(counts):].any()
    return plan, csr[3][1]


def _k3_close(got, plan, x, tol):
    """Within ``tol · (1 + Σ|a·x|)`` of the plain version of ``plan``."""
    want = ell_spmv_plain(plan.values2d, plan.columns2d, x).float()
    scale = ell_spmv_plain(plan.values2d.float().abs(), plan.columns2d,
                           x.float().abs()).float()
    assert got.dtype == plan.values2d.dtype
    err = (got.float() - want).abs()
    assert bool((err <= tol * (1 + scale)).all()), err.max().item()


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.gpu
@pytest.mark.parametrize("k_max", [8, 16])
@pytest.mark.parametrize("vdt,xdt", [(F32, F32), (F32, BF16), (BF16, F32),
                                     (BF16, BF16)])
def test_k3_mixed_counts_match_plain(cuda, k_max, vdt, xdt):
    plan, n = _k3_mixed_plan(cuda, k_max, 60 + k_max)
    plan = dataclasses.replace(plan, values2d=plan.values2d.to(vdt))
    x = torch.from_numpy(_x(61, n)).to(cuda, xdt)
    before = launch_counts()["ell_spmv"]
    got = ell_spmv_launch(plan, x)
    assert launch_counts()["ell_spmv"] == before + 1
    _k3_close(got, plan, x, 1e-5 if vdt == xdt == F32 else 3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("k_max", [8, 16])
def test_k3_reads_no_slot_past_the_counts(cuda, k_max):
    """NaN written into every values slot past its segment's count, after
    the counts are derived, leaves K3's result finite and equal to the
    plain version of the clean plan."""
    plan, n = _k3_mixed_plan(cuda, k_max, 70 + k_max)
    count = plan.seg_slots.long().repeat_interleave(32)
    past = torch.arange(k_max, device=cuda)[:, None] >= count[None, :]
    poisoned = dataclasses.replace(
        plan, values2d=plan.values2d.masked_fill(past, float("nan")))
    assert poisoned.seg_slots is plan.seg_slots
    x = torch.from_numpy(_x(71, n)).to(cuda)
    got = ell_spmv_launch(poisoned, x)
    assert bool(torch.isfinite(got).all())
    _k3_close(got, plan, x, 1e-5)


@pytest.mark.gpu
def test_k3_refuses_counts_that_do_not_match(cuda):
    plan, n = _k3_mixed_plan(cuda, 8, 80)
    x = torch.from_numpy(_x(81, n)).to(cuda)
    before = launch_counts()["ell_spmv"]
    for seg in (plan.seg_slots[:-1], plan.seg_slots.cpu()):
        with pytest.raises(ValueError, match="seg_slots|CUDA device"):
            ell_spmv_launch(dataclasses.replace(plan, seg_slots=seg), x)
    assert launch_counts()["ell_spmv"] == before


# ------------------------------------------------ paged decode attention


# Live lengths (index + 1) of a case's slots at page size 16 and 4 pages a
# table: one token, a page boundary (16, 17), mid-page, the whole table, an
# index past it, a free slot on the null page at index 0 and one whose
# index has grown.
PAGED_LENGTHS = [1, 16, 17, 9, 64, 90, None, 0]
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
# Kernel and plain version round at the same points (K and V to the value
# dtype, the probabilities to it before P · V, the output once) and sum in
# fp32 in other orders.  So an output may land PAGED_ULPS rounding steps
# of the value dtype apart at its own size, plus one step of the largest
# term p_t·|v_t| (a probability whose rounding went the other way), plus
# PAGED_F32 steps of fp32 at the largest |v| (the sums' order):
#   |got - want| <= eps·(PAGED_ULPS·max(|want|, 2^-6) + max p · max|v|)
#                   + PAGED_F32·eps32·max|v|.
# And where the value dtype has 16 bits, at most PAGED_SHARE of the outputs
# differ at all: a moved rounding point moves many more.
PAGED_ULPS, PAGED_F32, PAGED_SHARE = 2, 32, 0.05


@contextlib.contextmanager
def _fp32_sums():
    """The plain version's 16-bit P · V summed in fp32, as the kernel sums
    it (cuBLAS may otherwise reduce it in 16 bits)."""
    m = torch.backends.cuda.matmul
    old = (m.allow_fp16_reduced_precision_reduction,
           m.allow_bf16_reduced_precision_reduction)
    m.allow_fp16_reduced_precision_reduction = False
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (m.allow_fp16_reduced_precision_reduction,
         m.allow_bf16_reduced_precision_reduction) = old


def _paged_bar(case, want):
    """The bound above, per output element of ``case``."""
    q, k, v, table, index = case
    b, _, hq, d = q.shape
    hkv, t = k.shape[2], table.shape[1] * k.shape[1]
    live = torch.arange(t, device=q.device) < torch.clamp(
        index.long() + 1, max=t)[:, None]                   # (B, T)
    kk, vv = (_paged_view(pool, table.long()).to(q.dtype).float()
              for pool in (k, v))                           # (B, T, Hkv, D)
    logits = torch.einsum("bhgd,bthd->bhgt", q.float().reshape(
        b, hkv, hq // hkv, d), kk) * d ** -0.5
    p_max = torch.softmax(logits.masked_fill(
        ~live[:, None, None], float("-inf")), -1).amax(-1)  # (B, Hkv, G)
    v_max = vv.abs().masked_fill(~live[:, :, None, None], 0).amax(1)
    v_max = v_max[:, :, None].expand(b, hkv, hq // hkv, d)
    return (torch.finfo(want.dtype).eps * (
        PAGED_ULPS * want.float().abs().clamp(min=2 ** -6)
        + (p_max[..., None] * v_max).reshape(want.shape))
        + PAGED_F32 * torch.finfo(torch.float32).eps
        * v_max.reshape(want.shape))


def _forced(case, part_pages):
    """The launch geometry of ``case`` with ``part_pages`` pages a part."""
    q, k, _, table, _ = case
    hkv = k.shape[2]
    return geometry(q.shape[0], hkv, q.shape[2] // hkv, q.shape[3],
                    k.shape[1], table.shape[1], k.element_size(),
                    torch.cuda.get_device_properties(
                        q.device).multi_processor_count, part_pages)


def _paged_close(case, part_pages=None):
    """The kernel on ``case`` (one launcher call; ``part_pages`` forces the
    pages a part) against its plain version on the same CUDA tensors."""
    q, k, v, table, index = case
    before = launch_counts()["paged_attention"]
    got = paged_attention(*case) if part_pages is None else \
        paged_module._launch(*case, _forced(case, part_pages))
    with _fp32_sums():
        want = paged_attention_plain(q, k, v, table, index)
    torch.cuda.synchronize()
    assert launch_counts()["paged_attention"] == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype
    assert bool(torch.isfinite(got).all())
    assert bool(((got.float() - want.float()).abs()
                 <= _paged_bar(case, want)).all())
    if q.element_size() == 2:
        assert (got != want).float().mean().item() <= PAGED_SHARE
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("store,value", [(F32, F32), (BF16, BF16),
                                         (F16, F16), (BF16, F32),
                                         (F32, BF16)])
@pytest.mark.parametrize("dim", [16, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 6, 16])
def test_paged_attention_cuda_matches_plain(cuda, group, dim, store, value):
    """Every length kind, with parts of 4 pages (a whole table: one launch
    finishes every slot), 1 page (every slot past its first page through
    the three launches), 3 (both kinds in one call) and the launcher's own
    choice."""
    case = paged_case(60 + group + dim, PAGED_LENGTHS, 2, group, dim,
                      store=store, value=value, device=cuda)
    for part_pages in (None, 4, 1, 3):
        _paged_close(case, part_pages)


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [8, 40, 48, 96, 256])
def test_paged_attention_cuda_takes_every_head_dim(cuda, dim):
    """Head dims whose D / 8 chunks are not a power of two (idle lanes)
    and the widest, 256."""
    case = paged_case(70 + dim, PAGED_LENGTHS, 2, 4, dim, store=BF16,
                      value=BF16, device=cuda)
    for part_pages in (4, 1):
        _paged_close(case, part_pages)


@pytest.mark.gpu
def test_paged_attention_cuda_at_granite_decode_shape(cuda):
    """granite-3-2b's decode step: 64 slots, 8 kv heads of 4 query heads
    at head dim 64, pages of 16, max_seq 2,048, bf16; mixed lengths up to
    the whole table and past it, two free slots.  The launcher cuts parts
    of 256 rows there; one part a slot (a whole table) agrees as
    closely."""
    rng = np.random.default_rng(90)
    lengths = [int(n) for n in rng.integers(1, 2049, 60)] + [
        2048, 2100, None, 0]
    case = paged_case(91, lengths, 8, 4, 64, pages=128, store=BF16,
                      value=BF16, device=cuda)
    assert geometry(64, 8, 4, 64, 16, 128, 2, 132).part_pages == 16
    _paged_close(case)
    _paged_close(case, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("part_pages", [4, 1])
def test_paged_attention_is_bitwise_repeatable(cuda, part_pages):
    case = paged_case(80, PAGED_LENGTHS, 2, 4, 64, store=BF16, value=BF16,
                      device=cuda)
    geom = _forced(case, part_pages)
    a = paged_module._launch(*case, geom)
    b = paged_module._launch(*case, geom)
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_paged_attention_reads_no_row_past_the_live_length(cuda):
    """NaN in every pool row no slot holds live — the rest of a slot's
    last page, its later pages, the null page past position 0 — and the
    result is finite and, part size for part size, bit for bit as before."""
    case = paged_case(81, PAGED_LENGTHS[:6], 2, 4, 64, store=BF16,
                      value=BF16, device=cuda)
    q, k, v, table, index = case
    geoms = [_forced(case, n) for n in (None, 4, 1)]
    want = [paged_module._launch(*case, geom) for geom in geoms]
    ps, t_max = k.shape[1], table.shape[1] * k.shape[1]
    live = torch.zeros(k.shape[:2], dtype=torch.bool, device=cuda)
    for b in range(len(index)):
        for t in range(min(int(index[b]) + 1, t_max)):
            live[int(table[b, t // ps]), t % ps] = True
    for pool in (k, v):
        pool[~live] = float("nan")
    for geom, before in zip(geoms, want):
        got = paged_module._launch(*case, geom)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, before)


@pytest.mark.gpu
def test_paged_attention_refuses_what_it_cannot_take(cuda):
    before = launch_counts()["paged_attention"]
    for dim, group in ((12, 4), (264, 1), (256, 32)):
        case = paged_case(82, [5, 9], 1, group, dim, device=cuda)
        with pytest.raises(ValueError, match="head dim"):
            paged_attention(*case)
    q, k, v, table, index = paged_case(83, [5, 9], 2, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="CUDA device"):
        paged_attention(q, k, v, table.cpu(), index)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention(torch.cat([q, q], -1)[..., :64], k, v, table,
                        index)
    assert launch_counts()["paged_attention"] == before


def _smoke_bf16(**over):
    """Smoke granite-3-2b in bf16 (compute and KV cache)."""
    return dataclasses.replace(get_smoke("granite-3-2b"), dtype="bfloat16",
                               kv_cache_dtype="bfloat16", **over)


@pytest.mark.gpu
def test_paged_decode_on_cuda_never_runs_the_plain_version(cuda,
                                                           monkeypatch):
    """bf16 paged GQA decode steps on the card go through the kernel, once
    a layer a step, never through the plain version or the gathered view;
    their logits agree with the same model's dense-cache steps."""
    from repro_torch.serve import paging

    def refuse(*args, **kwargs):
        raise AssertionError("the paged decode ran its plain version or "
                             "gathered the pool on a CUDA tensor")

    cfg = _smoke_bf16()
    model = LanguageModel(cfg, device=cuda)
    prompt = torch.from_numpy(np.random.default_rng(84).integers(
        0, 512, (1, 11)).astype(np.int32)).to(cuda)
    geom = paging.geometry(64, 4, n_slots=2)
    alloc = paging.PageAllocator(geom, n_slots=2)
    assert alloc.admit(1, 11, geom.pages_per_slot)
    with torch.inference_mode():
        logits, dense = model.prefill({"tokens": prompt}, 64)
        caches = model.init_cache(2, 64, paging=geom)
        paging.commit_prefill(caches, dense, 1, 11, alloc.table, 4)
        monkeypatch.setattr(paged_module, "paged_attention_plain", refuse)
        monkeypatch.setattr(attention, "_paged_view", refuse)
        tok = logits[:, -1].argmax(-1).int()
        for step in range(4):
            alloc.ensure(1, 12 + step)
            paging.sync_block_tables(caches, alloc.table)
            both = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
            both[1, 0] = tok[0]
            before = launch_counts()["paged_attention"]
            got, _ = model.decode_step(caches, both)
            assert launch_counts()["paged_attention"] == \
                before + cfg.n_layers
            want, dense = model.decode_step(dense, tok[:, None])
            for c in caches:
                c["index"] += 1
            w = want[0].float()
            torch.testing.assert_close(got[1].float(), w, rtol=0, atol=5e-2
                                       * (1 + w.abs().max().item()))
            tok = want[:, -1].argmax(-1).int()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_graph_launches_paged_attention_once_per_layer_and_live_step(
        cuda, layout):
    """bf16 serving, the chat cell's dtypes: each replay of the decode
    graph launches the kernel once a layer on paged caches, never on
    dense slabs; streams equal to generate() of each request alone."""
    cfg = _smoke_bf16()
    eng = Engine(cfg, ServeConfig(max_seq=64, n_slots=3, page_size=4,
                                  kv_layout=layout, decode_chunk=4),
                 device=cuda)
    per_replay = cfg.n_layers if layout == "paged" else 0
    assert eng._loop.launches_per_replay.get("paged_attention", 0) == \
        per_replay
    reset_launch_counts()
    reqs = _session_requests(85, (8, 11, 9, 6, 12), 7)
    eng.serve(reqs)
    st = eng.paging_stats
    assert launch_counts()["paged_attention"] == \
        per_replay * st["decode_steps"]
    for r in reqs:
        assert r.ok_like and len(r.out) == 7


@pytest.mark.gpu
def test_auto_on_cuda_raises_outside_the_kernels_domain(cuda):
    """A CUDA matrix the kernels cannot take (G = 64) raises under the
    default ``impl`` instead of running the oracle on the card."""
    a = rand_sparse(21, 200, 150, 0.05)
    m = from_dense(a, "rgcsr", group_size=64, device=cuda)
    x = torch.from_numpy(_x(22, 150)).to(cuda)
    before = launch_counts()
    with pytest.raises(ValueError, match="group_size"):
        spmv(m, x)
    with pytest.raises(ValueError, match="group_size"):
        spmm(m, x[:, None])
    assert launch_counts() == before


@pytest.mark.gpu
def test_main_path_on_cuda_goes_through_the_kernels(cuda):
    a = skewed(19, n=500, m=400)
    m = from_dense(a, "rgcsr", device=cuda)
    x = _x(20, 400)
    before = launch_counts()
    y = spmv(m, torch.from_numpy(x).to(cuda))
    ym = spmm(m, torch.from_numpy(np.stack([x, 2 * x], 1)).to(cuda))
    after = launch_counts()
    assert after["rgcsr_spmv"] == before["rgcsr_spmv"] + 1
    assert after["rgcsr_spmm"] == before["rgcsr_spmm"] + 1
    np.testing.assert_allclose(y.cpu().numpy(), a @ x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ym[:, 1].cpu().numpy(), 2 * (a @ x),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [{}, {"hold": True}, {"cold": True}])
def test_time_us_times_back_to_back_launches(cuda, mode):
    """A positive time per call, by default (what a caller waits), with the
    card held and after an L2 flush; each repeat makes ``calls`` calls
    after the warmup."""
    plan = ops.make_ell_plan(from_dense(rand_sparse(23, 300, 300, 0.02),
                                        "ellpack", device=cuda))
    x = torch.from_numpy(_x(24, 300)).to(cuda)
    before = launch_counts()["ell_spmv"]
    t = time_us(ops.ell_spmv, plan, x, repeats=3, warmup=1, calls=4, **mode)
    assert 0 < t < 1e6
    assert launch_counts()["ell_spmv"] == before + 1 + 3 * 4


# ------------------------------------------------ K2 at SparseLinear shapes


def _granite(n_layers=None, **overrides):
    """The full-width granite-3-2b config with the RgCSR FFN (K2)."""
    cfg = dataclasses.replace(
        get_config("granite-3-2b"),
        sparsity=SparsityConfig(enabled=True, density=0.25, group_size=128,
                                impl="kernel"), **overrides)
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


_W_OUT = {}


def _w_out_params(dev):
    """One w_out layer of the full config: W (2048, 8192) at density 0.25,
    i.e. 16 groups of 2,048 slot rows of 128 lanes."""
    if dev not in _W_OUT:
        cfg = _granite()
        spec = ffn.sparse_linear_spec(cfg, cfg.d_ff, cfg.d_model)
        _W_OUT[dev] = init_from_spec(
            spec, torch.Generator(device=dev).manual_seed(5), device=dev)
    return _W_OUT[dev]


@pytest.mark.gpu
@pytest.mark.parametrize("piece_rows", [None, 64, 512])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("d", [1, 4, 512])
def test_k2_cuda_matches_plain_at_sparse_linear_shapes(cuda, d, dtype, tol,
                                                       piece_rows):
    params = _w_out_params(cuda)
    plan = plan_from_params(params, dtype, d_out=2048, d_in=8192,
                            group_size=128)
    assert plan.values2d.shape == (16 * 2048, 128)
    x = torch.from_numpy(_x(30 + d, 8192, d)).to(cuda, dtype)
    got = rgcsr_spmm_launch(plan, x, piece_rows=piece_rows)
    args = (plan.values2d, plan.columns2d, plan.step_group)
    want = rgcsr_spmm_plain(*args, x, n_groups=16)
    # |got - want| <= tol · (1 + Σ_j |w_ij x_j|): sums of 2,048 terms
    scale = rgcsr_spmm_plain(plan.values2d.float().abs(), plan.columns2d,
                             plan.step_group, x.float().abs(), n_groups=16)
    diff = (got.float() - want.float()).abs()
    assert got.shape == (2048, d) and got.dtype == dtype
    assert bool((diff <= tol * (1 + scale)).all()), diff.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("piece_rows", [None, 64])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("n,rank", [(2, 1), (4, 2)])
@pytest.mark.parametrize("d", [1, 256])
def test_k2_on_a_rank_s_lane_slice_plan_matches_plain(cuda, d, n, rank,
                                                      dtype, tol,
                                                      piece_rows):
    """K2 on a tensor-parallel rank's lane plan of granite-3-2b's w_out
    (``SparseLinear.lane_plan``): G = 128 over 2 and 4 model ranks, 64-
    and 32-lane groups, against the plain version on the same slice; one
    launch a call, one plan a (dtype, view)."""
    params = _w_out_params(cuda)
    lanes = 128 // n
    part = {k: (v[:, rank * lanes:(rank + 1) * lanes].contiguous()
                if k in ("values2d", "columns2d") else v)
            for k, v in params.items()}
    layer = ffn.SparseLinear(part, _granite(), d_in=8192, d_out=2048)
    view = type("View", (), {"size": n, "rank": rank})()
    plan = layer.lane_plan(dtype, view)
    assert layer.lane_plan(dtype, view) is plan and layer.plan_builds == 1
    assert plan.group_size == lanes and plan.values2d.shape == (
        16 * 2048, lanes)
    x = torch.from_numpy(_x(60 + d, 8192, d)).to(cuda, dtype)
    before = launch_counts()["rgcsr_spmm"]
    got = rgcsr_spmm_launch(plan, x, piece_rows=piece_rows)
    assert launch_counts()["rgcsr_spmm"] == before + 1
    args = (plan.values2d, plan.columns2d, plan.step_group)
    want = rgcsr_spmm_plain(*args, x, n_groups=16)
    scale = rgcsr_spmm_plain(plan.values2d.float().abs(), plan.columns2d,
                             plan.step_group, x.float().abs(), n_groups=16)
    diff = (got.float() - want.float()).abs()
    assert got.shape == (16 * lanes, d) and got.dtype == dtype
    assert bool((diff <= tol * (1 + scale)).all()), diff.max().item()


@pytest.mark.gpu
def test_sparse_linear_on_cuda_never_runs_the_plain_version(cuda,
                                                            monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain K2 ran on a CUDA tensor")

    want = {}
    cfg = _granite()
    for dev in ("cpu", cuda):
        params = {k: v.to(dev) for k, v in _w_out_params(cuda).items()}
        layer = ffn.SparseLinear(params, cfg, d_in=8192, d_out=2048)
        x = torch.from_numpy(_x(40, 3, 8192)).to(dev)
        if dev == "cpu":
            want = layer(x)
            continue
        monkeypatch.setattr(k2_module, "rgcsr_spmm_plain", refuse)
        before = launch_counts()["rgcsr_spmm"]
        got = layer(x)
        assert launch_counts()["rgcsr_spmm"] == before + 1
        assert layer.plan_builds == 1
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_sparse_linear_builds_one_work_list_per_new_width(cuda):
    """``host_build`` through ``SparseLinear`` at two prefill widths: its
    K2 plan once, then K2's work list once for each width it has not seen
    (``part_bytes`` G·d·4), and nothing for a width it has."""
    from repro_torch.obs import trace
    layer = ffn.SparseLinear(_w_out_params(cuda), _granite(), d_in=8192,
                             d_out=2048)
    with trace.recording(trace.Tracer()) as tr:
        for t in (96, 160, 96, 160):
            layer(torch.from_numpy(_x(70 + t, t, 8192)).to(cuda))
    builds = [ev["args"] for ev in tr.events if ev["name"] == "host_build"]
    assert [b["what"] for b in builds] == ["sparse_linear_plan",
                                           "work_list", "work_list"]
    assert [b["key"] for b in builds[1:]] == [
        repr(("rgcsr_spmm", torch.cuda.get_device_properties(
            cuda).multi_processor_count, 128 * t * 4, None))
        for t in (96, 160)]
    assert sum(ev["name"] == "sparse.launch" and ev["ph"] == "B"
               for ev in tr.events) == 4


@pytest.mark.gpu
def test_full_width_generate_launches_k2_once_per_layer_and_token(cuda):
    """Two layers of granite-3-2b at full width: K2 launches once per layer
    for the prefill and once per layer for each decode step; no other
    kernel launches; each layer's plan is built once, at load."""
    cfg = _granite(n_layers=2)
    engine = Engine(cfg, ServeConfig(max_seq=64), device=cuda)
    assert engine.plans_warmed == 2
    prompts = np.random.default_rng(41).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32)
    reset_launch_counts()
    out = engine.generate(prompts, max_new_tokens=8)
    assert launch_counts() == {"rgcsr_spmv": 0, "rgcsr_spmm": 2 * 8,
                               "ell_spmv": 0, "paged_attention": 0}
    assert out.shape == (2, 8) and (out >= 0).all() \
        and (out < cfg.vocab).all()
    assert [b.ffn.w_out.plan_builds for b in engine.model.layers] == [1, 1]
    np.testing.assert_array_equal(engine.generate(prompts, 8), out)


# ------------------------------------------ serving sessions: the graph


def _smoke_rgcsr():
    """Smoke granite-3-2b (2 layers, d_model 64) with the RgCSR FFN, in
    float32 (compute and KV cache)."""
    return dataclasses.replace(
        get_smoke("granite-3-2b"), dtype="float32", kv_cache_dtype="float32",
        sparsity=SparsityConfig(enabled=True, density=0.25, group_size=128,
                                impl="kernel"))


def _session_requests(seed, lens, new):
    rng = np.random.default_rng(seed)
    return [Request(tokens=rng.integers(0, 512, (n,)).astype(np.int32),
                    max_new_tokens=new) for n in lens]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_graph_replays_equal_eager_steps(cuda, layout):
    """The captured step replayed against the same step run eagerly on the
    card (the runner with its graph taken away): equal streams, equal
    caches, and streams equal to generate() of each request alone."""
    cfg = _smoke_rgcsr()
    kw = dict(max_seq=64, n_slots=2, page_size=4, kv_layout=layout,
              decode_chunk=8)
    graph = Engine(cfg, ServeConfig(**kw), device=cuda)
    eager = Engine(cfg, ServeConfig(**kw), device=cuda)
    assert graph._loop.graph is not None
    eager._loop.graph = None
    outs = []
    for eng in (graph, eager):
        reqs = _session_requests(3, (10, 13, 7), 6)
        eng.serve(reqs)
        torch.cuda.synchronize()
        outs.append(([r.out for r in reqs], [
            {k: t.cpu() for k, t in c.items()} for c in eng._loop.caches]))
    assert outs[0][0] == outs[1][0]
    for a, b in zip(outs[0][1], outs[1][1]):
        for key in a:
            torch.testing.assert_close(a[key], b[key], rtol=1e-6, atol=1e-6)
    for r_out, r in zip(outs[0][0], _session_requests(3, (10, 13, 7), 6)):
        assert r_out == list(graph.generate(r.tokens[None, :], 6)[0])


def _smoke_family(arch, dispatch=None):
    """A family's smoke config in float32; minicpm3-4b and
    recurrentgemma-9b with the RgCSR FFN (K2), the MoE families with
    ``dispatch`` when given."""
    over = dict(dtype="float32", kv_cache_dtype="float32")
    cfg = get_smoke(arch)
    if arch in ("minicpm3-4b", "recurrentgemma-9b"):
        over["sparsity"] = SparsityConfig(enabled=True, density=0.25,
                                          group_size=128, impl="kernel")
    if dispatch:
        over["moe"] = dataclasses.replace(cfg.moe, dispatch=dispatch)
    return dataclasses.replace(cfg, **over)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("arch,dispatch", [
    ("granite-moe-1b-a400m", "einsum"), ("granite-moe-1b-a400m", "scatter"),
    ("minicpm3-4b", None), ("deepseek-v3-671b", "einsum"),
    ("mamba2-780m", None), ("recurrentgemma-9b", None)])
def test_moe_and_mla_graph_replays_equal_eager_steps(cuda, arch, dispatch,
                                                     layout):
    """The MoE routing and dispatch, the MLA decode (latent pages or
    slabs) and the recurrent steps (conv tail, SSD and RG-LRU states, each
    written through ``where(live, ...)``) captured in the decode graph —
    no host sync in the step, or the capture raises — replayed against
    the same step run eagerly on the card: equal streams, caches within
    1e-5 (the scatter dispatch's ``index_add_`` sums with atomics on the
    card), and streams equal to generate() of each request alone."""
    cfg = _smoke_family(arch, dispatch)
    kw = dict(max_seq=64, n_slots=2, page_size=4, kv_layout=layout,
              decode_chunk=8)
    graph = Engine(cfg, ServeConfig(**kw), device=cuda)
    eager = Engine(cfg, ServeConfig(**kw), device=cuda)
    assert graph._loop.graph is not None
    eager._loop.graph = None
    outs = []
    for eng in (graph, eager):
        reqs = _session_requests(8, (10, 13, 7), 6)
        eng.serve(reqs)
        torch.cuda.synchronize()
        outs.append(([r.out for r in reqs], [
            {k: t.cpu() for k, t in c.items()} for c in eng._loop.caches]))
    assert outs[0][0] == outs[1][0]
    for a, b in zip(outs[0][1], outs[1][1]):
        for key in a:
            torch.testing.assert_close(a[key], b[key], rtol=1e-5, atol=1e-5)
    for r_out, r in zip(outs[0][0], _session_requests(8, (10, 13, 7), 6)):
        assert r_out == list(graph.generate(r.tokens[None, :], 6)[0])
    if arch == "minicpm3-4b":
        assert graph._loop.launches_per_replay == {"rgcsr_spmm": 2}
    if arch == "recurrentgemma-9b":
        assert graph._loop.launches_per_replay == {"rgcsr_spmm": 8}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_dead_graph_replays_leave_the_recurrent_states_alone(cuda, arch):
    """A replay of the captured step after the chunk's ``n_steps`` ran
    (not live) leaves every recurrent state and index bit for bit; a
    live chunk after it moves each state and goes on as generate()."""
    cfg = _smoke_family(arch)
    eng = Engine(cfg, ServeConfig(max_seq=64, n_slots=2, page_size=4,
                                  decode_chunk=4), device=cuda)
    reqs = _session_requests(11, (5, 2), 9)
    sess = eng.start_session(reqs)
    sess.step(3)
    loop = eng._loop
    states = [t for c in loop.caches for k, t in c.items()
              if k in ("conv", "ssm", "h")]
    held = states + [c["index"] for c in loop.caches if "index" in c]
    before = [t.clone() for t in held]
    loop.graph.replay()                    # steps_ran == n_steps: dead
    torch.cuda.synchronize()
    assert all(torch.equal(t, b) for t, b in zip(held, before))
    sess.step(1)
    assert all(not torch.equal(t, b) for t, b in zip(states, before))
    sess.drain()
    for r in reqs:
        assert r.out == list(eng.generate(r.tokens[None, :], 9)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_recurrent_prefill_and_decode_equal_a_full_forward(cuda, arch):
    """On the card, fp32: a prefill of 21 tokens (a ragged SSD chunk) and
    19 decode steps give the logits of one full forward over the 40
    tokens (past the smoke window of 32) within 1e-5."""
    from repro_torch.models import LanguageModel
    cfg = _smoke_family(arch)
    model = LanguageModel(cfg, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab, (2, 40)).astype(np.int32)).to(cuda)
    with torch.inference_mode():
        full = model({"tokens": toks})[0]
        logits, caches = model.prefill({"tokens": toks[:, :21]}, 48)
        got = [logits[:, -1]]
        for i in range(21, 40):
            logits, caches = model.decode_step(caches, toks[:, i:i + 1])
            got.append(logits[:, -1])
    torch.testing.assert_close(torch.stack(got, 1), full[:, 20:],
                               rtol=1e-5, atol=1e-5)


_RG_W_OUT = {}


@pytest.mark.gpu
@pytest.mark.parametrize("piece_rows", [None, 64])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("d", [1, 8])
def test_k2_cuda_matches_plain_at_recurrentgemma_w_out(cuda, d, dtype, tol,
                                                       piece_rows):
    """One w_out layer of recurrentgemma-9b: W (4096, 12288) at density
    0.25, 32 groups of 3,072 slot rows — 48 pieces of 64 rows each, so
    nearly all of it the split path and the combine."""
    cfg = dataclasses.replace(
        get_config("recurrentgemma-9b"), sparsity=SparsityConfig(
            enabled=True, density=0.25, group_size=128, impl="kernel"))
    if cuda not in _RG_W_OUT:
        _RG_W_OUT[cuda] = init_from_spec(
            ffn.sparse_linear_spec(cfg, cfg.d_ff, cfg.d_model),
            torch.Generator(device=cuda).manual_seed(6), device=cuda)
    plan = plan_from_params(_RG_W_OUT[cuda], dtype, d_out=4096, d_in=12288,
                            group_size=128)
    assert plan.values2d.shape == (32 * 3072, 128)
    x = torch.from_numpy(_x(50 + d, 12288, d)).to(cuda, dtype)
    got = rgcsr_spmm_launch(plan, x, piece_rows=piece_rows)
    args = (plan.values2d, plan.columns2d, plan.step_group)
    want = rgcsr_spmm_plain(*args, x, n_groups=32)
    scale = rgcsr_spmm_plain(plan.values2d.float().abs(), plan.columns2d,
                             plan.step_group, x.float().abs(), n_groups=32)
    diff = (got.float() - want.float()).abs()
    assert got.shape == (4096, d) and got.dtype == dtype
    assert bool((diff <= tol * (1 + scale)).all()), diff.max().item()


@pytest.mark.gpu
def test_graph_counts_k2_once_per_layer_and_live_step(cuda):
    cfg = _smoke_rgcsr()
    eng = Engine(cfg, ServeConfig(max_seq=64, n_slots=3, page_size=4,
                                  decode_chunk=4), device=cuda)
    assert eng._loop.launches_per_replay == {"rgcsr_spmm": 2,
                                             "paged_attention": 2}
    replays = eng._loop.replays
    reset_launch_counts()
    reqs = _session_requests(4, (8, 11, 9, 6, 12), 7)
    eng.serve(reqs)
    st = eng.paging_stats
    prefills = eng._session.prefill_count
    assert eng._loop.replays - replays == st["decode_steps"]
    assert launch_counts() == {"rgcsr_spmv": 0, "rgcsr_spmm": 2 * (
        st["decode_steps"] + prefills), "ell_spmv": 0,
        "paged_attention": 2 * st["decode_steps"]}
    assert st["decode_dispatches"] < st["decode_steps"]


@pytest.mark.gpu
def test_graph_refuses_a_rebound_cache_tensor(cuda):
    eng = Engine(_smoke_rgcsr(), ServeConfig(max_seq=64, n_slots=2,
                                             page_size=4), device=cuda)
    sess = eng.start_session(_session_requests(5, (8,), 6))
    sess.step(1)
    cache = eng._loop.caches[0]
    cache["k"] = cache["k"].clone()
    with pytest.raises(RuntimeError, match=r"caches\[0\]\['k'\]"):
        sess.step(1)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_graph_runs_past_max_seq_without_a_device_assert(cuda, layout):
    """Slot 1 stays free while slot 0 serves two requests one after the
    other: slot 1's index grows past max_seq inside the graph's chunks —
    the dense write is dropped and the page lookup clamps, as in the
    reference — and the card carries on."""
    cfg = _smoke_rgcsr()
    eng = Engine(cfg, ServeConfig(max_seq=16, n_slots=2, page_size=4,
                                  kv_layout=layout, decode_chunk=8),
                 device=cuda)
    sess = eng.start_session()
    reqs = _session_requests(6, (4, 5), 12)
    for req in reqs:
        sess.submit(req)
        sess.drain()
    torch.cuda.synchronize()
    assert int(eng._loop.caches[0]["index"][1]) > 16
    for r in reqs:
        assert r.ok_like and r.out == list(
            eng.generate(r.tokens[None, :], 12)[0])


@pytest.mark.gpu
def test_sampled_serving_replays_under_capture(cuda):
    """temperature > 0: the engine's generator is registered with the
    graph, so two engines from one seed draw the same streams, and every
    token lies in the vocab."""
    cfg = _smoke_rgcsr()
    kw = dict(max_seq=64, n_slots=2, page_size=4, decode_chunk=4,
              temperature=1.0, top_k=20, seed=7)
    streams = []
    for _ in range(2):
        eng = Engine(cfg, ServeConfig(**kw), device=cuda)
        reqs = _session_requests(7, (9, 12, 6), 10)
        eng.serve(reqs)
        streams.append([r.out for r in reqs])
    assert streams[0] == streams[1]
    assert all(0 <= t < 512 for s in streams[0] for t in s)
    assert len({t for s in streams[0] for t in s}) > 3


@pytest.mark.gpu
def test_router_replicas_share_one_model_and_keep_their_graphs(cuda):
    """Two replicas of one model behind the router, replica 1 killed at
    its decode step 2: one plan per layer for the fleet, each replica its
    own captured graph (kept across the restart), K2 once per layer per
    prefill and per replay of either graph, streams equal to generate()."""
    cfg = _smoke_rgcsr()
    fc = FaultConfig(max_restarts=3, backoff_s=0.0)
    scfg = ServeConfig(max_seq=64, n_slots=2, page_size=4, decode_chunk=8)
    first = Engine(cfg, scfg, device=cuda, fault_cfg=fc)
    second = Engine(cfg, scfg, params=first.params, fault_cfg=fc)
    second.fault_injector = FaultInjector(fail_at_steps=(("replica", 2),))
    router = Router([first, second], cfg=RouterConfig(n_replicas=2),
                    fault_cfg=fc)
    graphs = [e._loop.graph for e in (first, second)]
    assert all(g is not None for g in graphs) and graphs[0] is not graphs[1]
    prefills = []
    for e in (first, second):
        orig = e._prefill
        e._prefill = lambda batch, orig=orig: (prefills.append(1),
                                               orig(batch))[1]
    reset_launch_counts()
    reqs = _session_requests(9, (8, 11, 9, 6, 12), 7)
    router.serve(reqs)
    torch.cuda.synchronize()
    st = router.stats()
    assert st["replica_faults"] == 1 and st["migrations"] >= 1
    assert [e._loop.graph for e in (first, second)] == graphs
    assert launch_counts() == {"rgcsr_spmv": 0, "rgcsr_spmm": 2 * (
        st["decode_steps"] + len(prefills)), "ell_spmv": 0,
        "paged_attention": 2 * st["decode_steps"]}
    assert [m.plan_builds for m in first.model.modules()
            if isinstance(m, ffn.SparseLinear)] == [1, 1]
    for r in reqs:
        assert r.ok_like and r.out == list(
            first.generate(r.tokens[None, :], 7)[0])


# ---------------------------------------------- the autotuner and training


def _laplacian(nx, ny):
    """The 5-point Laplacian on an nx×ny grid as scipy CSR."""
    import scipy.sparse as sp
    eye = lambda n: sp.identity(n, format="csr")   # noqa: E731
    line = lambda n: sp.diags([-1, 2, -1], [-1, 0, 1], (n, n))  # noqa: E731
    a = (sp.kron(line(nx), eye(ny)) + sp.kron(eye(nx), line(ny))).tocsr()
    a.data = a.data.astype(np.float32)
    return a


@pytest.mark.gpu
def test_profiler_time_agrees_with_the_held_timer(cuda):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import from_csr, timing
    assert timing.profiler_available()
    a = _laplacian(1024, 1024)
    plan = ops.make_plan(from_csr(a.data, a.indices, a.indptr, a.shape,
                                  "rgcsr", device=cuda))
    x = torch.from_numpy(_x(0, a.shape[1])).to(cuda)
    fn = lambda: rgcsr_spmv_launch(plan, x)   # noqa: E731
    held = time_us(fn, calls=20, device=cuda, hold=True)
    prof = timing.profiled_time_us_group([fn], repeats=5, warmup=2)[0]
    assert abs(prof - held) <= 0.25 * held, (prof, held)
    # after a session of many kernels the profiler drops the first device
    # record of each later session: a one-kernel window still times
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(20_000):
            x.mul_(1.0)
        torch.cuda.synchronize()
    again = timing.profiled_time_us_group([fn], repeats=5, warmup=2)
    assert again is not None and abs(again[0] - held) <= 0.25 * held


@pytest.mark.gpu
def test_autotune_winners_match_scipy(cuda):
    from repro_torch.kernels import autotune
    autotune.clear_memo()
    a = skewed(7, n=3000, m=2500)
    a64 = a.astype(np.float64)
    x, xm = _x(1, a.shape[1]), _x(2, a.shape[1], 16)
    res = autotune.autotune_spmv(a, device=cuda, repeats=2)
    assert res.timing_source == "profiler"
    assert {c.ordering for c, _ in res.timings} == {"block", "adaptive"}
    plan, again = autotune.tuned_plan(a, device=cuda)
    assert again.from_memo and plan.ordering == res.config.ordering
    got = ops.rgcsr_spmv(plan, torch.from_numpy(x).to(cuda)).double().cpu()
    tol = 1e-4 * (1 + np.abs(a64) @ np.abs(x))
    assert (np.abs(got.numpy() - a64 @ x) <= tol).all()
    res = autotune.autotune_spmm(a, 16, device=cuda, repeats=2)
    assert res.timing_source == "profiler"
    c = res.config
    m = from_dense(a, "rgcsr", group_size=c.group_size, device=cuda)
    plan = ops.make_plan(m, chunks_per_step=c.chunks_per_step,
                         ordering=c.ordering,
                         spill_threshold=c.spill_threshold)
    got = ops.rgcsr_spmm(plan, torch.from_numpy(xm).to(cuda),
                         d_tile=c.d_tile).double().cpu().numpy()
    tol = 1e-4 * (1 + np.abs(a64) @ np.abs(xm))
    assert (np.abs(got - a64 @ xm) <= tol).all()
    autotune.clear_memo()


@pytest.mark.gpu
def test_sparse_linear_backward_matches_float64_dense(cuda):
    """The segment sum's backward (the training path) on the card: the
    gradients of values2d and of x against the float64 dense product."""
    cfg = dataclasses.replace(get_smoke("granite-3-2b"), dtype="float32",
                              sparsity=SparsityConfig(
                                  enabled=True, density=0.25, group_size=128,
                                  impl="ref"))
    d_in, d_out, t = 512, 256, 48
    layer = ffn.SparseLinear(init_from_spec(
        ffn.sparse_linear_spec(cfg, d_in, d_out),
        torch.Generator(device=cuda).manual_seed(3), device=cuda), cfg,
        d_in=d_in, d_out=d_out).requires_grad_(True)
    x = torch.from_numpy(_x(4, t, d_in)).to(cuda).requires_grad_(True)
    dy = torch.from_numpy(_x(5, t, d_out)).to(cuda)
    reset_launch_counts()
    gv, gx = torch.autograd.grad(layer(x), (layer.values2d, x), dy)
    assert not any(launch_counts().values())
    g = layer.values2d.shape[1]
    rows = (layer.chunk_group.long().repeat_interleave(8)[:, None] * g
            + torch.arange(g, device=cuda))
    cols = layer.columns2d.long()
    w = torch.zeros((rows.max() + 1, d_in), dtype=torch.float64,
                    device=cuda)
    w[rows, cols] = layer.values2d.detach().double()
    w = w[:d_out]
    x64, dy64 = x.detach().double(), dy.double()
    for got, want, scale in (
            (gv, (dy64.T @ x64)[rows, cols],
             (dy64.abs().T @ x64.abs())[rows, cols]),
            (gx, dy64 @ w, dy64.abs() @ w.abs())):
        assert bool(((got.double() - want).abs()
                     <= 1e-4 * (1 + scale)).all())


@pytest.mark.gpu
def test_one_smoke_train_step_on_the_card(cuda):
    from repro_torch.launch import train as launch_train
    reset_launch_counts()
    tr, (params, opt_state) = launch_train.main([
        "--smoke", "--sparse-ffn", "--steps", "2", "--seq", "16",
        "--batch", "4"])
    assert len(tr.history) == 2
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    assert tr.model.device.type == "cuda"
    assert all(t.device.type == "cuda" for t in params.values())
    assert int(opt_state["step"]) == 2
    assert not any(launch_counts().values())


def _frontend_inputs(cfg, seed, b=2, s=6, enc_len=12):
    """Tokens and the frontend's input (frames or patch embeddings)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.enc_dec:
        out["frames"] = rng.standard_normal(
            (b, enc_len, cfg.d_frontend)).astype(np.float32)
    else:
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_frontend)).astype(np.float32)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "pixtral-12b"])
def test_frontend_families_on_the_card_match_the_cpu(cuda, arch):
    """fp32 smoke configs with the RgCSR FFN, the same weights on the card
    and on the CPU, served as the reference serves them: ``_prefill`` with
    the frames or patches, then three ``_decode`` steps of the CPU's
    greedy tokens.  The card's logits within 1e-4 · (1 + max|logit|) of
    the CPU's; K2 launched once per encoder and decoder layer in the
    prefill and once per decoder layer in each step, nothing else."""
    from repro_torch.models import init_params
    cfg = dataclasses.replace(
        get_smoke(arch), dtype="float32", kv_cache_dtype="float32",
        sparsity=SparsityConfig(enabled=True, density=0.25, group_size=128,
                                impl="kernel"))
    tree = init_params(cfg, torch.Generator().manual_seed(0))
    batch = _frontend_inputs(cfg, 3)
    runs = []
    for dev in (torch.device("cpu"), cuda):
        eng = Engine(cfg, ServeConfig(max_seq=32), params=_tree_to(tree, dev),
                     device=dev)
        counts, logits_seen = [], []
        with torch.inference_mode():
            reset_launch_counts()
            logits, caches = eng._prefill({k: torch.from_numpy(v).to(dev)
                                           for k, v in batch.items()})
            counts.append(launch_counts())
            logits_seen.append(logits.cpu())
            for i in range(3):
                tok = (runs[0][0][i] if runs else logits).argmax(-1).int()
                reset_launch_counts()
                logits, caches = eng._decode(caches, tok.to(dev))
                counts.append(launch_counts())
                logits_seen.append(logits.cpu())
        runs.append((logits_seen, counts))
    (want, cpu_counts), (got, card_counts) = runs
    assert not any(n for c in cpu_counts for n in c.values())
    n_pre = cfg.n_layers + (cfg.n_enc_layers if cfg.enc_dec else 0)
    assert card_counts == [{"rgcsr_spmv": 0, "rgcsr_spmm": n_pre,
                            "ell_spmv": 0, "paged_attention": 0}] + [
        {"rgcsr_spmv": 0, "rgcsr_spmm": cfg.n_layers, "ell_spmv": 0,
         "paged_attention": 0}] * 3
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * (1 + w.abs().max().item()))


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


# ------------------------------------------------- row-sharded SpMV/SpMM


def _all_remote_shard():
    """128 × 128 over 4 shards: shard 0's rows reference no column it owns
    (an empty local plan in split mode), shard 1 holds a heavy row."""
    a = rand_sparse(22, 128, 128, 0.06)
    a[:32, :32] = 0.0
    a[:32, 100] = 1.5
    a[40, :120] = 1.0
    return a


SHARD_CONFIGS = [(1, "adaptive", 8), (4, "block", 0), (2, "block", 0),
                 (2, "adaptive", 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [1, None])
def test_k1_k2_on_padded_step_and_empty_local_plans(cuda, steps):
    """Each shard's local view of a mixed stack (padding steps, gcd
    expansion, shard 0's empty local plan) through K1 and K2 against their
    plain versions; the empty plan gives zeros."""
    a = _all_remote_shard()
    plan = ops.make_sharded_plan(ShardedRgCSR.from_dense(a, 4, device=cuda),
                                 x_mode="split", shard_configs=SHARD_CONFIGS)
    assert plan.values3d.device.type == "cpu"
    for d in range(4):
        p = plan.local(d, cuda).plan
        assert p.num_steps == plan.num_steps_max
        xv = torch.from_numpy(_x(30 + d, plan.cols_per_shard)).to(cuda)
        xm = torch.from_numpy(_x(40 + d, plan.cols_per_shard, 9)).to(cuda)
        for launch, plain, operand in ((rgcsr_spmv_launch, rgcsr_spmv_plain,
                                        xv),
                                       (rgcsr_spmm_launch, rgcsr_spmm_plain,
                                        xm)):
            got = launch(p, operand, piece_rows=_piece_rows(p, steps))
            want = plain(p.values2d, p.columns2d, p.step_group, operand,
                         n_groups=p.n_groups,
                         chunks_per_step=p.chunks_per_step)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want.reshape(got.shape),
                                       rtol=1e-5, atol=1e-5)
            if d == 0:
                assert int(p.seg_slots.sum()) == 0
                assert not got.any()


@pytest.mark.gpu
def test_sharded_spmv_on_one_nccl_rank_is_the_single_device_path(cuda,
                                                                 tmp_path):
    """World size 1 on NCCL: one shard's plan is the single-device plan,
    so K1/K2 give the same bits, one launch per call."""
    import torch.distributed as dist
    a = skewed(7, n=400, m=300)
    x = torch.from_numpy(_x(1, 300)).to(cuda)
    xm = torch.from_numpy(_x(2, 300, 9)).to(cuda)
    sm = ShardedRgCSR.from_dense(a, 1, device=cuda)
    single = ops.make_plan(from_dense(a, "rgcsr", device=cuda))
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("model",))
        for x_mode in ("replicated", "split"):
            reset_launch_counts()
            y = spmv(sm, x, mesh=mesh, x_mode=x_mode)
            ym = spmm(sm, xm, mesh=mesh, x_mode=x_mode)
            torch.cuda.synchronize()
            assert launch_counts() == {"rgcsr_spmv": 1, "rgcsr_spmm": 1,
                                       "ell_spmv": 0, "paged_attention": 0}
            assert torch.equal(y, ops.rgcsr_spmv(single, x))
            assert torch.equal(ym, ops.rgcsr_spmm(single, xm))
            full = ops.gather_sharded_rows(
                ops.get_sharded_plan(sm, x_mode=x_mode), y, mesh=mesh,
                axis="model")
            assert torch.equal(full, y)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_sharded_spmv_on_two_gloo_ranks_sharing_the_card(cuda, tmp_path):
    """Two spawned ranks on cuda:0 over gloo (its CUDA all-to-all stages
    through the host): every ordering in both x modes within 1e-4 of the
    dense product, K1 and K2 launched on both ranks."""
    import scipy.sparse as sp
    cases = []
    for name, a in (("skew", skewed(8)), ("remote", _all_remote_shard())):
        c = sp.csr_matrix(a)
        cases.append((name, (c.data, c.indices, c.indptr, c.shape),
                      _x(3, a.shape[1]), _x(4, a.shape[1], 9), "float32"))
    outs = run_ranks(tmp_path, 2, sweep, cases, "cuda")
    for o in outs:
        assert o["launches"]["rgcsr_spmv"] > 0
        assert o["launches"]["rgcsr_spmm"] > 0
    dense = {name: sp.csr_matrix((v, c, p), shape=shape).toarray().astype(
        np.float64) for name, (v, c, p, shape), _, _, _ in cases}
    xs = {name: (x, xm) for name, _, x, xm, _ in cases}
    for (name, x_mode, label, kind), got in outs[0]["results"].items():
        x, xm = xs[name]
        want = dense[name] @ (x if kind == "spmv" else xm)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{name} {x_mode} {label} {kind}")


@pytest.mark.gpu
def test_sharded_training_on_four_gloo_ranks_sharing_the_card(cuda,
                                                              tmp_path):
    """Four spawned ranks on cuda:0 over gloo, a (2, 2) mesh: three steps
    of smoke granite-3-2b with the RgCSR FFN under AdamW and Adafactor
    within 1e-4 relative of the port's single-device trainer on the card
    (CUDA's ``index_add_`` adds in no fixed order); every slice laid out
    by its placements; the launcher's ``--mesh`` and its ``done:`` line;
    the MoE cases (their counts all-gathered as int32 over gloo) within
    1e-4 relative of one device."""
    from repro_torch.train.trainer import Trainer
    ranks = run_ranks(tmp_path, 4, train_ranks, str(tmp_path / "ckpt"),
                      (2, 2), ("data", "model"), "granite-3-2b", "cuda")
    for opt in ("adamw", "adafactor"):
        tr = Trainer(sharded_cfg(), train_config(opt), device="cuda")
        tr.run(tr.init_state(seq_len=SEQ, global_batch=BATCH))
        for res in ranks:
            for g, w in zip(res[opt]["history"], tr.history, strict=True):
                for k in ("loss", "grad_norm"):
                    assert abs(g[k] - w[k]) <= 1e-4 * abs(w[k]), (opt, k)
            whole = ranks[0][opt]["whole"]
            for key, (local, placements) in res[opt]["local"].items():
                cut = list(whole[key].shape)
                for pl in placements:
                    if pl.startswith("S("):
                        cut[int(pl[2:-1])] //= 2
                assert tuple(cut) == local, key
    assert ranks[0]["launcher"].strip().splitlines()[-1].startswith(
        "done: 3 steps, final loss ")
    for case in MOE_CASES:
        tr = moe_trainer(case, "cuda")
        tr.run(tr.init_state(seq_len=SEQ, global_batch=BATCH))
        for res in ranks:
            for g, w in zip(res["moe"][case]["history"], tr.history,
                            strict=True):
                for k in ("loss", "load_balance", "grad_norm"):
                    assert abs(g[k] - w[k]) <= 1e-4 * abs(w[k]), (case, k)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-v3-671b"])
@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_split_moe_dispatch_on_the_card_matches_the_cpu(cuda, arch,
                                                        dispatch):
    """A MoE layer's rows split in two (``row_shard``, the counts gathered
    in process), train mode at capacity factor 0.5 so that copies drop:
    each shard's outputs and aux shares on the card within 1e-5 of the
    same shard on the CPU, and the kept copies the same."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32",
                              moe=dataclasses.replace(
                                  get_smoke(arch).moe, dispatch=dispatch,
                                  capacity_factor=0.5))
    layer = moe.MoE(init_from_spec(moe.moe_spec(cfg),
                                   torch.Generator().manual_seed(5),
                                   device="cpu"), cfg)
    layers = {"cpu": layer, "cuda": copy.deepcopy(layer).to(cuda)}
    x = torch.from_numpy(_x(6, 4, 16, cfg.d_model))
    outs = {}
    for d, layer in layers.items():
        xd = x.to(cuda if d == "cuda" else "cpu")
        _, shards = row_shards(layer, cfg, xd.reshape(-1, cfg.d_model), 2)
        outs[d] = []
        for rows, s in zip(xd.chunk(2), shards):
            with moe.row_shard(s):
                y, aux = moe.moe_apply(layer, cfg, rows)
            _, _, _, offset = moe._routing_shard(
                layer, cfg, rows.reshape(-1, cfg.d_model), s)
            idx = moe._routing(layer, cfg, rows.reshape(-1, cfg.d_model))[0]
            _, keep = moe._positions(cfg, idx, moe._capacity(cfg, 64),
                                     offset)
            outs[d].append((y, aux, keep))
    for (y, aux, keep), (yc, auxc, keepc) in zip(outs["cuda"], outs["cpu"]):
        assert y.device.type == cuda.type
        assert torch.equal(keep.cpu(), keepc)
        torch.testing.assert_close(y.cpu(), yc, rtol=1e-5, atol=1e-5)
        for k in ("load_balance", "router_z", "expert_fraction"):
            torch.testing.assert_close(aux[k].cpu(), auxc[k], rtol=1e-5,
                                       atol=1e-6)
    kept = sum(int(k.sum()) for _, _, k in outs["cpu"])
    assert kept < 64 * cfg.moe.top_k          # copies were dropped


@pytest.mark.gpu
@pytest.mark.parametrize("arch,sparse", [("granite-3-2b", True),
                                         ("granite-moe-1b-a400m", False)])
def test_remat_dots_on_the_card_equals_none(cuda, arch, sparse):
    """``remat="dots"`` (the matrix products kept, the rest recomputed) on
    the card: the loss and every gradient within 1e-6 of ``"none"``."""
    cfg = sharded_cfg(arch, sparse)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in
             _batch_of(cfg).items()}
    runs = {}
    for remat in ("none", "dots"):
        model = LanguageModel(dataclasses.replace(cfg, remat=remat),
                              device=cuda).requires_grad_(True)
        loss, _ = model.loss(batch)
        loss.backward()
        runs[remat] = (loss.detach(), {k: p.grad for k, p in
                                       model.named_parameters()
                                       if p.grad is not None})
    (loss, grads), (want_loss, want) = runs["dots"], runs["none"]
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=1e-6)
    assert grads.keys() == want.keys() and grads
    for k, g in grads.items():
        torch.testing.assert_close(g, want[k], rtol=1e-6, atol=1e-6)


def _batch_of(cfg):
    from repro_torch.train.data import DataConfig, make_batch
    return make_batch(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                 global_batch=BATCH, seed=0), 0)


@pytest.mark.gpu
def test_the_dry_run_predicts_the_card_s_step(cuda):
    """granite-3-2b's smoke config, one device, 8 × 256 tokens in 2
    microbatches, AdamW (``scripts/torch_dryrun_check.py``): the dry run's
    product FLOPs (``launch.dryrun``, on meta tensors) equal
    ``FlopCounterMode``'s count of the real step on the card, its
    arguments are the card's to the byte, and arguments plus temporaries
    fall within 15 % of the step's ``max_memory_allocated`` — counted
    above what the card held besides the arguments before the step (the
    cuBLAS workspace and the warm-up step's leftovers are not the
    step's)."""
    spec = importlib.util.spec_from_file_location(
        "torch_dryrun_check", REPO / "scripts" / "torch_dryrun_check.py")
    check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check)
    got = check.measure(cuda)
    assert got["flops"][0] == got["flops"][1] > 0
    assert got["arguments"][0] == got["arguments"][1]
    predicted = got["arguments"][0] + got["temporaries"][0]
    measured = got["arguments"][1] + got["temporaries"][1]
    assert abs(predicted - measured) <= 0.15 * measured, (predicted,
                                                          measured)
