"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test is marked ``gpu`` and skips itself when no CUDA card is present
(decided in the ``cuda`` fixture, never at import).  This file imports
neither jax nor the JAX package, so it runs where only PyTorch is
installed::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: fp32 within rtol = atol = 1e-5, bf16 within 3e-2; kernel and
plain version both sum in fp32 and differ only in summation order.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import rand_sparse, skewed

from repro_torch.core import from_dense, spmm, spmv
from repro_torch.core.timing import time_us
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels.ell_spmv import ell_spmv_launch, ell_spmv_plain
from repro_torch.kernels.rgcsr_spmm import rgcsr_spmm_launch, rgcsr_spmm_plain
from repro_torch.kernels.rgcsr_spmv import rgcsr_spmv_launch, rgcsr_spmv_plain


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("cps,ordering,spill", [(1, "block", 0),
                                                (4, "block", 0),
                                                (2, "adaptive", 6)])
def test_k1_cuda_matches_plain(cuda, cps, ordering, spill, dtype, tol):
    plan = _cuda_plan(skewed(13, n=700, m=650), cuda, chunks_per_step=cps,
                      ordering=ordering, spill_threshold=spill)
    plan = dataclasses.replace(plan, values2d=plan.values2d.to(dtype))
    x_pad = torch.from_numpy(_x(14, 768)).to(cuda, dtype)
    args = (plan.values2d, plan.columns2d, plan.step_group)
    before = launch_counts()["rgcsr_spmv"]
    got = rgcsr_spmv_launch(*args, plan.group_step_ptr, x_pad,
                            chunks_per_step=cps)
    assert launch_counts()["rgcsr_spmv"] == before + 1
    want = rgcsr_spmv_plain(*args, x_pad, n_groups=plan.n_groups,
                            chunks_per_step=cps)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("d,d_tile", [(1, 128), (64, 128), (129, 128),
                                      (100, 64)])
def test_k2_cuda_matches_plain(cuda, d, d_tile):
    plan = _cuda_plan(skewed(15, n=400, m=300), cuda, chunks_per_step=2)
    x = torch.from_numpy(_x(16, 300, d)).to(cuda)
    args = (plan.values2d, plan.columns2d, plan.step_group)
    before = launch_counts()["rgcsr_spmm"]
    got = rgcsr_spmm_launch(*args, plan.group_step_ptr, x,
                            chunks_per_step=2, d_tile=d_tile)
    assert launch_counts()["rgcsr_spmm"] == before + 1
    want = rgcsr_spmm_plain(*args, x, n_groups=plan.n_groups,
                            chunks_per_step=2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_k3_cuda_matches_plain(cuda):
    a = rand_sparse(17, 1000, 900, 0.01)
    plan = ops.make_ell_plan(from_dense(a, "ellpack", device=cuda))
    x_pad = torch.from_numpy(_x(18, 1024)).to(cuda)
    before = launch_counts()["ell_spmv"]
    got = ell_spmv_launch(plan.values2d, plan.columns2d, x_pad)
    assert launch_counts()["ell_spmv"] == before + 1
    want = ell_spmv_plain(plan.values2d, plan.columns2d, x_pad)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


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
def test_time_us_times_back_to_back_launches(cuda):
    """A positive device time per call; each repeat makes ``calls`` calls
    after the warmup."""
    plan = ops.make_ell_plan(from_dense(rand_sparse(23, 300, 300, 0.02),
                                        "ellpack", device=cuda))
    x = torch.from_numpy(_x(24, 300)).to(cuda)
    before = launch_counts()["ell_spmv"]
    t = time_us(ops.ell_spmv, plan, x, repeats=3, warmup=1, calls=4)
    assert 0 < t < 1e6
    assert launch_counts()["ell_spmv"] == before + 1 + 3 * 4
