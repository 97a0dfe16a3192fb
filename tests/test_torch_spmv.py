"""The port's SpMV / SpMM against ``repro.core.spmv`` for all seven formats.

Same inputs (numpy, from a seed) through both packages.  fp32 must be within
rtol = atol = 1e-5 of the reference and 1e-4 of ``a @ x``
(tests/test_kernels.py:42-43); the sums are the same terms in another
order, so only rounding separates them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rand_sparse, skewed

import repro.core.formats as ref_formats
from repro.core import spmm as ref_spmm, spmv as ref_spmv
from repro_torch.core import FORMATS, from_dense, spmm, spmv
from repro_torch.core.spmv import _use_kernel
from repro_torch.kernels.ops import PLAN_CACHE, ell_spmv, make_ell_plan

torch.set_num_threads(1)

CASES = {
    "small": (0, 64, 64, 0.1),
    "ragged": (1, 300, 257, 0.05),
    "wide": (2, 130, 1000, 0.01),
}


def _inputs(case, d=5):
    seed, n, m, density = CASES[case]
    a = rand_sparse(seed, n, m, density)
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal(m).astype(np.float32)
    xm = rng.standard_normal((m, d)).astype(np.float32)
    return a, x, xm


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_spmv_spmm_match_reference(case, fmt):
    a, x, xm = _inputs(case)
    ref_m = ref_formats.from_dense(a, fmt)
    port_m = from_dense(a, fmt, device="cpu")
    y_ref = np.asarray(ref_spmv(ref_m, jnp.asarray(x), impl="ref"))
    y = spmv(port_m, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y, a @ x, rtol=1e-4, atol=1e-4)
    ym_ref = np.asarray(ref_spmm(ref_m, jnp.asarray(xm), impl="ref"))
    ym = spmm(port_m, torch.from_numpy(xm)).numpy()
    np.testing.assert_allclose(ym, ym_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ym, a @ xm, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ordering,spill", [("block", 0), ("adaptive", 0),
                                            ("adaptive", 6)])
@pytest.mark.parametrize("cps", (1, 4))
def test_rgcsr_kernel_dispatch_matches_reference_oracle(cps, ordering, spill):
    """``impl='kernel'`` on CPU tensors runs the kernels' plain versions
    through the plan cache; results equal the reference's oracle."""
    a = skewed(11)
    x = np.random.default_rng(12).standard_normal(a.shape[1]).astype(
        np.float32)
    xm = np.random.default_rng(13).standard_normal((a.shape[1], 9)).astype(
        np.float32)
    ref_m = ref_formats.from_dense(a, "rgcsr")
    port_m = from_dense(a, "rgcsr", device="cpu")
    kw = dict(impl="kernel", chunks_per_step=cps, ordering=ordering,
              spill_threshold=spill)
    before = PLAN_CACHE.stats()["misses"]
    y = spmv(port_m, torch.from_numpy(x), **kw).numpy()
    ym = spmm(port_m, torch.from_numpy(xm), **kw).numpy()
    assert PLAN_CACHE.stats()["misses"] == before + 1
    np.testing.assert_allclose(
        y, np.asarray(ref_spmv(ref_m, jnp.asarray(x), impl="ref")),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        ym, np.asarray(ref_spmm(ref_m, jnp.asarray(xm), impl="ref")),
        rtol=1e-5, atol=1e-5)


def test_auto_dispatch_rule():
    """``auto`` takes the kernel for CUDA tensors (where ``make_plan`` raises
    outside the kernels' domain, see tests/test_torch_gpu.py); CPU matrices
    stay on the oracle and build no plan."""
    a = rand_sparse(14, 100, 100, 0.05)
    m = from_dense(a, "rgcsr", device="cpu")
    assert not _use_kernel(m, "auto")
    assert _use_kernel(m, "kernel")
    assert not _use_kernel(m, "ref")
    m64 = from_dense(a, "rgcsr", group_size=64, device="cpu")
    assert not _use_kernel(m64, "auto")
    with pytest.raises(ValueError, match="group_size"):
        spmv(m64, torch.zeros(100), impl="kernel")
    assert not _use_kernel(from_dense(a, "csr", device="cpu"), "kernel")
    before = PLAN_CACHE.stats()
    spmv(m, torch.zeros(100))
    assert PLAN_CACHE.stats() == before
    for fmt in FORMATS:
        with pytest.raises(ValueError, match="unknown impl"):
            spmv(from_dense(a, fmt, device="cpu"), torch.zeros(100),
                 impl="pallas")


def test_empty_matrix():
    a = np.zeros((0, 40), np.float32)
    for fmt in FORMATS:
        m = from_dense(a, fmt, device="cpu")
        assert spmv(m, torch.zeros(40)).shape == (0,)
        assert spmm(m, torch.zeros(40, 3)).shape == (0, 3)
    m = from_dense(a, "rgcsr", device="cpu")
    assert spmv(m, torch.zeros(40), impl="kernel", ordering="adaptive",
                spill_threshold=4).shape == (0,)


def test_zero_column_matrix_through_the_kernels():
    """The kernels read x unpadded; padding slots point at column 0, so an
    empty x is replaced by one zero row and the product is all zeros."""
    a = np.zeros((5, 0), np.float32)
    m = from_dense(a, "rgcsr", device="cpu")
    for kw in ({}, {"ordering": "adaptive", "spill_threshold": 2}):
        assert torch.equal(spmv(m, torch.zeros(0), impl="kernel", **kw),
                           torch.zeros(5))
        assert torch.equal(spmm(m, torch.zeros(0, 3), impl="kernel", **kw),
                           torch.zeros(5, 3))
    plan = make_ell_plan(from_dense(a, "ellpack", device="cpu"))
    assert torch.equal(ell_spmv(plan, torch.zeros(0)), torch.zeros(5))
