"""K1, K2 and K3: the plain versions against the reference kernels, and the
CUDA kernels against the plain versions.

On the CPU each wrapper runs its kernel's plain PyTorch version; those are
held against ``repro.kernels.ops`` run with ``interpret=True`` at the
reference's tolerances (tests/test_kernels.py:42-56): fp32 within 1e-5 of
the reference and 1e-4 of ``a @ x``, bf16 within 3e-2.  The port sums in
fp32 and rounds once; the reference accumulates bf16 outputs in bf16, so
its bf16 error is the larger and 3e-2 covers both.

The CUDA kernels themselves are held against these plain versions on the
card in tests/test_torch_gpu.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ell_counts_csr, numpy_fields, rand_sparse, skewed

import repro.core.formats as ref_formats
import repro.kernels.ops as ref_ops
from repro_torch.core import from_csr, from_dense, from_numpy
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels.ell_spmv import ell_spmv_launch, ell_spmv_plain
from repro_torch.kernels.rgcsr_spmm import rgcsr_spmm_launch
from repro_torch.kernels.rgcsr_spmv import rgcsr_spmv_launch

torch.set_num_threads(1)


def _pair(a, **kw):
    ref = ref_formats.from_dense(a, "rgcsr", **kw)
    return ref, from_numpy("rgcsr", numpy_fields(ref), device="cpu")


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# --------------------------------------------------------- K1 plain version


@pytest.mark.parametrize("n,m,density,g", [
    (64, 64, 0.1, 128),        # fewer rows than one group
    (300, 257, 0.08, 128),     # ragged rows+cols
    (513, 300, 0.02, 256),     # larger group
    (130, 1000, 0.01, 128),    # wide
])
def test_k1_plain_matches_reference_kernel(n, m, density, g):
    a = rand_sparse(0, n, m, density)
    ref_m, port_m = _pair(a, group_size=g)
    x = _x(1, m)
    want = np.asarray(ref_ops.rgcsr_spmv(ref_ops.make_plan(ref_m),
                                         jnp.asarray(x), interpret=True))
    got = ops.rgcsr_spmv(ops.make_plan(port_m), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, a @ x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cps,spill", [(2, 0), (4, 6), (8, 6)])
def test_k1_plain_adaptive_matches_reference_kernel(cps, spill):
    a = skewed(2)
    ref_m, port_m = _pair(a)
    x = _x(3, a.shape[1])
    kw = dict(chunks_per_step=cps, ordering="adaptive", spill_threshold=spill)
    want = np.asarray(ref_ops.rgcsr_spmv(ref_ops.make_plan(ref_m, **kw),
                                         jnp.asarray(x), interpret=True))
    got = ops.rgcsr_spmv(ops.make_plan(port_m, **kw),
                         torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, a @ x, rtol=1e-4, atol=1e-4)


def test_k1_x_tile_gives_the_same_y():
    """The reference tiles x to bound VMEM; the port reads x whole, so every
    x_tile gives the same y (and the reference's, to rounding)."""
    a = rand_sparse(5, 130, 1000, 0.02)
    ref_m, port_m = _pair(a)
    x = _x(6, 1000)
    plan = ops.make_plan(port_m, chunks_per_step=2)
    base = ops.rgcsr_spmv(plan, torch.from_numpy(x)).numpy()
    for xt in (128, 256, 384):
        got = ops.rgcsr_spmv(plan, torch.from_numpy(x), x_tile=xt).numpy()
        np.testing.assert_array_equal(got, base)
        want = np.asarray(ref_ops.rgcsr_spmv(
            ref_ops.make_plan(ref_m, chunks_per_step=2), jnp.asarray(x),
            interpret=True, x_tile=xt))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_k1_plain_bf16():
    a = rand_sparse(2, 200, 200, 0.05)
    _, port_m = _pair(a)
    plan = ops.make_plan(port_m)
    plan = dataclasses.replace(plan, values2d=plan.values2d.bfloat16())
    x = torch.from_numpy(_x(3, 200)).bfloat16()
    got = ops.rgcsr_spmv(plan, x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), a @ x.float().numpy(),
                               rtol=3e-2, atol=3e-1)


# --------------------------------------------------------- K2 plain version


@pytest.mark.parametrize("d", [1, 7, 64, 129])
def test_k2_plain_matches_reference_kernel(d):
    a = rand_sparse(4, 150, 140, 0.07)
    ref_m, port_m = _pair(a)
    x = _x(5, 140, d)
    want = np.asarray(ref_ops.rgcsr_spmm(ref_ops.make_plan(ref_m),
                                         jnp.asarray(x), interpret=True))
    got = ops.rgcsr_spmm(ops.make_plan(port_m), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (150, d)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, a @ x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cps,ordering,spill", [(4, "block", 0),
                                                (2, "adaptive", 6)])
def test_k2_plain_coarsened_and_adaptive(cps, ordering, spill):
    a = skewed(7)
    ref_m, port_m = _pair(a)
    x = _x(8, a.shape[1], 9)
    kw = dict(chunks_per_step=cps, ordering=ordering, spill_threshold=spill)
    want = np.asarray(ref_ops.rgcsr_spmm(ref_ops.make_plan(ref_m, **kw),
                                         jnp.asarray(x), interpret=True))
    got = ops.rgcsr_spmm(ops.make_plan(port_m, **kw),
                         torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------- K3 plain version


@pytest.mark.parametrize("n,m,density", [(200, 150, 0.04), (77, 300, 0.1)])
def test_k3_plain_matches_reference_kernel(n, m, density):
    a = rand_sparse(9, n, m, density)
    x = _x(10, m)
    want = np.asarray(ref_ops.ell_spmv(
        ref_ops.make_ell_plan(ref_formats.from_dense(a, "ellpack")),
        jnp.asarray(x), interpret=True))
    plan = ops.make_ell_plan(from_dense(a, "ellpack", device="cpu"))
    got = ops.ell_spmv(plan, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, a @ x, rtol=1e-4, atol=1e-4)
    padded = ell_spmv_launch(plan, torch.from_numpy(x)).numpy()
    assert padded.shape == (plan.values2d.shape[1],)
    np.testing.assert_array_equal(padded[:n], got)


def _k3_by_rule(plan, x):
    """K3's reading rule on the host: row r sums, in slot order, only the
    slots below its segment's count."""
    count = np.repeat(plan.seg_slots.numpy(), ops.SEGMENT)
    vals = plan.values2d.float().numpy()
    prods = vals * x[plan.columns2d.numpy()]
    keep = np.arange(vals.shape[0])[:, None] < count[None, :]
    return np.where(keep, prods, 0.0).sum(0)


@pytest.mark.parametrize("k_max", [8, 16])
def test_k3_rule_reads_no_slot_past_the_counts(k_max):
    """Slots past each segment's count, poisoned with NaN after the counts
    are derived, change nothing under K3's rule, which gives the plain
    version's result on the clean plan; every count 0..K_pad occurs."""
    csr, counts = ell_counts_csr(50 + k_max, k_max, 4 * (k_max + 1) + 3)
    plan = ops.make_ell_plan(from_csr(*csr, "ellpack", device="cpu"))
    assert plan.values2d.shape[0] == k_max
    assert set(counts.tolist()) == set(range(k_max + 1))
    x = _x(51, csr[3][1])
    want = ell_spmv_plain(plan.values2d, plan.columns2d,
                          torch.from_numpy(x)).numpy()
    count = np.repeat(plan.seg_slots.numpy(), ops.SEGMENT)
    past = np.arange(k_max)[:, None] >= count[None, :]
    poisoned = dataclasses.replace(plan, values2d=torch.from_numpy(
        np.where(past, np.nan, plan.values2d.numpy()).astype(np.float32)))
    assert poisoned.seg_slots is plan.seg_slots
    got = _k3_by_rule(poisoned, x)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_k3_launcher_refuses_counts_that_do_not_match():
    plan = ops.make_ell_plan(from_dense(rand_sparse(52, 200, 90, 0.05),
                                        "ellpack", device="cpu"))
    x = torch.zeros(90)
    for seg in (plan.seg_slots[:-1], plan.seg_slots.long(),
                plan.seg_slots[:, None]):
        with pytest.raises(ValueError, match="seg_slots"):
            ell_spmv_launch(dataclasses.replace(plan, seg_slots=seg), x)


# ------------------------------------------------------- wrapper contracts


def test_cpu_runs_count_no_launches():
    a = rand_sparse(11, 100, 90, 0.05)
    m = from_dense(a, "rgcsr", device="cpu")
    before = launch_counts()
    plan = ops.make_plan(m)
    ops.rgcsr_spmv(plan, torch.zeros(90))
    ops.rgcsr_spmm(plan, torch.zeros(90, 4))
    ops.ell_spmv(ops.make_ell_plan(from_dense(a, "ellpack", device="cpu")),
                 torch.zeros(90))
    assert launch_counts() == before


def test_launchers_refuse_tensors_neither_on_cpu_nor_cuda():
    """Only CPU tensors reach a plain version; anything else must launch the
    kernel or raise — here the meta device, which has no kernel."""
    meta = dict(device="meta")
    vals = torch.empty(8, 128, **meta)
    cols = torch.empty(8, 128, dtype=torch.int32, **meta)
    sg = torch.zeros(1, dtype=torch.int32, **meta)
    plan = ops.RgCSRPlan(
        values2d=vals, columns2d=cols, step_group=sg, step_first=sg,
        n_rows=128, n_cols=128, n_groups=1, group_size=128,
        group_step_ptr=torch.zeros(2, dtype=torch.int32, **meta),
        seg_slots=torch.zeros(1, 4, dtype=torch.int32, **meta))
    x = torch.empty(128, **meta)
    with pytest.raises(ValueError, match="CUDA device"):
        rgcsr_spmv_launch(plan, x)
    with pytest.raises(ValueError, match="CUDA device"):
        rgcsr_spmm_launch(plan, x.reshape(128, 1))
    ell = ops.EllPlan(values2d=vals, columns2d=cols, n_rows=128, n_cols=128,
                      seg_slots=torch.zeros(4, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="CUDA device"):
        ell_spmv_launch(ell, x)


def test_wrappers_check_x_against_the_plan():
    m = from_dense(rand_sparse(12, 50, 40, 0.1), "rgcsr", device="cpu")
    plan = ops.make_plan(m)
    with pytest.raises(ValueError, match="40 rows"):
        ops.rgcsr_spmv(plan, torch.zeros(41))
    with pytest.raises(ValueError, match="40 rows"):
        ops.rgcsr_spmm(plan, torch.zeros(40))
