"""Row-sharded RgCSR SpMV/SpMM (DESIGN.md §11–§12) against the reference.

In process: ``ShardedRgCSR``, the stacked plan (both x modes, uniform and
per-shard configs, the gcd expansion) and the shard-tuning functions equal
``repro``'s array for array; each shard's local view passes the kernels'
step-table checks.  Across spawned gloo ranks (``tests/_torch_dist.py``,
one spawn per world size): SpMV and SpMM (d = 9) of every matrix, both x
modes, block, adaptive, spill and per-shard configs, gathered and held
within rtol = atol = 1e-5 of the reference's single-device ``spmv``/``spmm``
(Pallas in interpret mode) and within 1e-4 of the dense product; each
rank's received entries equal its plan-time remote count.  The reference's
own 8-device test is red (ROADMAP queue 3) and is no oracle here.
"""
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_dist import D_SPMM, one_rank, orderings, run_ranks, sweep, warm
from _torch_parity import (assert_same_fields, autotune_cost, numpy_fields,
                           rand_sparse, skewed)

import jax.numpy as jnp
import repro.core.formats as ref_formats
import repro.kernels.autotune as ref_autotune
import repro.kernels.ops as ref_ops
import repro.sharding.partitioner as ref_part
from repro.core.spmv import spmm as ref_spmm
from repro.core.spmv import spmv as ref_spmv
from repro.core.suite import generate
from repro_torch.core import ShardedRgCSR, from_numpy, spmv
from repro_torch.kernels import autotune, ops
from repro_torch.launch.mesh import HW, make_mesh, make_production_mesh
from repro_torch.sharding import partitioner as part

torch.set_num_threads(1)


def _skew_spill(seed=3):
    """Sparse background plus three 200-long rows: spill candidates."""
    a = rand_sparse(seed, 256, 240, 0.02)
    for r in np.random.default_rng(4).choice(256, 3, replace=False):
        a[r, :200] = 1.0
    return a


def _laplace(nx, ny):
    """5-point Laplacian on an nx × ny grid (chip_smoke's fem2d recipe)."""
    n = nx * ny
    a = np.zeros((n, n), np.float32)
    r = np.arange(n)
    a[r, r] = 4.0
    i, j = r // ny, r % ny
    for ok, off in ((i > 0, -ny), (i < nx - 1, ny), (j > 0, -1),
                    (j < ny - 1, 1)):
        a[r[ok], r[ok] + off] = -1.0
    return a


MATRICES = {
    "ragged": rand_sparse(1, 300, 280, 0.05),     # 300 over 8 / 4: ragged
    "tiny": rand_sparse(2, 20, 64, 0.2),          # shard 7 of 8 empty
    "tiny9": rand_sparse(5, 9, 64, 0.2),          # shard 3 of 4 empty
    "power": generate("powerlaw", 256, seed=0),
    "skew": _skew_spill(),
    "fem2d": _laplace(16, 16),
}
PLAN_KW = [("block", {}), ("cps2", {"chunks_per_step": 2}),
           ("adaptive", {"ordering": "adaptive"}),
           ("spill8", {"ordering": "adaptive", "spill_threshold": 8})]
MIXED = [(1, "adaptive", 8), (4, "block", 0), (2, "block", 0),
         (2, "adaptive", 0)]
# bf16 results against each other and float64, per element, as
# ``BF16_TOL · (1 + Σ|a·x|)``: a few of bf16's 2^-8 roundings
BF16_TOL = 3e-2


def _pair(name, n_shards):
    a = MATRICES[name]
    return (a, ref_formats.ShardedRgCSR.from_dense(a, n_shards=n_shards),
            ShardedRgCSR.from_dense(a, n_shards, device="cpu"))


# ------------------------------------------------------------- the format


@pytest.mark.parametrize("name,n_shards", [
    ("ragged", 8), ("tiny", 8), ("tiny9", 4), ("power", 4), ("skew", 4),
    ("fem2d", 4)])
def test_sharded_rgcsr_equals_the_reference(name, n_shards):
    a, ref, got = _pair(name, n_shards)
    for f in ("shape", "n_shards", "rows_per_shard", "group_size",
              "slot_pad"):
        assert tuple(np.atleast_1d(getattr(got, f))) == \
            tuple(np.atleast_1d(getattr(ref, f))), f
    assert (got.nnz, got.stored_elements, got.storage_bytes()) == \
        (ref.nnz, ref.stored_elements, ref.storage_bytes())
    for r, g in zip(ref.shards, got.shards, strict=True):
        assert_same_fields(r, g)
    for d in range(n_shards):
        assert got.shard_rows(d) == ref.shard_rows(d)
    np.testing.assert_array_equal(got.to_dense(), a)
    carried = from_numpy("sharded_rgcsr", numpy_fields(ref), device="cpu")
    for r, g in zip(ref.shards, carried.shards, strict=True):
        assert_same_fields(r, g)


def test_from_csr_builds_the_shards_from_row_blocks():
    a = MATRICES["ragged"]
    c = sp.csr_matrix(a)
    got = ShardedRgCSR.from_csr(c.data, c.indices, c.indptr, c.shape, 8,
                                device="cpu")
    ref = ref_formats.ShardedRgCSR.from_dense(a, n_shards=8)
    assert got.rows_per_shard == 38 and got.shard_rows(7) == (266, 300)
    for r, g in zip(ref.shards, got.shards, strict=True):
        assert_same_fields(r, g)
    with pytest.raises(ValueError, match="n_shards"):
        ShardedRgCSR.from_csr(c.data, c.indices, c.indptr, c.shape, 0,
                              device="cpu")


# ------------------------------------------------------- the stacked plan


@pytest.mark.parametrize("x_mode", ["replicated", "split"])
@pytest.mark.parametrize("name,n_shards", [
    ("ragged", 8), ("tiny", 8), ("power", 4), ("skew", 4), ("fem2d", 4)])
def test_stacked_plan_equals_the_reference(name, n_shards, x_mode):
    """Every field, padding included: stacked values, columns and step
    tables, send_idx, edge_counts, e_max, remote_cols, the rem_* and
    spill tails and the shard stats; uniform and per-shard configs."""
    _, ref, got = _pair(name, n_shards)
    mixed = (MIXED * 2)[:n_shards]
    for label, kw in PLAN_KW + [("mixed", {"shard_configs": mixed})]:
        want = ref_ops.make_sharded_plan(ref, x_mode=x_mode, **kw)
        plan = ops.make_sharded_plan(got, x_mode=x_mode, **kw)
        assert_same_fields(want, plan)
        for prop in ("num_steps_max", "stored_slots_max", "n_spilled_max",
                     "stored_elements", "shard_spilled_elements",
                     "padded_slot_fraction", "has_exchange",
                     "shard_exchange_recv_cols", "shard_exchange_send_cols",
                     "shard_exchange_bytes", "exchange_padded_recv_cols"):
            assert getattr(plan, prop) == getattr(want, prop), (label, prop)
        if x_mode == "split" and plan.has_exchange:
            assert plan.shard_exchange_recv_cols == plan.shard_remote_cols


def test_gcd_expansion_and_padding_steps_pass_the_kernels_checks():
    """Per-shard winners at cps 1/4/2/2 stack at kernel cps 1: each coarse
    step splits into c/gcd fine steps with step_first on the first only,
    padding steps repeat the shard's last group with step_first 0, and
    each shard's local plan passes ``_group_step_ptr``'s contiguity check
    with padding rows dead in ``seg_slots``."""
    a = _skew_spill()
    a[7, :150] = 1.0                               # heavy row in shard 0
    got = ShardedRgCSR.from_dense(a, 4, device="cpu")
    plan = ops.make_sharded_plan(got, x_mode="split", shard_configs=MIXED)
    assert_same_fields(ref_ops.make_sharded_plan(
        ref_formats.ShardedRgCSR.from_dense(a, n_shards=4), x_mode="split",
        shard_configs=MIXED), plan)
    assert plan.chunks_per_step == 1 and plan.ordering == "adaptive"
    assert sum(plan.shard_spilled_elements) > 0
    sf, sg = plan.step_first2d.numpy(), plan.step_group2d.numpy()
    for d, (cps_d, ordering, _) in enumerate(MIXED):
        t_d = plan.shard_num_steps[d]
        assert all(j % cps_d == 0 for j in np.flatnonzero(sf[d, :t_d]))
        assert (sf[d, t_d:] == 0).all()
        assert (sg[d, t_d:] == sg[d, t_d - 1]).all()
        view = plan.local(d)
        p = view.plan
        assert p.ordering == ordering
        assert p.stored_slots == plan.stored_slots_max
        ptr = p.group_step_ptr.numpy()
        assert ptr[-1] == plan.num_steps_max
        # the padding steps belong to the last real group, yet no live
        # slot row reaches past the shard's own stored rows
        ends = ptr[:-1, None] * p.rows_per_step + p.seg_slots.numpy()
        assert (ends <= plan.shard_stored_slots[d]).all()
        assert p.n_spilled_elements == plan.shard_spill_counts[d]


def test_an_all_remote_shard_has_an_empty_local_plan():
    a = rand_sparse(22, 128, 128, 0.06)
    a[:32, :32] = 0.0
    a[:32, 100] = 1.5
    ref = ref_ops.make_sharded_plan(
        ref_formats.ShardedRgCSR.from_dense(a, n_shards=4), x_mode="split")
    plan = ops.make_sharded_plan(ShardedRgCSR.from_dense(a, 4, device="cpu"),
                                 x_mode="split")
    assert_same_fields(ref, plan)
    view = plan.local(0)
    assert int(view.plan.seg_slots.sum()) == 0
    x = torch.from_numpy(np.random.default_rng(23).standard_normal(
        32).astype(np.float32))
    assert (ops.rgcsr_spmv(view.plan, x) == 0).all()


def test_a_shard_view_holds_its_own_slices_alone():
    """The stacked plan stays on the host; a shard's view holds that
    shard's slices (its tails cut to their real entries) and nothing of
    the other shards."""
    plan = ops.make_sharded_plan(
        ShardedRgCSR.from_dense(_skew_spill(), 4, device="cpu"),
        x_mode="split", ordering="adaptive", spill_threshold=8)
    assert plan.has_exchange and plan.n_spilled_max > 0
    assert {t.device.type for t in (
        plan.values3d, plan.columns3d, plan.step_group2d, plan.send_idx,
        plan.rem_values, plan.gather_idx, plan.spill_values)} == {"cpu"}
    views = [plan.local(d) for d in range(4)]
    for d, view in enumerate(views):
        assert torch.equal(view.plan.values2d, plan.values3d[d])
        assert torch.equal(view.plan.columns2d, plan.columns3d[d])
        assert torch.equal(view.send_idx, plan.send_idx[d].long())
        n_e = plan.shard_remote_entries[d]
        assert torch.equal(view.rem_values, plan.rem_values[d, :n_e])
        n_sp = plan.shard_spilled_elements[d]
        assert torch.equal(view.plan.spill_values,
                           plan.spill_values[d, :n_sp])
        assert view.nbytes < plan.nbytes
    assert sum(v.plan.values2d.nbytes + v.plan.columns2d.nbytes
               for v in views) == plan.values3d.nbytes + \
        plan.columns3d.nbytes


def test_block_diagonal_split_has_no_exchange():
    a = np.zeros((256, 256), np.float32)
    for d in range(4):
        a[d * 64: (d + 1) * 64, d * 64: (d + 1) * 64] = \
            rand_sparse(20 + d, 64, 64, 0.2)
    plan = ops.make_sharded_plan(ShardedRgCSR.from_dense(a, 4, device="cpu"),
                                 x_mode="split")
    assert plan.e_max == 0 and not plan.has_exchange
    assert plan.send_idx is None and plan.rem_values is None
    assert plan.shard_remote_cols == (0, 0, 0, 0)
    assert plan.local(2).send_idx is None


def test_sharded_plan_cache_keys_on_x_mode_configs_and_shards():
    a = rand_sparse(7, 128, 128, 0.05)
    sm = ShardedRgCSR.from_dense(a, 4, device="cpu")
    p1 = ops.get_sharded_plan(sm)
    p2 = ops.get_sharded_plan(sm, x_mode="split")
    p3 = ops.get_sharded_plan(sm, ordering="adaptive", spill_threshold=8)
    p4 = ops.get_sharded_plan(sm, x_mode="split", shard_configs=MIXED)
    assert len({id(p) for p in (p1, p2, p3, p4)}) == 4
    assert ops.get_sharded_plan(sm) is p1
    assert ops.get_sharded_plan(sm, x_mode="split",
                                shard_configs=MIXED) is p4
    assert ops.get_sharded_plan(sm, shard_configs=[(1, "block", 0)] * 4) \
        is p1
    p2b = ops.get_sharded_plan(ShardedRgCSR.from_dense(a, 2, device="cpu"),
                               x_mode="split")
    assert p2b.n_shards == 2 and p2b is not p2
    stats = ops.sharded_plan_cache_stats()
    assert stats["hits"] >= 3 and stats["misses"] >= 5
    assert p4.fingerprint() == ops.make_sharded_plan(
        sm, x_mode="split", shard_configs=MIXED).fingerprint()
    assert p4.fingerprint() != p2.fingerprint()


# ------------------------------------------------------- shard tuning


@pytest.fixture
def deterministic_autotune(monkeypatch):
    """The reference's cost model on both sides (see
    tests/test_torch_autotune.py); both memos cleared around the test."""
    monkeypatch.setattr(autotune, "time_us", lambda run, plan, cfg, **kw: (
        run(plan, cfg), autotune_cost(plan))[1])
    monkeypatch.setattr(ref_autotune, "time_us",
                        lambda run, plan, cfg, **kw: autotune_cost(plan))
    autotune.clear_memo()
    ref_autotune.clear_memo()
    yield
    autotune.clear_memo()
    ref_autotune.clear_memo()


@pytest.mark.parametrize("x_mode", ["replicated", "split"])
def test_shard_tuning_equals_the_reference(x_mode, deterministic_autotune):
    a = skewed(6)
    blocks = autotune.shard_row_blocks(sp.csr_matrix(a), 4, x_mode=x_mode)
    for (v, c, ptr, shape), want in zip(
            blocks, ref_autotune.shard_row_blocks(a, 4, x_mode=x_mode),
            strict=True):
        np.testing.assert_array_equal(
            sp.csr_matrix((v, c, ptr), shape=shape).toarray(), want)
    got = autotune.autotune_spmv_per_shard(a, 4, repeats=1, x_mode=x_mode,
                                           device="cpu")
    want = ref_autotune.autotune_spmv_per_shard(a, 4, repeats=1,
                                                x_mode=x_mode)
    for g, w in zip(got, want, strict=True):
        assert g.config == autotune.TuneConfig(**vars(w.config))
        assert g.plan_stats == w.plan_stats
        assert [(tuple(vars(c).values()), us) for c, us in g.timings] == \
            [(tuple(vars(c).values()), us) for c, us in w.timings]
    picks = autotune.harmonize_shard_winners(got)
    assert [tuple(vars(c).values()) for c in picks] == \
        [tuple(vars(c).values())
         for c in ref_autotune.harmonize_shard_winners(want)]


def test_harmonize_respects_the_bottleneck_as_the_reference():
    def res(rows, mod):
        timings = tuple((mod.TuneConfig(*c), us) for c, us, _ in rows)
        return mod.TuneResult(config=min(timings, key=lambda t: t[1])[0],
                              us_per_call=min(us for _, us in timings),
                              timings=timings, signature=(),
                              plan_stats=tuple(s for _, _, s in rows))

    light = [((1, 128, 128, "block", 0), 100.0, (16, 2048, 0)),
             ((4, 128, 128, "block", 0), 101.0, (32, 4096, 0)),
             ((8, 128, 128, "block", 0), 150.0, (64, 8192, 0))]
    heavy = [((1, 128, 128, "block", 0), 900.0, (96, 12288, 0)),
             ((4, 128, 128, "block", 0), 310.0, (96, 12288, 0)),
             ((4, 128, 128, "adaptive", 8), 315.0, (32, 4500, 400))]
    for shards in ([light, heavy, light], [light, light]):
        got = autotune.harmonize_shard_winners(
            [res(r, autotune) for r in shards])
        want = ref_autotune.harmonize_shard_winners(
            [res(r, ref_autotune) for r in shards])
        assert [tuple(vars(c).values()) for c in got] == \
            [tuple(vars(c).values()) for c in want]


# ----------------------------------------------------------- partitioner


def _meshes(sizes, names):
    """Stand-ins with the attributes both packages' routing reads."""
    ref = types.SimpleNamespace(axis_names=names,
                                shape=dict(zip(names, sizes)))
    port = types.SimpleNamespace(mesh_dim_names=names, shape=sizes)
    return ref, port


def test_rule_tables_are_the_reference_s():
    for name in ("TRAIN_RULES", "SERVE_RULES"):
        got, want = getattr(part, name), getattr(ref_part, name)
        assert got.params == want.params and got.batch == want.batch \
            and got.act_embed == want.act_embed
    for x in (None, "model", ("data", "model"), [("data", "model"), "m"]):
        assert part._candidates(x) == ref_part._candidates(x)


@pytest.mark.parametrize("sizes,names", [
    ((1,), ("model",)), ((4,), ("model",)), ((2, 4), ("data", "model")),
    ((1, 8), ("data", "model")), ((4,), ("data",))])
def test_spmv_routing_matches_the_reference(sizes, names):
    ref_mesh, mesh = _meshes(sizes, names)
    for kind in ("train", "decode"):
        want = ref_part.Partitioner(ref_mesh, kind)
        got = part.Partitioner(mesh, kind)
        assert got.spmv_shard_axis() == want.spmv_shard_axis()
        assert got.spmv_shard_count() == want.spmv_shard_count()
        for axis in ("model", ("pod", "data"), ("data", "model"), "pod"):
            assert part._filter_axis(mesh, axis) == \
                ref_part._filter_axis(ref_mesh, axis)
            kept = part._filter_axis(mesh, axis)
            assert part._axis_size(mesh, kept) == \
                ref_part._axis_size(ref_mesh, kept)
    if "model" in names:
        assert part.resolve_spmv_shard_axis(mesh) == "model"
    else:
        with pytest.raises(ValueError, match="sparse_rows"):
            part.resolve_spmv_shard_axis(mesh)
    assert part.Partitioner(mesh).param_shardings({}) == {}


def test_one_rank_mesh_routes_and_runs_as_one_device(tmp_path):
    """A world of one: the mesh's signature, the partitioner's axis, the
    refusals, and a one-shard ``spmv`` equal to the single-device K1 path
    bit for bit (one shard's plan is the single-device plan)."""
    a = MATRICES["ragged"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        280).astype(np.float32))
    sm = ShardedRgCSR.from_dense(a, 1, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1,), ("model",), device_type="cpu")
    with one_rank(tmp_path):
        with pytest.raises(RuntimeError, match="needs 2 ranks"):
            make_mesh((2,), ("model",), device_type="cpu")
        for multi_pod, n in ((False, 256), (True, 512)):
            with pytest.raises(RuntimeError, match=f"needs {n} ranks"):
                make_production_mesh(multi_pod=multi_pod)
        mesh = make_mesh((1,), ("model",), device_type="cpu")
        assert part.mesh_signature(mesh) == (("model",), (1,), (0,), "cpu")
        assert part.Partitioner(mesh, "decode").spmv_shard_count() == 1
        with pytest.raises(ValueError, match="mesh="):
            spmv(sm, x)
        with pytest.raises(ValueError, match="no axis"):
            spmv(sm, x, mesh=mesh, mesh_axis="data")
        for x_mode in ("replicated", "split"):
            y = spmv(sm, x, mesh=mesh, x_mode=x_mode)
            single = ops.rgcsr_spmv(ops.make_plan(sm.shards[0]), x)
            assert torch.equal(y, single[:300])
        plan = ops.get_sharded_plan(sm, x_mode="split")
        assert plan.e_max == 0 and plan.shard_remote_cols == (0,)
    assert HW.HBM_BW == 3.35e12 and HW.HBM_BYTES == 80 * 10 ** 9


# ------------------------------------------------- across spawned ranks


@pytest.fixture(scope="module")
def reference_products():
    """The reference's single-device ``spmv``/``spmm`` (interpret mode) of
    every swept matrix and ordering, and the inputs, from one seed."""
    rng = np.random.default_rng(11)
    cases, want = [], {}
    for name in ("ragged", "tiny", "tiny9", "power", "skew", "fem2d"):
        a = MATRICES[name]
        x = rng.standard_normal(a.shape[1]).astype(np.float32)
        xm = rng.standard_normal((a.shape[1], D_SPMM)).astype(np.float32)
        c = sp.csr_matrix(a)
        cases.append((name, (c.data, c.indices, c.indptr, c.shape), x, xm,
                      "float32"))
        m = ref_formats.RgCSR.from_dense(a)
        for label, kw in orderings(4):
            kw = {k: v for k, v in kw.items() if k != "shard_configs"}
            want[name, label] = (
                np.asarray(ref_spmv(m, jnp.asarray(x), impl="kernel", **kw)),
                np.asarray(ref_spmm(m, jnp.asarray(xm), impl="kernel", **kw)),
                a.astype(np.float64) @ x, a.astype(np.float64) @ xm)
    # bf16 values and operands (the reference's kernels take no mix):
    # inputs rounded to bf16 first, so both packages see the same numbers
    a = MATRICES["skew"]
    bf = lambda v: np.asarray(v, jnp.bfloat16).astype(np.float32)  # noqa
    x = bf(rng.standard_normal(a.shape[1]))
    xm = bf(rng.standard_normal((a.shape[1], D_SPMM)))
    c = sp.csr_matrix(bf(a))
    cases.append(("skew_bf16", (c.data, c.indices, c.indptr, c.shape), x,
                  xm, "bfloat16"))
    m = ref_formats.RgCSR.from_dense(np.asarray(a, jnp.bfloat16))
    a64 = np.abs(bf(a).astype(np.float64))
    want["skew_bf16"] = (
        np.asarray(ref_spmv(m, jnp.asarray(x, jnp.bfloat16),
                            impl="kernel"), np.float32),
        np.asarray(ref_spmm(m, jnp.asarray(xm, jnp.bfloat16),
                            impl="kernel"), np.float32),
        bf(a).astype(np.float64) @ x, bf(a).astype(np.float64) @ xm,
        a64 @ np.abs(x), a64 @ np.abs(xm))
    return cases, want


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_products_across_ranks(world, tmp_path, reference_products):
    cases, want = reference_products
    outs = run_ranks(tmp_path, world, sweep, cases)
    assert [o["shard"] for o in outs] == list(range(world))
    for key, got in outs[0]["results"].items():
        name, x_mode, label, kind = key
        if name == "skew_bf16":
            continue
        ref_y, ref_ym, dense_y, dense_ym = want[name, label]
        ref, dense = (ref_y, dense_y) if kind == "spmv" else (ref_ym,
                                                              dense_ym)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=str(key))
        np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-4,
                                   err_msg=str(key))
        for other in outs[1:]:     # every rank gathers the same result
            np.testing.assert_array_equal(other["results"][key], got)
    if world > 1:
        assert any(o["received"] for o in outs)
    # bf16, every ordering in both x modes: bf16 out, as the reference's
    # ``y + segment_sum`` of bf16 terms, within bf16's rounding of the
    # reference's single-device product and of the float64 one
    ref_y, ref_ym, dense_y, dense_ym, scale_y, scale_ym = want["skew_bf16"]
    bf16_keys = [k for k in outs[0]["results"] if k[0] == "skew_bf16"]
    assert len(bf16_keys) == 2 * 2 * len(orderings(world))
    for key in bf16_keys:
        got, kind = outs[0]["results"][key], key[3]
        assert outs[0]["dtypes"][key] == "torch.bfloat16", key
        ref, dense, scale = ((ref_y, dense_y, scale_y) if kind == "spmv"
                             else (ref_ym, dense_ym, scale_ym))
        for what in (ref, dense):
            assert np.all(np.abs(got - what) <= BF16_TOL * (1 + scale)), key


def test_warm_spmv_plans_on_a_mesh_across_ranks(tmp_path):
    """The reference's warm-up invariants (tests/test_sharded_spmv.py):
    per-shard winners, exchange accounting and a new plan on a resized
    mesh — and every rank built the same plans."""
    mats = [generate("banded", 256, seed=4), skewed(6)]
    outs = run_ranks(tmp_path, 4, warm, mats)
    first = outs[0]
    assert first["axis"] == ("model", 2)
    assert first["cache"]["sharded_spmv_plans_warmed"] == 3
    assert first["cache"]["sharded_plan_cache"]["entries"] >= 3
    stats = first["stats"]
    for st in stats[:2]:
        assert st["n_shards"] == 4 and len(st["stored_slots"]) == 4
        assert len(st["shard_winners"]) == 4
        assert all(len(w) == 3 for w in st["shard_winners"])
        assert st["exchange_recv_cols"] == st["remote_cols"]
        assert len(st["exchange_bytes"]) == 4
        assert st["kernel_chunks_per_step"] >= 1
        assert 0 < st["device_bytes"] < st["host_bytes"]
    assert stats[2]["n_shards"] == 2 and stats[0]["mesh"] != stats[2]["mesh"]
    assert first["n_shards"] == [4, 4, 2]
    for o in outs[1:]:
        assert o["winners"] == first["winners"]
        assert o["fingerprints"][:2] == first["fingerprints"][:2]
    # the (2, 2) mesh's two model groups each built the same 2-shard plan
    assert len({o["fingerprints"][2] for o in outs}) == 1
