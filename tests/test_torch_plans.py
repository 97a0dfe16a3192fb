"""The port's plan layer against the reference's.

Plans must be byte-equal to ``repro.kernels.ops.make_plan`` at every
``chunks_per_step`` in block and adaptive form, with and without spill; the
``PlanCache`` must hit, miss and evict like the reference's; and the
structural totals of the committed ``BENCH_spmv.json`` must come back from
the port's plans.
"""
import dataclasses
import gc
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same_fields, numpy_fields, rand_sparse, skewed

import repro.core.formats as ref_formats
import repro.kernels.ops as ref_ops
from repro.kernels.autotune import spill_threshold_candidates
from repro.core.suite import small_corpus
from repro_torch.core import from_dense, from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.ops import (PLAN_CACHE, PlanCache, get_plan,
                                     make_plan, plan_from_numpy)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPS_ALL = (1, 2, 4, 8)


def _stored_zero():
    a = rand_sparse(9, 260, 200, 0.06)
    a[:, 17] = 1.0
    return a


MATRICES = {
    "ragged": lambda: rand_sparse(1, 300, 120, 0.08),
    "skewed": lambda: skewed(3),
    "empty": lambda: np.zeros((0, 40), np.float32),
    "stored_zero": _stored_zero,
}


def _pair(name):
    """The same RgCSR in both packages (the port's built from the
    reference's arrays); ``stored_zero`` holds a true element equal to 0.0."""
    ref = ref_formats.from_dense(MATRICES[name](), "rgcsr")
    fields = numpy_fields(ref)
    if name == "stored_zero":
        fields["values"][np.flatnonzero(fields["values"])[5]] = 0.0
        ref = dataclasses.replace(ref, values=jnp.asarray(fields["values"]))
    return ref, from_numpy("rgcsr", fields, device="cpu")


@pytest.mark.parametrize("cps", CPS_ALL)
@pytest.mark.parametrize("ordering,spill", [("block", 0), ("adaptive", 0),
                                            ("adaptive", 4)])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_plan_byte_equal_to_reference(name, ordering, spill, cps):
    ref_m, port_m = _pair(name)
    ref = ref_ops.make_plan(ref_m, chunks_per_step=cps, ordering=ordering,
                            spill_threshold=spill)
    port = make_plan(port_m, chunks_per_step=cps, ordering=ordering,
                     spill_threshold=spill)
    assert_same_fields(ref, port)
    for prop in ("num_steps", "num_chunks", "stored_slots",
                 "n_spilled_elements", "stored_elements",
                 "padded_slot_fraction"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    # the kernels' step ranges: group g owns steps [ptr[g], ptr[g+1])
    ptr = port.group_step_ptr.numpy()
    sg = np.asarray(ref.step_group)
    assert ptr[0] == 0 and ptr[-1] == port.num_steps
    for g in range(port.n_groups):
        assert (sg[ptr[g]:ptr[g + 1]] == g).all()
    # and the plan comes across from the reference's arrays unchanged
    carried = plan_from_numpy(numpy_fields(ref), device="cpu")
    assert_same_fields(ref, carried)
    np.testing.assert_array_equal(carried.group_step_ptr.numpy(), ptr)


@pytest.mark.parametrize("kwargs", [
    dict(spill_threshold=3),                    # spill needs adaptive
    dict(chunks_per_step=3),
    dict(ordering="random"),
])
def test_make_plan_rejects_what_the_reference_rejects(kwargs):
    ref_m, port_m = _pair("ragged")
    with pytest.raises(ValueError):
        ref_ops.make_plan(ref_m, **kwargs)
    with pytest.raises(ValueError):
        make_plan(port_m, **kwargs)


@pytest.mark.parametrize("kw", [dict(group_size=64), dict(slot_pad=4)])
def test_make_plan_keeps_the_reference_domain(kw):
    a = rand_sparse(2, 100, 100, 0.05)
    with pytest.raises(ValueError):
        ref_ops.make_plan(ref_formats.from_dense(a, "rgcsr", **kw))
    with pytest.raises(ValueError):
        make_plan(from_dense(a, "rgcsr", device="cpu", **kw))


def test_plan_rejects_a_step_table_out_of_group_order():
    fields = numpy_fields(ref_ops.make_plan(
        ref_formats.from_dense(rand_sparse(3, 300, 80, 0.05), "rgcsr")))
    fields["step_group"] = fields["step_group"][::-1].copy()
    with pytest.raises(ValueError, match="group-contiguous"):
        plan_from_numpy(fields, device="cpu")


def test_ell_plan_byte_equal_to_reference():
    a = rand_sparse(4, 200, 150, 0.04)
    ref = ref_ops.make_ell_plan(ref_formats.from_dense(a, "ellpack"))
    port = ops.make_ell_plan(from_dense(a, "ellpack", device="cpu"))
    assert_same_fields(ref, port)


# --------------------------------------------------------------- PlanCache


def test_plan_cache_hits_misses_and_keys():
    cache = PlanCache()
    m = from_dense(rand_sparse(5, 150, 100, 0.05), "rgcsr", device="cpu")
    p1 = cache.get(m)
    assert cache.get(m) is p1
    p2 = cache.get(m, ordering="adaptive", spill_threshold=4)
    p3 = cache.get(m, ordering="adaptive", spill_threshold=8)
    p4 = cache.get(m, chunks_per_step=2)
    assert len({id(p) for p in (p1, p2, p3, p4)}) == 4
    assert cache.stats() == {"hits": 1, "misses": 4, "entries": 4}


def test_plan_cache_evicts_with_its_matrix():
    cache = PlanCache()
    m = from_dense(rand_sparse(6, 150, 100, 0.05), "rgcsr", device="cpu")
    cache.get(m)
    cache.get(m, chunks_per_step=4)
    assert len(cache) == 2
    del m
    gc.collect()
    assert len(cache) == 0


def test_plan_cache_lru_bound():
    cache = PlanCache(maxsize=2)
    mats = [from_dense(rand_sparse(s, 40, 40, 0.1), "rgcsr", device="cpu")
            for s in range(3)]
    for m in mats:
        cache.get(m)
    assert len(cache) == 2
    cache.get(mats[0])
    assert cache.stats()["misses"] == 4


def test_global_get_plan():
    m = from_dense(rand_sparse(7, 96, 96, 0.08), "rgcsr", device="cpu")
    before = PLAN_CACHE.stats()
    assert get_plan(m) is get_plan(m)
    after = PLAN_CACHE.stats()
    assert after["misses"] == before["misses"] + 1
    assert after["hits"] == before["hits"] + 1


# ------------------------------------------------- BENCH_spmv.json totals


def test_bench_spmv_structure_from_port_plans():
    """Grid steps, stored and padded slots of the committed benchmark's 30
    matrices, rebuilt from the port's plans (the structural fields; no
    time in that file was measured on a GPU)."""
    bench = json.loads((REPO / "BENCH_spmv.json").read_text())
    steps1 = steps4 = 0
    skew_block, skew_adapt, skew_ratio = [], [], []
    for spec in small_corpus():
        row = bench["matrices"][spec.name]
        a = spec.build()
        m = from_dense(a, "rgcsr", device="cpu")
        block = make_plan(m)
        s4 = make_plan(m, chunks_per_step=4).num_steps
        cands = spill_threshold_candidates((a != 0).sum(axis=1))
        spill = cands[1] if len(cands) > 1 else 0
        adapt = make_plan(m, ordering="adaptive", spill_threshold=spill)
        k = row["kernel"]
        assert (block.num_steps, s4) == (k["steps_cps1"], k["steps_cps4"])
        assert adapt.num_steps == k["steps_adaptive"]
        assert block.stored_elements - block.nnz == k["padded_slots_block"]
        assert adapt.stored_elements - adapt.nnz == k["padded_slots_adaptive"]
        steps1 += block.num_steps
        steps4 += s4
        if spec.family in ("powerlaw", "circuit"):
            skew_block.append(block.padded_slot_fraction)
            skew_adapt.append(adapt.padded_slot_fraction)
            skew_ratio.append((block.stored_elements - block.nnz)
                              / max(adapt.stored_elements - adapt.nnz, 1))
    summary = bench["summary"]
    assert steps1 == summary["total_grid_steps_cps1"] == 1166
    assert steps4 == summary["total_grid_steps_cps4"] == 381
    assert round(float(np.mean(skew_block)), 4) == \
        summary["skewed_padfrac_block_mean"]
    assert round(float(np.mean(skew_adapt)), 4) == \
        summary["skewed_padfrac_adaptive_mean"]
    assert round(float(np.exp(np.log(skew_ratio).mean())), 2) == \
        summary["skewed_padded_slots_reduction_geomean"]
