"""The port's autotuner against ``repro.kernels.autotune`` on the same inputs.

Signatures, spill candidates and candidate sets must be equal; under one
deterministic cost model on both sides (the reference's
``deterministic_autotune`` fixture, ported below) the pruned set, the
plans' stats, the winner and the baseline must be equal too.  Winners are
never asserted from wall-clock times.
"""
import gc

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_parity import autotune_cost as _cost
from _torch_parity import skewed

import repro.core.suite as ref_suite
import repro.kernels.autotune as ref_autotune
from repro_torch.core.suite import generate
from repro_torch.kernels import PLAN_CACHE, autotune, ops

torch.set_num_threads(1)

CORPUS = ref_suite.small_corpus()


@pytest.fixture
def deterministic_autotune(monkeypatch):
    """The port's copy of the reference's ``deterministic_autotune``: each
    candidate still runs once (plan construction and the wrapper stay
    covered), only the µs that rank the winners are synthesized; both
    memos are cleared around the test.  The reference side gets the same
    cost model without the run: its run is a Pallas kernel in interpret
    mode, seconds per search, and the ranking never reads its result."""
    def port_time_us(run, plan, cfg, **kwargs):
        run(plan, cfg)
        return _cost(plan)

    monkeypatch.setattr(autotune, "time_us", port_time_us)
    monkeypatch.setattr(ref_autotune, "time_us",
                        lambda run, plan, cfg, **kw: _cost(plan))
    autotune.clear_memo()
    ref_autotune.clear_memo()
    yield
    autotune.clear_memo()
    ref_autotune.clear_memo()


def _csr_tuple(a):
    c = sp.csr_matrix(a)
    return c.data, c.indices, c.indptr, c.shape


def _same_result(ref, port):
    assert [(c, us) for c, us in port.timings] == \
        [(autotune.TuneConfig(*(getattr(c, f) for f in
                                ("chunks_per_step", "group_size", "d_tile",
                                 "ordering", "spill_threshold"))), us)
         for c, us in ref.timings]
    assert port.plan_stats == ref.plan_stats
    assert port.config == autotune.TuneConfig(**vars(ref.config))
    assert port.baseline_us == ref.baseline_us
    assert port.speedup == ref.speedup
    assert port.signature == ref.signature
    assert port.timing_source == ref.timing_source == "wallclock"


# ------------------------------------------------------- signatures, sets


@pytest.mark.parametrize("spec", CORPUS, ids=[s.name for s in CORPUS])
def test_signature_and_spill_candidates_match_reference(spec):
    a = spec.build()
    want = ref_autotune.matrix_signature(a)
    row_lens = (a != 0).sum(axis=1)
    want_spill = ref_autotune.spill_threshold_candidates(row_lens)
    for given in (a, sp.csr_matrix(a), _csr_tuple(a)):
        assert autotune.matrix_signature(given) == want
        assert autotune.spill_threshold_candidates(
            autotune._as_csr(given).row_lens) == want_spill


def test_stored_zeros_do_not_count():
    """A CSR tuple with explicit zeros is the dense matrix without them."""
    a = skewed(3)
    c = sp.csr_matrix(a)
    c.data[::7] = 0.0                     # stored zeros, kept by scipy
    dense = c.toarray()
    assert autotune.matrix_signature(_csr_tuple(c)) == \
        ref_autotune.matrix_signature(dense)


@pytest.mark.parametrize("kw", [
    {},
    dict(orderings=("block", "adaptive"), spill_thresholds=(0, 8, 32)),
    dict(chunks=(1, 4), group_sizes=(128,), d_tiles=(128, 256),
         orderings=("adaptive",), spill_thresholds=(0, 16)),
])
def test_candidate_configs_match_reference(kw):
    want = ref_autotune.candidate_configs(**kw)
    got = autotune.candidate_configs(**kw)
    assert [tuple(vars(c).values()) for c in got] == \
        [tuple(vars(c).values()) for c in want]
    assert autotune.DEFAULT_GROUP_SIZES == ref_autotune.DEFAULT_GROUP_SIZES
    assert autotune.DEFAULT_D_TILES == ref_autotune.DEFAULT_D_TILES
    assert autotune.DEFAULT_ORDERINGS == ref_autotune.DEFAULT_ORDERINGS


# ------------------------------------------------------------ the search

WINNER_CASES = [s.name for s in CORPUS if s.n <= 1024]


@pytest.mark.parametrize("name", WINNER_CASES)
def test_spmv_search_matches_reference(name, deterministic_autotune):
    a = next(s for s in CORPUS if s.name == name).build()
    ref = ref_autotune.autotune_spmv(a, repeats=1)
    port = autotune.autotune_spmv(sp.csr_matrix(a), repeats=1, device="cpu")
    _same_result(ref, port)


def test_skewed_search_and_spmm_search_match_reference(
        deterministic_autotune):
    a = skewed(13)
    _same_result(ref_autotune.autotune_spmv(a, repeats=1),
                 autotune.autotune_spmv(a, repeats=1, device="cpu"))
    b = generate("circuit", 256, seed=1)
    ref = ref_autotune.autotune_spmm(b, 8, repeats=1)
    port = autotune.autotune_spmm(b, 8, repeats=1, device="cpu")
    _same_result(ref, port)
    assert {c.d_tile for c, _ in port.timings} == {128, 256}
    assert port.config.ordering == "adaptive"


def test_restricted_search_matches_reference(deterministic_autotune):
    a = generate("banded", 256, seed=0)
    cands = autotune.candidate_configs()
    ref = ref_autotune.autotune_spmv(
        a, repeats=1, candidates=ref_autotune.candidate_configs())
    port = autotune.autotune_spmv(a, repeats=1, candidates=cands,
                                  device="cpu")
    _same_result(ref, port)
    assert port.config.chunks_per_step > 1


def test_memo_hit_and_restricted_candidates_not_shadowed():
    """A second search of the same signature is a memo hit; a search over
    restricted candidates is never answered from a wider one's memo."""
    autotune.clear_memo()
    a = generate("uniform", 256, seed=0)
    res = autotune.autotune_spmv(a, repeats=1, device="cpu")
    assert not res.from_memo and len(res.timings) >= 2
    assert res.config.group_size in autotune.DEFAULT_GROUP_SIZES
    again = autotune.autotune_spmv(a, repeats=1, device="cpu")
    assert again.from_memo and again.config == res.config
    # same signature bucket: winner reuse without timing
    assert autotune.autotune_spmv(generate("uniform", 256, seed=1),
                                  repeats=1, device="cpu").from_memo
    cands = [autotune.TuneConfig(1, 128), autotune.TuneConfig(2, 128)]
    res = autotune.autotune_spmv(a, repeats=1, candidates=cands,
                                 device="cpu")
    assert not res.from_memo and res.config in cands
    autotune.clear_memo()


def test_timing_source_provenance(deterministic_autotune):
    """A patched ``time_us`` forces wallclock provenance, as on the CPU."""
    assert autotune.timing_source() == "wallclock"
    a = generate("uniform", 64, seed=0)
    assert autotune.autotune_spmv(a, repeats=1,
                                  device="cpu").timing_source == "wallclock"
    with pytest.raises(ValueError):
        autotune.set_timing_source("bogus")
    autotune.set_timing_source("wallclock")
    try:
        assert autotune.timing_source() == "wallclock"
    finally:
        autotune.set_timing_source("auto")


def test_unpatched_search_on_the_cpu_is_wallclock():
    """No profiler records CUDA kernels here: the search times with the
    host's clock and says so."""
    autotune.clear_memo()
    assert autotune.timing_source() == "wallclock"
    res = autotune.autotune_spmv(generate("banded", 64, seed=0), repeats=1,
                                 device="cpu")
    assert res.timing_source == "wallclock"
    assert all(us > 0 for _, us in res.timings)
    autotune.clear_memo()


# ---------------------------------------------------------- tuned plans


def test_tuned_plan_roundtrip_survives_gc_and_matches_dense(
        deterministic_autotune):
    a = generate("circuit", 256, seed=2)
    plan, res = autotune.tuned_plan(a, repeats=1, device="cpu")
    assert plan.ordering == res.config.ordering
    assert plan.spill_threshold == res.config.spill_threshold
    assert plan.chunks_per_step == res.config.chunks_per_step
    gc.collect()                     # would fire PLAN_CACHE's finalizer
    misses = PLAN_CACHE.stats()["misses"]
    plan2, res2 = autotune.tuned_plan(sp.csr_matrix(a), repeats=1,
                                      device="cpu")
    assert plan2 is plan and res2.from_memo
    assert PLAN_CACHE.stats()["misses"] == misses
    x = np.random.default_rng(14).standard_normal(a.shape[1]).astype(
        np.float32)
    got = ops.rgcsr_spmv(plan, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, a @ x, rtol=1e-4, atol=1e-4)


def test_tuned_plan_of_a_second_matrix_in_the_bucket_is_its_own(
        deterministic_autotune):
    """Two matrices of one signature share the winner but not the plan
    (the reference's ``_TUNED`` hands the second the first one's plan)."""
    a, b = (generate("uniform", 256, seed=s) for s in (0, 1))
    assert autotune.matrix_signature(a) == autotune.matrix_signature(b)
    pa, _ = autotune.tuned_plan(a, repeats=1, device="cpu")
    pb, rb = autotune.tuned_plan(b, repeats=1, device="cpu")
    assert rb.from_memo and pb is not pa
    x = np.random.default_rng(1).standard_normal(256).astype(np.float32)
    np.testing.assert_allclose(ops.rgcsr_spmv(pb, torch.from_numpy(x)),
                               b @ x, rtol=1e-4, atol=1e-4)


def test_plans_from_csr_equal_plans_from_dense(deterministic_autotune):
    a = skewed(5)
    pd, rd = autotune.tuned_plan(a, repeats=1, device="cpu")
    autotune.clear_memo()
    pc, rc = autotune.tuned_plan(_csr_tuple(a), repeats=1, device="cpu")
    assert rd == rc and pc is not pd
    for f in ("values2d", "columns2d", "step_group", "step_first",
              "gather_idx", "spill_values", "spill_rows", "spill_columns"):
        x, y = getattr(pd, f), getattr(pc, f)
        assert (x is None and y is None) or torch.equal(x, y), f


# --------------------------------------------------------------- serving


def test_engine_warm_spmv_plans_matches_reference(deterministic_autotune):
    from repro.configs import get_smoke as ref_get_smoke
    from repro.serve import Engine as RefEngine
    from repro.serve import ServeConfig as RefServeConfig
    from repro_torch.configs import get_smoke
    from repro_torch.serve import Engine, ServeConfig
    mats = [generate("banded", 256, seed=4), skewed(6)]
    want = RefEngine(ref_get_smoke("granite-3-2b"), RefServeConfig(
        max_seq=32)).warm_spmv_plans(mats, repeats=1)
    eng = Engine(get_smoke("granite-3-2b"), ServeConfig(max_seq=32),
                 device="cpu")
    got = eng.warm_spmv_plans(mats, repeats=1)
    assert [tuple(vars(c).values()) for c in got] == \
        [tuple(vars(c).values()) for c in want]
    assert eng.plan_cache_stats()["spmv_plans_warmed"] == 2
    # the request path: a memo hit with no plan build
    misses = PLAN_CACHE.stats()["misses"]
    for a in mats:
        assert autotune.tuned_plan(a, repeats=1, device="cpu")[1].from_memo
    assert PLAN_CACHE.stats()["misses"] == misses


# ---------------------------------------------------------- the profiler


def test_profiler_windows_are_the_cards_spans():
    """Device events count in the windows of the card's timeline and
    nowhere else; the host's spans of the same windows (here milliseconds
    off, as the profiler's two clocks are on the card) are ignored; a
    window that lost device records is left out."""
    from repro_torch.core import timing
    ev = []
    spans = [(100.0, 110.0), (200.0, 230.0), (300.0, 320.0)]
    for w, (t0, t1) in enumerate(spans):
        name = f"tune:0:{w}"
        ev.append((name, False, True, t0 + 5000.0, t1 + 5000.0))   # host
        ev.append((name, True, True, t0, t1))                      # card
        ev.append(("kernel", True, False, t0, t0 + 4.0))
        ev.append(("kernel", True, False, t1 - 3.0, t1))
        ev.append(("cudaLaunchKernel", False, False, t0 + 4990, t0 + 4991))
    assert timing._attribute(ev, 1, 3) == [[7.0, 7.0, 7.0]]
    ev.append(("kernel", True, False, 150.0, 158.0))   # between windows
    ev.append(("kernel", True, False, 1.0, 2.0))       # before them
    assert timing._attribute(ev, 1, 3) == [[7.0, 7.0, 7.0]]
    # the second window lost a record, the third its span: left out
    lossy = [e for e in ev if e != ("kernel", True, False, 227.0, 230.0)
             and e[:2] != ("tune:0:2", True)]
    assert timing._attribute(lossy, 1, 3) == [[7.0]]
    # a callable with no window: no timing (the caller runs it again)
    assert timing._attribute([e for e in ev if not e[0].startswith(
        "tune:") or not e[1]], 1, 3) is None
    assert not timing.profiler_available()
    assert timing.profiler_failure == "no CUDA card"
    assert timing.profiled_time_us_group([lambda: None]) is None
