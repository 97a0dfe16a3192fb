"""The port's paged KV cache (``serve/paging.py``, the paged half of
``models/attention.py``) against the reference's, and ``test_paging.py``'s
serving cases replayed on both packages.

Bars: the allocator's tables, free lists and stats exactly equal after the
same operations; paged-decode logits within 1e-4 of the reference's paged
decode (fp32); page fingerprints equal for equal bytes; streams, statuses
and stats counters of ``serve`` exactly equal (see ``_torch_serving``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving import (assert_same_serving, engines, oracle, pair,
                            requests)
from repro.models import LanguageModel as RefModel
from repro.models import attention as ref_attention
from repro.serve import paging as ref_paging
from repro_torch.kernels import paged_attention as paged_module
from repro_torch.models import LanguageModel, attention
from repro_torch.serve import paging

torch.set_num_threads(1)

S_MAX = 64
PS = 4           # page size: small so short tests cross page boundaries


# ------------------------------------------------------------- allocator


def _alloc_story(mod, seed, policy, n_ops=80):
    """Random admit/ensure/release/quarantine/checksum operations on a
    fresh allocator; the record of every outcome and the final state."""
    rng = np.random.default_rng(seed)
    geom = mod.geometry(max_seq=32, page_size=4, n_slots=3, n_pages=12)
    alloc = mod.PageAllocator(geom, n_slots=3, policy=policy)
    log, live = [], {}
    for _ in range(n_ops):
        op, slot = int(rng.integers(0, 6)), int(rng.integers(0, 3))
        if op == 0 and slot not in live:
            n_tok = int(rng.integers(1, 17))
            worst = min(alloc.pages_for(n_tok) + int(rng.integers(0, 3)),
                        geom.pages_per_slot)
            ok = alloc.admit(slot, n_tok, worst)
            log.append(("admit", ok))
            if ok:
                live[slot] = (n_tok, worst)
        elif op == 1 and slot in live:
            n_tok, worst = live[slot]
            n_tok = min(n_tok + int(rng.integers(1, 5)),
                        worst * geom.page_size)
            try:
                log.append(("ensure", alloc.ensure(slot, n_tok)))
                live[slot] = (n_tok, worst)
            except mod.PoolExhausted as e:
                log.append(("dry", str(e)))
        elif op in (2, 3):
            log.append(("release", alloc.release(
                slot, evicted=bool(rng.integers(0, 2)))))
            live.pop(slot, None)
        elif op == 4:
            page = int(rng.integers(1, geom.n_pages))
            if page in alloc.free and sum(alloc.reserved) >= alloc.usable:
                continue
            log.append(("quarantine", alloc.quarantine(page)))
        elif slot in live and alloc.slot_pages[slot]:
            page = alloc.slot_pages[slot][0]
            alloc.record_checksum(page, 3, 0xBEEF + page)
            log.append(("owner", alloc.owner_of(page)))
    return (log, alloc.table.tolist(), alloc.slot_pages, list(alloc.free),
            sorted(alloc.quarantined), dict(alloc.checksums), alloc.stats(),
            alloc.reserved, alloc.worst_cap)


@pytest.mark.parametrize("policy", ["worst_case", "prompt"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocator_matches_the_reference(seed, policy):
    assert _alloc_story(paging, seed, policy) == \
        _alloc_story(ref_paging, seed, policy)


def test_allocator_cases_of_the_reference():
    """The fixed cases of ``test_paging.py``: geometry, the reservation
    and worst-case caps, strict double release, bad policy and page."""
    for mod in (paging, ref_paging):
        geom = mod.geometry(max_seq=32, page_size=4, n_slots=2, n_pages=0)
        assert (geom.pages_per_slot, geom.n_pages, geom.usable_pages) == \
            (8, 17, 16)
        alloc = mod.PageAllocator(geom, n_slots=2)
        alloc.admit(0, 4, worst_pages=2)
        with pytest.raises(AssertionError, match="reservation"):
            alloc.ensure(0, 12)
        prompt = mod.PageAllocator(geom, n_slots=2, policy="prompt")
        prompt.admit(0, 4, worst_pages=2)
        with pytest.raises(AssertionError, match="worst-case cap"):
            prompt.ensure(0, 12)
        strict = mod.PageAllocator(geom, n_slots=2, strict=True)
        strict.admit(0, 8, worst_pages=2)
        strict.release(0)
        with pytest.raises(RuntimeError, match="double release"):
            strict.release(0)
        with pytest.raises(ValueError, match="admission policy"):
            mod.PageAllocator(geom, n_slots=1, policy="optimism")
        with pytest.raises(ValueError):
            alloc.quarantine(0)
        alloc.free.append(alloc.slot_pages[0][0])
        with pytest.raises(AssertionError, match="accounting"):
            alloc.admit(1, 4, worst_pages=2)


# -------------------------------------------- paged decode, both packages


_JITS = {}


def _models(**over):
    """The reference model with its prefill and decode step compiled once
    per configuration, its parameters, and the port's model."""
    ref_cfg, ref_params, cfg, tree = pair()
    ref_cfg = dataclasses.replace(ref_cfg, **over)
    cfg = dataclasses.replace(cfg, **over)
    key = tuple(sorted(over.items()))
    if key not in _JITS:
        ref_model = RefModel(ref_cfg)
        _JITS[key] = (ref_model, jax.jit(
            lambda p, b: ref_model.prefill(p, b, S_MAX)),
            jax.jit(ref_model.decode_step))
    return _JITS[key], ref_params, LanguageModel(cfg, tree)


def _decode_both(prompt_len, n_steps=4, slot=1, **over):
    """Prefill once, commit into slot ``slot`` of a 2-slot paged cache in
    both packages, then decode the reference's greedy stream through the
    reference's paged cache, the port's paged cache and the port's dense
    batch-1 cache; yields (reference paged, port paged, port dense) logits
    of the slot per step, and the caches at the end."""
    (ref_model, prefill, decode), ref_params, model = _models(**over)
    prompt = np.random.default_rng(prompt_len).integers(
        0, 512, (1, prompt_len)).astype(np.int32)
    geom = paging.geometry(S_MAX, PS, n_slots=2)
    ref_geom = ref_paging.geometry(S_MAX, PS, n_slots=2)
    alloc = paging.PageAllocator(geom, n_slots=2)
    worst = min(alloc.pages_for(prompt_len + n_steps), geom.pages_per_slot)
    assert alloc.admit(slot, prompt_len, worst)
    logits, ref_dense = prefill(ref_params, {"tokens": jnp.asarray(prompt)})
    ref_caches = ref_paging.commit_prefill(
        ref_model.init_cache(2, S_MAX, paging=ref_geom), ref_dense, slot,
        prompt_len, alloc.table, PS)
    caches = model.init_cache(2, S_MAX, paging=geom)
    with torch.inference_mode():
        _, dense = model.prefill({"tokens": torch.from_numpy(prompt)}, S_MAX)
        assert paging.commit_prefill(caches, dense, slot, prompt_len,
                                     alloc.table, PS) is None
    tok, pos = int(jnp.argmax(logits[0, -1])), prompt_len
    for _ in range(n_steps):
        if alloc.ensure(slot, pos + 1):
            ref_caches = ref_paging.sync_block_tables(ref_caches,
                                                      alloc.table)
            paging.sync_block_tables(caches, alloc.table)
        both = np.zeros((2, 1), np.int32)
        both[slot, 0] = tok
        want, ref_caches = decode(ref_params, ref_caches, jnp.asarray(both))
        with torch.inference_mode():
            got, _ = model.decode_step(caches, torch.from_numpy(both))
            one, dense = model.decode_step(
                dense, torch.full((1, 1), tok, dtype=torch.int32))
            # the serving loop advances the index in place
            for c in caches:
                c["index"] += 1
        yield (np.asarray(want[slot], np.float32), got[slot].numpy(),
               one[0].numpy())
        tok, pos = int(jnp.argmax(want[slot, -1])), pos + 1
    yield ref_caches, caches


# page-boundary lengths: len % PS ∈ {0, 1, PS-1} (plus an interior value)
@pytest.mark.parametrize("prompt_len", [PS * 3, PS * 3 + 1, PS * 3 - 1, 10])
def test_paged_decode_matches_the_reference(prompt_len):
    *steps, (ref_caches, caches) = _decode_both(prompt_len)
    for want, got, one in steps:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-5)
    # the pools, tables and indices the steps left behind
    ref_body = ref_caches["body"]["0_attn"]
    for i, cache in enumerate(caches):
        np.testing.assert_array_equal(cache["block_table"].numpy(),
                                      np.asarray(ref_body["block_table"][i]))
        np.testing.assert_array_equal(cache["index"].numpy(),
                                      np.asarray(ref_body["index"][i]))
        np.testing.assert_allclose(cache["k"].numpy(),
                                   np.asarray(ref_body["k"][i]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("prompt_len", [PS * 3, PS * 3 + 1, PS * 3 - 1, 10])
def test_paged_decode_on_cpu_runs_the_plain_paged_attention(prompt_len,
                                                            monkeypatch):
    """gqa_apply's paged decode (one token, no window, fp32 KV) goes through
    the paged decode attention, which on CPU tensors is its plain version:
    once a layer a step; and the steps keep
    ``test_paged_decode_matches_the_reference``'s bars."""
    calls = []
    plain = paged_module.paged_attention_plain

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)

    monkeypatch.setattr(paged_module, "paged_attention_plain", spy)
    n_layers = pair()[2].n_layers
    *steps, _ = _decode_both(prompt_len)
    assert len(calls) == n_layers * len(steps)
    for want, got, one in steps:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-5)


def test_paged_decode_int8_and_null_page_isolation():
    """int8 KV (per-token scales in their own pools), and slot 0 left
    free: its writes land on the null page and never perturb slot 1."""
    *steps, (_, caches) = _decode_both(PS * 2 + 1, kv_cache_dtype="int8")
    for want, got, _ in steps:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert set(caches[0]) == {"k", "v", "k_scale", "v_scale",
                              "block_table", "index"}
    assert (caches[0]["block_table"][0] == 0).all()


def test_out_of_range_writes_follow_the_reference():
    """A slot whose index has run past the cache: the paged block-table
    lookup clamps, as JAX does; the dense write, which JAX drops, lands in
    the spare row that the port's session slabs keep past S_max, and the
    rows the reference has stay the reference's."""
    rng = np.random.default_rng(3)
    k_new = rng.standard_normal((3, 1, 2, 16)).astype(np.float32)
    v_new = rng.standard_normal((3, 1, 2, 16)).astype(np.float32)
    index = np.array([2, 8, 11], np.int32)            # S_max 8: 8, 11 out
    dense = {"k": rng.standard_normal((3, 8, 2, 16)).astype(np.float32)}
    dense["v"] = dense["k"] + 1
    paged = {"k": rng.standard_normal((7, 4, 2, 16)).astype(np.float32),
             "block_table": np.array([[1, 2], [3, 4], [5, 6]], np.int32)}
    paged["v"] = paged["k"] - 1
    spare = {k: rng.standard_normal((3, 1, 2, 16)).astype(np.float32)
             for k in ("k", "v")}
    for cache in (dense, paged):
        cache["index"] = index
        want = ref_attention._cache_write(
            {k: jnp.asarray(v) for k, v in cache.items()},
            jnp.asarray(k_new), jnp.asarray(v_new), "float32", None)
        mine = {k: torch.from_numpy(np.concatenate([v, spare[k]], 1)
                                    if cache is dense and k in spare
                                    else v.copy())
                for k, v in cache.items()}
        got = attention._cache_write(mine, torch.from_numpy(k_new),
                                     torch.from_numpy(v_new), "float32",
                                     None)
        for key in cache:
            g = got[key].numpy()
            if cache is dense and key in spare:
                # slot 0's spare row untouched, slots 1 and 2 wrote there
                np.testing.assert_array_equal(g[0, 8], spare[key][0, 0])
                new_kv = k_new if key == "k" else v_new
                np.testing.assert_array_equal(g[1:, 8], new_kv[1:, 0])
                g = g[:, :8]
            np.testing.assert_array_equal(g, np.asarray(want[key]))


# ---------------------------------------------- integrity operations


def _committed_pair(kv="float32"):
    """The reference's paged caches after two commits, and the port's
    holding the very same bytes."""
    (ref_model, prefill, _), ref_params, model = _models(kv_cache_dtype=kv)
    geom = paging.geometry(S_MAX, PS, n_slots=2)
    alloc = paging.PageAllocator(geom, n_slots=2)
    ref_caches = ref_model.init_cache(2, S_MAX, paging=geom)
    for slot, n in ((0, 9), (1, 6)):
        prompt = np.random.default_rng(n).integers(
            0, 512, (1, n)).astype(np.int32)
        _, one = prefill(ref_params, {"tokens": jnp.asarray(prompt)})
        alloc.admit(slot, n, 4)
        ref_caches = ref_paging.commit_prefill(ref_caches, one, slot, n,
                                               alloc.table, PS)
    caches = model.init_cache(2, S_MAX, paging=geom)
    body = ref_caches["body"]["0_attn"]
    for i, cache in enumerate(caches):
        for key, t in cache.items():
            arr = np.asarray(jax.device_get(body[key][i]))
            t.copy_(torch.from_numpy(arr.astype(np.float32)).to(t.dtype)
                    if arr.dtype.name == "bfloat16"
                    else torch.from_numpy(np.array(arr)))
    return ref_caches, caches, alloc


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_page_fingerprints_equal_for_equal_bytes(kv):
    ref_caches, caches, alloc = _committed_pair(kv)
    committed = {p: 4 for p in alloc.slot_pages[0][:2]}
    committed.update({alloc.slot_pages[0][2]: 1, alloc.slot_pages[1][1]: 2})
    want = ref_paging.page_fingerprints(ref_caches, committed)
    cfg = pair()[2]
    assert paging.page_fingerprints(caches, committed,
                                    paging.crc_order(cfg)) == want
    assert paging.page_fingerprints(caches, committed) == want
    assert paging.page_fingerprints(caches, {}) == {}
    # corruption in place, found by both the crc and the NaN scan
    page = alloc.slot_pages[1][0]
    ref_caches = ref_paging.corrupt_page(ref_caches, page, nan=True)
    assert paging.corrupt_page(caches, page, nan=True) is None
    want = ref_paging.page_fingerprints(ref_caches, committed)
    assert paging.page_fingerprints(caches, committed) == want
    pages = alloc.slot_pages[0] + alloc.slot_pages[1]
    assert paging.pages_nonfinite(caches, pages) == \
        ref_paging.pages_nonfinite(ref_caches, pages) == {page}
    paging.corrupt_page(caches, page)
    ref_caches = ref_paging.corrupt_page(ref_caches, page)
    assert paging.page_fingerprints(caches, committed) == \
        ref_paging.page_fingerprints(ref_caches, committed)


# ---------------------------------------------- serving, both packages


def _serve(ref, eng, ref_reqs, reqs, timing=False):
    ref.serve(ref_reqs)
    eng.serve(reqs)
    assert_same_serving(ref_reqs, reqs, ref.paging_stats, eng.paging_stats,
                        timing=timing)
    return eng.paging_stats


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_serve_mixed_lengths_and_midstream_slotting(layout):
    ref, eng = engines(max_seq=S_MAX, n_slots=2, kv_layout=layout,
                       page_size=PS)
    for seed, lens, new in ((5, (10, 13, 7), 5), (6, (9, 9, 9), [10, 3, 6])):
        ref_reqs, reqs = requests(seed, lens, new)
        st = _serve(ref, eng, ref_reqs, reqs)
        assert st["kv_layout"] == layout
        for r in reqs:
            assert r.out == oracle(eng, r)


def test_serve_pool_exhaustion_defers_admission():
    ref, eng = engines(max_seq=S_MAX, n_slots=3, page_size=8, n_pages=5,
                       admission_policy="worst_case")
    st = _serve(ref, eng, *requests(7, (8, 8, 8), 5))
    assert st["admission_deferrals"] > 0 and st["preemptions"] == 0
    assert st["page_high_water"] <= 4 and st["pages_in_use"] == 0


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_serve_overload_preempts(layout):
    ref, eng = engines(max_seq=S_MAX, n_slots=3, page_size=8, n_pages=5,
                       kv_layout=layout)
    ref_reqs, reqs = requests(7, (8,) * 6, 5)
    st = _serve(ref, eng, ref_reqs, reqs)
    assert st["completed"] == 6
    if layout == "paged":
        assert st["preemptions"] == st["evictions"] > 0
        assert st["pages_in_use"] == 0 and st["reserved_pages"] == 0
    for r in reqs:
        assert r.out == oracle(eng, r)
    # three requests: each eviction returns exactly the victim's pages
    st = _serve(*engines(max_seq=S_MAX, n_slots=3, page_size=8, n_pages=5,
                         kv_layout=layout), *requests(7, (8,) * 3, 5))
    if layout == "paged":
        assert st["pages_evicted"] * st["page_size"] >= \
            st["recompute_tokens"] > st["pages_evicted"] > 0


def test_serve_preemption_fifo_fairness_under_sustained_overload():
    ref, eng = engines(clock=True, max_seq=S_MAX, n_slots=3, page_size=8,
                       n_pages=5)
    ref_reqs, reqs = requests(12, (8,) * 8, 5)
    st = _serve(ref, eng, ref_reqs, reqs, timing=True)
    assert st["preemptions"] > 0
    done_at = [r.queue_s + r.latency_s for r in reqs]
    assert done_at == sorted(done_at)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_serve_deadline_expiry_releases_slot_and_pages(layout):
    ref, eng = engines(clock=True, max_seq=S_MAX, n_slots=2, page_size=PS,
                       kv_layout=layout)
    ref_reqs, reqs = requests(13, (8,) * 4, [12, 4, 4, 3],
                              deadlines=[2.5, None, 2.5, None])
    st = _serve(ref, eng, ref_reqs, reqs, timing=True)
    assert [r.status for r in reqs] == ["timed_out", "ok", "timed_out", "ok"]
    assert st["timed_out"] == 2 and st["completed"] == 2


def test_serve_straggler_decode_steps_flagged():
    from repro_torch.train.fault import FaultConfig
    ref, eng = engines(clock=True, slow_at=(8,), max_seq=S_MAX, n_slots=2,
                       page_size=PS, decode_chunk=1)
    st = _serve(ref, eng, *requests(14, (6, 6), 12), timing=True)
    assert st["straggler_decode_steps"] == 1
    assert isinstance(eng.fault_cfg, FaultConfig)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_serve_rejections_and_strict(layout):
    """A budget past max_seq is rejected (strict: raises), the exact fit
    fills the cache; a request too big for the pool likewise."""
    ref, eng = engines(max_seq=16, n_slots=1, kv_layout=layout,
                       page_size=PS)
    ref_reqs, reqs = requests(11, (9, 9), [9, 8])
    for lst in (ref_reqs, reqs):
        lst[1].tokens = lst[0].tokens.copy()
    _serve(ref, eng, ref_reqs, reqs)
    assert reqs[0].status == "rejected" and "max_seq" in reqs[0].error
    assert reqs[1].out == oracle(eng, reqs[1])
    for e in engines(max_seq=16, n_slots=1, kv_layout=layout, page_size=PS,
                     strict=True):
        with pytest.raises(ValueError, match="max_seq"):
            e.serve([type(reqs[0])(tokens=reqs[0].tokens,
                                   max_new_tokens=9)])
    if layout == "dense":
        return
    ref, eng = engines(max_seq=S_MAX, n_slots=2, page_size=8, n_pages=3)
    ref_reqs, reqs = requests(15, (16, 6), [20, 2])
    st = _serve(ref, eng, ref_reqs, reqs)
    assert reqs[0].status == "rejected" and "pool" in reqs[0].error
    assert st["rejected"] == 1
    for e in engines(max_seq=S_MAX, n_slots=2, page_size=8, n_pages=3,
                     strict=True):
        with pytest.raises(ValueError, match="pool"):
            e.serve([type(reqs[0])(tokens=reqs[0].tokens,
                                   max_new_tokens=20)])


def test_paged_residency_and_slot_reuse():
    ref, eng = engines(max_seq=S_MAX, n_slots=4, page_size=PS)
    st = _serve(ref, eng, *requests(8, (6, 18, 9, 30, 12), 4))
    assert st["paged_peak_tokens"] < st["dense_equiv_tokens"]
    assert 0.0 <= st["frag_at_high_water"] < 1.0
    ref, eng = engines(max_seq=S_MAX, n_slots=2, page_size=PS)
    _serve(ref, eng, *requests(9, [6 + 3 * (i % 4) for i in range(6)],
                               [3 + i % 3 for i in range(6)]))

