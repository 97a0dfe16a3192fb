"""The port's continuous-batching serving path (``Engine.serve``,
``EngineSession``, the fused decode loop) replayed against the reference's
on the cases of ``test_serve.py``, ``test_device_loop.py`` and
``test_snapshot.py``, on smoke granite-3-2b — dense and with the RgCSR FFN
— in float32 from the same weights.

Bars: greedy token streams, request statuses, ``stats_snapshot()``
counters (and, on fake clocks, request timings and tracer events) exactly
equal; snapshot dicts equal but for the generator's state (the reference
stores its PRNG key).  On the CPU the fused loop runs its one-step
function eagerly — the plain version of the graph the card replays.
Cases that need the reference's ``Router`` wait for its port (ROADMAP).
"""
import json

import numpy as np
import pytest
import torch

from _torch_serving import (assert_same_serving, engines, oracle, pair,
                            port_engine, requests)
from repro.obs.trace import Tracer as RefTracer
from repro.train.fault import FaultInjector as RefInjector
from repro.train.fault import ProcessKilled as RefProcessKilled
from repro_torch.obs.trace import Tracer
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.train.fault import (FaultConfig, FaultInjector,
                                     ProcessKilled)

torch.set_num_threads(1)

S_MAX = 64
PS = 4


def _serve(ref, eng, ref_reqs, reqs, timing=False, injectors=(None, None)):
    ref.serve(ref_reqs, fault_injector=injectors[0])
    eng.serve(reqs, fault_injector=injectors[1])
    assert_same_serving(ref_reqs, reqs, ref.paging_stats, eng.paging_stats,
                        timing=timing)
    return eng.paging_stats


# ------------------------------------------------- cadence-invariance oracle


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("chunk", [1, 2, 7, 32])
def test_fused_serve_matches_the_reference_any_chunk(chunk, layout):
    """Chunks that undershoot, straddle and overshoot the 5-token budgets
    (at 32 the loop ends on its predicate); mixed-length prompts in one
    live batch, both KV layouts."""
    ref, eng = engines(max_seq=S_MAX, n_slots=2, kv_layout=layout,
                       page_size=PS, decode_chunk=chunk)
    ref_reqs, reqs = requests(5, (10, 13, 7), 5)
    sessions = (ref.start_session(ref_reqs), eng.start_session(reqs))
    for sess in sessions:
        sess.drain()
    st = sessions[1].stats_snapshot()
    assert_same_serving(ref_reqs, reqs, sessions[0].stats_snapshot(), st)
    for r in reqs:
        assert r.ok_like and r.out == oracle(eng, r)
    if chunk == 1:
        assert st["decode_dispatches"] == st["decode_steps"]
    else:
        assert st["decode_dispatches"] < st["decode_steps"]
    # the caches the chunks left: indices and block tables exactly, the
    # pools within 1e-4 (page 0 takes every free slot's writes, in an
    # order neither package fixes; a dense slab's spare row is the port's)
    assert_same_caches(sessions[0], sessions[1], layout)


def assert_same_caches(ref_sess, sess, layout):
    want = ref_sess.caches["body"]["0_attn"]
    for i, cache in enumerate(sess.caches):
        for key, t in cache.items():
            got, ref_t = t.numpy(), np.asarray(want[key][i])
            if key in ("index", "block_table"):
                np.testing.assert_array_equal(got, ref_t)
            elif layout == "paged":
                np.testing.assert_allclose(got[1:], ref_t[1:],
                                           rtol=1e-4, atol=1e-4)
            else:
                assert got.shape[1] == ref_t.shape[1] + 1
                np.testing.assert_allclose(got[:, :-1], ref_t,
                                           rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_a_free_slot_decodes_past_max_seq_as_the_reference(layout):
    """Slot 1 stays free while slot 0 serves two requests in turn: its
    index runs past max_seq, where JAX clamps the page lookup and drops
    the dense write and the port does the same, explicitly."""
    ref, eng = engines(max_seq=16, n_slots=2, page_size=PS,
                       kv_layout=layout, decode_chunk=8)
    ref_reqs, reqs = requests(6, (4, 5), 12)
    sessions = (ref.start_session(), eng.start_session())
    for i in range(2):
        for sess, rs in zip(sessions, (ref_reqs, reqs)):
            sess.submit(rs[i])
            sess.drain()
    assert_same_serving(ref_reqs, reqs, sessions[0].stats_snapshot(),
                        sessions[1].stats_snapshot())
    assert sessions[1].caches[0]["index"].numpy()[1] > 16
    assert_same_caches(sessions[0], sessions[1], layout)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_rgcsr_ffn_serves_as_the_reference(layout):
    """The RgCSR FFN (K2's plain version here) under chunked serving and
    recompute preemption."""
    ref, eng = engines(sparse=True, max_seq=S_MAX, n_slots=3, page_size=8,
                       n_pages=5, kv_layout=layout, decode_chunk=4)
    ref_reqs, reqs = requests(7, (8, 11, 8, 9, 8), 5)
    st = _serve(ref, eng, ref_reqs, reqs)
    assert st["completed"] == 5
    assert (st["preemptions"] > 0) == (layout == "paged")
    assert eng.plans_warmed == 2
    for r in reqs:
        assert r.out == oracle(eng, r)


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("arch,sparse", [("granite-moe-1b-a400m", False),
                                         ("minicpm3-4b", True),
                                         ("deepseek-v3-671b", False),
                                         ("mamba2-780m", False),
                                         ("recurrentgemma-9b", True)],
                         ids=["granite-moe", "minicpm3-rgcsr",
                              "deepseek-v3", "mamba2",
                              "recurrentgemma-rgcsr"])
def test_moe_and_mla_families_serve_as_the_reference(arch, sparse, layout):
    """MoE dropless at prefill and in the fused decode steps, MLA's latent
    caches paged (``ckv``/``krope`` pools) or dense, recurrent states
    installed whole at admission (mamba2 holds no page at all; the
    allocator still accounts its requests' pages, as the reference's),
    under chunked serving and recompute preemption: streams, statuses and
    stats equal to the reference's, and each stream equal to
    ``generate`` alone."""
    ref, eng = engines(sparse=sparse, arch=arch, max_seq=S_MAX, n_slots=3,
                       page_size=PS, n_pages=9, kv_layout=layout,
                       decode_chunk=4)
    ref_reqs, reqs = requests(7, (8, 13, 8, 9, 5), 6)
    st = _serve(ref, eng, ref_reqs, reqs)
    assert st["completed"] == 5
    assert (st["preemptions"] > 0) == (layout == "paged")
    keys = set(eng._loop.caches[0])
    assert ({"ckv", "krope"} <= keys) == (eng.model.cfg.attn_kind == "mla")
    assert (keys == {"conv", "ssm"}) == (arch == "mamba2-780m")
    assert (keys == {"conv", "h"}) == (arch == "recurrentgemma-9b")
    for r in reqs:
        assert r.out == oracle(eng, r)


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_short_prompts_serve_with_a_right_aligned_conv_tail(arch):
    """Prompts of 1, 2, 3 and 4 tokens on 2 reused slots: every stream
    equals ``generate`` of its prompt alone, and the logits it came from
    equal the reference's full ``forward`` over prompt + stream (the
    reference's own prefill hands on a conv tail as short as a prompt
    below 3 tokens, which its serve splices at the top of a slot's tail,
    next to a stale row)."""
    import jax.numpy as jnp
    from repro.models import LanguageModel as RefModel
    ref_cfg, ref_params, _, _ = pair(arch=arch)
    eng = port_engine(arch=arch, max_seq=S_MAX, n_slots=2, page_size=PS,
                      decode_chunk=3)
    _, reqs = requests(9, (3, 1, 4, 2, 2, 1), 7)
    eng.serve(reqs)
    assert [r.status for r in reqs] == ["ok"] * 6
    ref_model = RefModel(ref_cfg)
    for r in reqs:
        assert r.out == oracle(eng, r)
        seq = np.concatenate([r.tokens, r.out[:-1]]).astype(np.int32)
        logits = np.asarray(ref_model.forward(
            ref_params, {"tokens": jnp.asarray(seq[None])})[0])[0]
        want = logits[len(r.tokens) - 1:].argmax(-1)
        assert r.out == [int(t) for t in want]


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_dead_steps_leave_the_recurrent_states_alone(arch):
    """A step of the fused loop past ``n_steps`` (not live) leaves every
    recurrent state and the caches' indices bit for bit (its ring KV
    write lands at the unadvanced index, which the next live step
    rewrites); a live step moves every slot's state.  mamba2 holds no
    index at all."""
    eng = port_engine(arch=arch, max_seq=S_MAX, n_slots=2, page_size=PS,
                      decode_chunk=4)
    sess = eng.start_session(requests(4, (5, 9), 10)[1])
    sess.step(2)
    loop = eng._loop
    states = [t for c in loop.caches for k, t in c.items()
              if k in ("conv", "ssm", "h")]
    indexes = [c["index"] for c in loop.caches if "index" in c]
    held = states + indexes
    before = [t.clone() for t in held]
    assert loop.steps_ran.item() == loop.n_steps.item() == 2
    with torch.inference_mode():
        loop._step()                       # n_steps exhausted: dead
    for t, b in zip(held, before):
        assert torch.equal(t, b)
    assert bool(indexes) == (arch == "recurrentgemma-9b")
    assert all(t.tolist() == [7, 11] for t in indexes)  # prompt + 2 steps
    loop.n_steps.fill_(3)
    with torch.inference_mode():
        loop._step()                       # live
    assert all(t.tolist() == [8, 12] for t in indexes)
    assert all(not torch.equal(t[s], b[s]) for t, b in zip(states, before)
               for s in range(2))
    sess.drain()


def test_fused_dispatch_count_amortized():
    ref, eng = engines(max_seq=S_MAX, n_slots=2, page_size=PS,
                       decode_chunk=8)
    st = _serve(ref, eng, *requests(8, (9, 9), 8))
    assert st["decode_dispatches"] == 1 and st["decode_steps"] == 7


def test_eos_mid_chunk_truncates_stream_batchmate_unaffected():
    """The reference's ``serve`` EOS path is the oracle (its ``generate``
    fails with ``eos_id``): EOS inside a chunk truncates that stream at
    the EOS token and leaves its batchmate alone."""
    probe = port_engine(max_seq=S_MAX, n_slots=2, page_size=PS)
    found = None
    for seed in range(16, 48):
        rng = np.random.default_rng(seed)
        pa = rng.integers(0, 512, (9,)).astype(np.int32)
        pb = rng.integers(0, 512, (11,)).astype(np.int32)
        ga = oracle(probe, Request(tokens=pa, max_new_tokens=8))
        gb = oracle(probe, Request(tokens=pb, max_new_tokens=8))
        for idx in range(2, 7):
            if ga[idx] not in ga[:idx] and ga[idx] not in gb:
                found = (seed, ga, gb, idx)
                break
        if found:
            break
    assert found
    seed, ga, gb, idx = found
    ref, eng = engines(max_seq=S_MAX, n_slots=2, page_size=PS,
                       decode_chunk=8, eos_id=int(ga[idx]))
    ref_reqs, reqs = requests(seed, (9, 11), 8)
    st = _serve(ref, eng, ref_reqs, reqs)
    assert reqs[0].out == ga[:idx + 1] and reqs[1].out == gb
    assert st["pages_in_use"] == 0


# ------------------------------------------- host events at chunk boundaries


def test_deadline_expiry_at_chunk_boundary():
    ref, eng = engines(clock=True, max_seq=S_MAX, n_slots=2, page_size=PS,
                       decode_chunk=4)
    ref_reqs, reqs = requests(13, (8, 8), [12, 6], deadlines=[2.5, None])
    st = _serve(ref, eng, ref_reqs, reqs, timing=True)
    assert reqs[0].status == "timed_out" and len(reqs[0].out) == 5
    assert st["timed_out"] == 1 and st["completed"] == 1


def test_preemption_at_chunk_boundary():
    ref, eng = engines(max_seq=S_MAX, n_slots=3, page_size=8, n_pages=5,
                       decode_chunk=4)
    st = _serve(ref, eng, *requests(7, (8,) * 6, 5))
    assert st["preemptions"] > 0 and st["page_high_water"] <= 4


def test_watchdog_normalizes_dt_per_step_in_chunk():
    fc = FaultConfig(straggler_factor=2.0)
    ref, eng = engines(clock=True, fault_cfg=fc, max_seq=S_MAX, n_slots=2,
                       page_size=PS, decode_chunk=8)
    ref_reqs, reqs = requests(14, (6,), 13)
    snaps = []
    for e, req in ((ref, ref_reqs[0]), (eng, reqs[0])):
        session = e.start_session()
        session.submit(req)
        ran = [session.step(1) for _ in range(5)] + [session.step(8)]
        session.drain()
        snaps.append((ran, session.stats_snapshot()))
    assert snaps[1] == snaps[0]
    assert snaps[1][1]["straggler_decode_steps"] == 0
    assert snaps[1][1]["decode_dispatches"] >= 6


# --------------------------------------------------- test_serve.py's cases


def test_continuous_batching_and_budgets():
    ref, eng = engines(max_seq=96, n_slots=2)
    ref_reqs, reqs = requests(2, (10,) * 5, [4 + i % 3 for i in range(5)])
    _serve(ref, eng, ref_reqs, reqs)
    assert [len(r.out) for r in reqs] == [4, 5, 6, 4, 5]
    _serve(ref, eng, *requests(8, (7,), 1))               # one token
    ref_reqs, reqs = requests(9, (10, 12), 4)             # mixed lengths
    _serve(ref, eng, ref_reqs, reqs)
    for r in reqs:
        assert r.out == oracle(eng, r)
    ref, eng = engines(max_seq=96, n_slots=1)
    _serve(ref, eng, *requests(10, (10, 14), 3))          # one slot reused
    ref_reqs, reqs = requests(3, (14,), 6)
    _serve(ref, eng, ref_reqs, reqs)
    assert reqs[0].out == oracle(eng, reqs[0])


def test_prefill_eos_ends_request_without_decode():
    prompt = np.random.default_rng(6).integers(0, 512, (9,)).astype(np.int32)
    eos = oracle(port_engine(max_seq=96), Request(tokens=prompt,
                                                  max_new_tokens=1))[0]
    ref, eng = engines(clock=False, max_seq=96, n_slots=2, eos_id=eos)
    calls = []
    for e in (ref, eng):
        for name in ("_decode", "_fused_decode"):
            orig = getattr(e, name)
            setattr(e, name, lambda *a, o=orig: calls.append(1) or o(*a))
    ref_reqs, reqs = requests(6, (9,), 8)
    _serve(ref, eng, ref_reqs, reqs)
    assert reqs[0].out == [eos] and calls == []
    assert reqs[0].prefill_s > 0 and reqs[0].latency_s >= reqs[0].prefill_s


def test_latency_accounting_on_the_wall_clock():
    import time
    eng = port_engine(max_seq=96, n_slots=1)
    _, reqs = requests(11, (8,) * 3, 3)
    t0 = time.time()
    eng.serve(reqs)
    elapsed = time.time() - t0
    assert all(r.latency_s >= r.prefill_s > 0 for r in reqs)
    assert reqs[0].queue_s <= reqs[1].queue_s <= reqs[2].queue_s
    for r in reqs:
        assert r.queue_s + r.latency_s <= elapsed + 0.05


@pytest.mark.parametrize("site,step,n_new", [("prefill", 1, 4),
                                             ("decode", 2, 5)])
def test_request_fault_fails_only_that_request(site, step, n_new):
    ref, eng = engines(max_seq=96, n_slots=2)
    ref_reqs, reqs = requests(20 if site == "prefill" else 21, (8,) * 3,
                              n_new)
    injectors = (RefInjector(fail_at_steps=((site, step),)),
                 FaultInjector(fail_at_steps=((site, step),)))
    st = _serve(ref, eng, ref_reqs, reqs, injectors=injectors)
    assert injectors[1].fired == injectors[0].fired == [(site, step)]
    bad = reqs[1] if site == "prefill" else reqs[0]
    assert bad.status == "failed" and f"injected fault at {site}" in bad.error
    assert st["failed"] == 1 and st["pages_in_use"] == 0


def test_strict_propagates_injected_fault():
    for e, inj, reqs in zip(engines(max_seq=96, n_slots=2, strict=True),
                            (RefInjector, FaultInjector),
                            requests(22, (8,), 3)):
        e.fault_injector = inj(fail_at_steps=(("prefill", 0),))
        with pytest.raises(RuntimeError, match="injected fault"):
            e.serve(reqs)


def test_traces_match_the_reference():
    """The tracer's events under fake clocks: spans, preemptions, page
    counters and fused-dispatch marks, event for event."""
    ref, eng = engines(clock=True, max_seq=S_MAX, n_slots=3, page_size=8,
                       n_pages=5, decode_chunk=4)
    ref.tracer, eng.tracer = RefTracer(clock=ref.clock), Tracer(
        clock=eng.clock)
    _serve(ref, eng, *requests(7, (8,) * 4, 5), timing=True)
    assert eng.tracer.events == ref.tracer.events
    assert any(ev["name"] == "fused_dispatch" for ev in eng.tracer.events)


# ------------------------------------------------ sessions and snapshots


def _without_generator(snap):
    snap = dict(snap)
    snap.pop("prng_key", None)
    snap.pop("generator_state", None)
    return snap


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("chunk", [1, 8])
def test_snapshot_at_every_chunk_boundary(layout, chunk):
    """Snapshot at every chunk boundary in both packages: the dicts are
    equal, and each restored into a fresh engine drains to the same
    streams and counters."""
    kw = dict(clock=True, max_seq=S_MAX, n_slots=2, page_size=PS,
              kv_layout=layout, decode_chunk=chunk)
    ref, eng = engines(**kw)
    ref_reqs, reqs = requests(22, (6,) * 3, 4 if chunk == 1 else 6)
    sessions = (ref.start_session(list(ref_reqs)),
                eng.start_session(list(reqs)))
    snaps = []
    while not sessions[1].idle:
        pair_ = [s.snapshot() for s in sessions]
        json.dumps(pair_[1])
        assert _without_generator(pair_[1]) == _without_generator(pair_[0])
        snaps.append(pair_)
        assert sessions[1].step(chunk) == sessions[0].step(chunk)
    assert sessions[0].idle and len(snaps) >= (5 if chunk == 1 else 2)
    assert_same_serving(ref_reqs, reqs, sessions[0].stats_snapshot(),
                        sessions[1].stats_snapshot(), timing=True)
    for ref_snap, snap in snaps[1:3]:
        ref2, eng2 = engines(**kw)
        (s_ref, r_ref), (s_port, r_port) = (ref2.restore_session(ref_snap),
                                            eng2.restore_session(snap))
        s_ref.drain()
        s_port.drain()
        assert_same_serving(r_ref, r_port, s_ref.stats_snapshot(),
                            s_port.stats_snapshot(), timing=True)
        for r in r_port:
            assert r.out == oracle(eng, r)


def test_restore_layout_mismatch_rejected():
    eng = port_engine(max_seq=S_MAX, n_slots=2, page_size=PS)
    snap = eng.start_session(requests(1, (8,), 6)[1]).snapshot()
    with pytest.raises(ValueError):
        port_engine(max_seq=S_MAX, n_slots=2, kv_layout="dense"
                    ).start_session([]).restore(snap)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_process_kill_drill_restores_token_identical(layout):
    """Boundary snapshots, then a ("process", 5) kill: a fresh engine
    restores the last snapshot and drains, in both packages alike."""
    kw = dict(clock=True, max_seq=S_MAX, n_slots=2, page_size=PS,
              kv_layout=layout)
    ref, eng = engines(**kw)
    ref.fault_injector = RefInjector(fail_at_steps=(("process", 5),))
    eng.fault_injector = FaultInjector(fail_at_steps=(("process", 5),))
    ref_reqs, reqs = requests(23, (8,) * 4, 8)
    last = []
    for e, rs, killed in ((ref, ref_reqs, RefProcessKilled),
                          (eng, reqs, ProcessKilled)):
        sess = e.start_session(list(rs))
        with pytest.raises(killed, match="injected fault at process 5"):
            while not sess.idle:
                snap = sess.snapshot()
                sess.step(4)
        last.append(snap)
    assert _without_generator(last[1]) == _without_generator(last[0])
    ref2, eng2 = engines(**kw)
    (s_ref, r_ref), (s_port, r_port) = (ref2.restore_session(last[0]),
                                        eng2.restore_session(last[1]))
    s_ref.drain()
    s_port.drain()
    assert len(r_port) == 4
    assert_same_serving(r_ref, r_port, s_ref.stats_snapshot(),
                        s_port.stats_snapshot(), timing=True)
    assert ProcessKilled.__name__ == "ProcessKilled"


@pytest.mark.parametrize("site,seed", [("page", 25), ("page_nan", 26)])
def test_page_corruption_quarantines_exactly_the_victim(site, seed):
    """Silent corruption at rest (crc verify) and inside the dispatch
    window (the logit screen): the page is quarantined and only its owner
    is recompute-preempted, in both packages alike."""
    ref, eng = engines(clock=True, max_seq=S_MAX, n_slots=2, page_size=PS,
                       kv_integrity=True)
    ref_reqs, reqs = requests(seed, (8,) * 3, 10)
    sessions = []
    for e, rs, inj in ((ref, ref_reqs, RefInjector), (eng, reqs,
                                                      FaultInjector)):
        sess = e.start_session(list(rs), inj(fail_at_steps=((site, 1),)))
        sess.drain()
        sessions.append(sess)
    st = sessions[1].stats_snapshot()
    assert_same_serving(ref_reqs, reqs, sessions[0].stats_snapshot(), st,
                        timing=True)
    assert st["preemptions"] == 1 and st["pages_quarantined"] >= 1
    assert (st["nonfinite_logits"] >= 1) == (site == "page_nan")
    assert [r for r in reqs if r.preemptions] == [reqs[0]]
    for r in reqs:
        assert r.out == oracle(eng, r)


def test_integrity_clean_run_and_quarantine_across_restore():
    ref, eng = engines(clock=True, max_seq=S_MAX, n_slots=2, page_size=PS,
                       kv_integrity=True)
    st = _serve(ref, eng, *requests(27, (8,) * 4, 6), timing=True)
    assert st["preemptions"] == st["pages_quarantined"] == 0
    snaps = []
    ref_reqs, reqs = requests(28, (8,) * 3, 12)
    for e, rs, inj in ((ref, ref_reqs, RefInjector), (eng, reqs,
                                                      FaultInjector)):
        sess = e.start_session(list(rs), inj(fail_at_steps=(("page", 1),)))
        sess.step(6)
        sess.step(1)
        assert 1 in sess.alloc.quarantined
        snaps.append(sess.snapshot())
    assert _without_generator(snaps[1]) == _without_generator(snaps[0])
    eng2 = port_engine(max_seq=S_MAX, n_slots=2, page_size=PS,
                       kv_integrity=True)
    sess2, restored = eng2.restore_session(snaps[1])
    assert 1 in sess2.alloc.quarantined
    sess2.drain()
    for r in restored:
        assert r.ok_like and r.out == oracle(eng2, r)


# ------------------------------------------------------ the port's own


def test_sampled_serving_resumes_from_the_generator_state():
    """Sampled streams cannot match the reference's (the generators
    differ).  A session restored from a snapshot draws the same tokens as
    the session it was taken from, and every token is in the vocab."""
    kw = dict(max_seq=S_MAX, n_slots=2, page_size=PS, decode_chunk=4,
              temperature=1.0, top_k=20)
    eng = port_engine(**kw)
    _, reqs = requests(30, (8, 9), 10)
    sess = eng.start_session(list(reqs))
    sess.step(4)
    snap = sess.snapshot()
    sess.drain()
    eng2 = port_engine(**kw)
    _, restored = eng2.restore_session(snap)
    eng2._session.drain()
    assert [r.out for r in restored] == [r.out for r in reqs]
    assert all(0 <= t < 512 for r in reqs for t in r.out)


def test_a_newer_session_takes_over_the_serving_state():
    eng = port_engine(max_seq=S_MAX, n_slots=2, page_size=PS)
    old = eng.start_session(requests(1, (8,), 6)[1])
    eng.start_session([])
    with pytest.raises(RuntimeError, match="newer session"):
        old.step(1)


def test_the_serving_state_is_built_at_the_first_session():
    """generate() allocates no session caches and builds no fused loop;
    the first session does, and the engine keeps them."""
    eng = port_engine(max_seq=S_MAX, n_slots=2, page_size=PS)
    eng.generate(np.zeros((1, 4), np.int32), 2)
    assert eng._runner is None
    eng.start_session([])
    loop = eng._runner
    assert loop is not None
    eng.start_session([])
    assert eng._runner is loop


def test_warm_spmv_plans_is_not_ported_yet(tmp_path):
    """The name is older than the port of ``warm_spmv_plans(mesh=)``,
    which raised here until row-sharded SpMV came: now, on a mesh of one
    rank, it warms a one-shard plan (the multi-rank cases are in
    tests/test_torch_sharded_spmv.py)."""
    from _torch_dist import one_rank
    from repro_torch.launch.mesh import make_mesh
    eng = port_engine(max_seq=S_MAX)
    with one_rank(tmp_path):
        mesh = make_mesh((1,), ("model",), device_type="cpu")
        winners = eng.warm_spmv_plans([np.eye(4)], mesh=mesh)
    assert len(winners) == 1 and eng.sharded_spmv_plans_warmed == 1
    st = eng.sharded_spmv_shard_stats[0]
    assert st["n_shards"] == 1 and st["remote_cols"] == [0]
    assert eng.plan_cache_stats()["sharded_spmv_plans_warmed"] == 1


def test_the_fused_loop_refuses_a_rebound_cache_tensor():
    """The loop reads each cache tensor at its address (on the card, the
    graph's): a tensor rebound in place of one raises before a chunk."""
    eng = port_engine(max_seq=S_MAX, n_slots=2, page_size=PS)
    sess = eng.start_session(requests(1, (8,), 6)[1])
    sess.step(1)
    eng._loop.caches[1]["index"] = eng._loop.caches[1]["index"] + 0
    with pytest.raises(RuntimeError, match=r"caches\[1\]\['index'\]"):
        sess.step(1)


def test_the_fused_loop_refuses_a_weight_written_in_place():
    """The step reads each weight's compute-dtype copy and K2 plan, which
    the layers rebuild when the weight is written in place: the loop
    raises before a chunk rather than serve the old weights."""
    cfg = pair(sparse=True)[2]            # weights of its own, from a seed
    eng = Engine(cfg, ServeConfig(max_seq=S_MAX, n_slots=2, page_size=PS),
                 device="cpu")
    sess = eng.start_session(requests(1, (8,), 6)[1])
    sess.step(1)
    with torch.no_grad():
        eng.model.layers[1].ffn.w_out.values2d.mul_(1.0)
    with pytest.raises(RuntimeError, match=r"values2d was written in place"):
        sess.step(1)


def test_the_fused_loop_checks_latent_pools_and_expert_weights():
    """deepseek-v3's paged MLA pools and its MoE weights are among what
    the loop checks: a rebound ``ckv`` pool and an expert weight written
    in place each raise before a chunk."""
    cfg = pair(arch="deepseek-v3-671b")[2]
    for what, change in (
            (r"caches\[2\]\['ckv'\]", lambda eng: eng._loop.caches[2].update(
                ckv=eng._loop.caches[2]["ckv"].clone())),
            (r"ffn\.experts\.w_gate was written in place",
             lambda eng: eng.model.layers[2].ffn.experts.w_gate.mul_(1.0))):
        eng = Engine(cfg, ServeConfig(max_seq=S_MAX, n_slots=2,
                                      page_size=PS), device="cpu")
        sess = eng.start_session(requests(1, (8,), 6)[1])
        sess.step(1)
        with torch.no_grad():
            change(eng)
        with pytest.raises(RuntimeError, match=what):
            sess.step(1)
