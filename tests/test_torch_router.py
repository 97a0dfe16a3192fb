"""The port's multi-replica router (``serve/router.py``) replayed against
the reference's on the cases of ``test_router.py`` and the router cases of
``test_device_loop.py`` and ``test_snapshot.py``, on smoke granite-3-2b in
float32 from the same weights.

Every fleet runs on one FakeClock advanced one second per decode step, so
streams, statuses, request timings, router counters and ``stats()`` are
compared exactly.  Port replicas share one model through
``Engine(..., params=first.params)``; reference replicas are copies of one
compiled engine (``tests/_torch_serving.py``).  On the CPU the fused loop
runs its one-step function eagerly and the RgCSR FFN runs K2's plain
version.
"""
import dataclasses
import json
import os

import pytest
import torch

from _torch_serving import (PORT, REF, SIDES, FakeClock, assert_same_serving,
                            both, engines, fleet, oracle, pair, requests)
from repro.serve import paging as ref_paging
from repro_torch.models import ffn
from repro_torch.serve import Engine, Router, RouterConfig, ServeConfig, \
    paging

torch.set_num_threads(1)

S_MAX = 64
PS = 4


def assert_same_fleet(ref_out, out, oracle_engine=None):
    """Streams, statuses, timings and merged stats equal; ok streams equal
    to ``generate`` of each request alone (port)."""
    (ref_reqs, ref_st), (reqs, st) = ref_out, out
    assert_same_serving(ref_reqs, reqs, ref_st, st, timing=True)
    assert [r.retries for r in reqs] == [r.retries for r in ref_reqs]
    assert [r.arrival_t for r in reqs] == [r.arrival_t for r in ref_reqs]
    if oracle_engine is not None:
        for r in reqs:
            if r.ok_like:
                assert r.out == oracle(oracle_engine, r)


# ----------------------------------------------------------- happy path


def test_router_serve_matches_oracle_across_replicas():
    def run(side, reqs):
        es, router = fleet(side, 2, FakeClock())
        router.serve(reqs)
        return reqs, router.stats(), es

    (ref_reqs, ref_st, _), (reqs, st, es) = both(run, 5, (8,) * 5, 5)
    assert_same_fleet((ref_reqs, ref_st), (reqs, st), es[0])
    assert all(r.ok_like for r in reqs)
    assert st["completed"] == 5
    assert st["migrations"] == 0 and st["shed"] == 0
    assert st["retries_exhausted"] == 0
    assert len(st["page_high_water_per_replica"]) == 2
    assert all(hw > 0 for hw in st["page_high_water_per_replica"])


# ----------------------------------------------------- failover + migration


_KILLED = {}


def _kill_one_of_three():
    """The 3-replica failover run of ``test_router.py`` (and of
    ``test_device_loop.py``: the same fleet at the default chunk, 8) on
    both packages, checked once and kept for the second test's asserts."""
    if _KILLED:
        return _KILLED["router"], _KILLED["reqs"]

    def run(side, reqs):
        fc = side.FaultConfig(max_restarts=3, backoff_s=0.5)
        es, router = fleet(
            side, 3, FakeClock(), fault_cfg=fc, decode_chunk=8,
            router_cfg=side.RouterConfig(n_replicas=3),
            injectors={1: side.FaultInjector(
                fail_at_steps=(("replica", 2),))})
        runners = [getattr(e, "_runner", None) for e in es]
        router.serve(reqs)
        return reqs, router.stats(), es, router, runners

    (ref_reqs, ref_st, _, ref_router, _), (reqs, st, es, router, runners) = \
        both(run, 5, (8,) * 8, 6)
    assert_same_fleet((ref_reqs, ref_st), (reqs, st), es[0])
    assert router.replicas[1].retired_stats == \
        ref_router.replicas[1].retired_stats
    assert all(r.ok_like for r in reqs)
    assert st["replica_faults"] == 1 and st["migrations"] > 0
    assert st["failed"] == 0 and st["retries_exhausted"] == 0
    assert st["completed"] == 8
    migrated = [r for r in reqs if r.retries > 0]
    assert migrated and all(r.retries == 1 for r in migrated)
    assert st["replica_restarts"] == 1
    assert all(s == "healthy" for s in st["replica_states"])
    # the restarted replica's fresh session took over the same serving
    # state: no engine built a second fused loop (a second capture on
    # the card)
    assert all(runner is not None for runner in runners)
    assert [e._runner for e in es] == runners
    _KILLED.update(router=router, reqs=reqs)
    return router, reqs


def test_replica_kill_mid_decode_migrates_token_identical():
    _kill_one_of_three()


def test_replica_kill_mid_chunk_migrates_partial_commit():
    """``test_device_loop.py``'s case: the ("replica", 2) fault splits the
    8-step chunk, so the dead session retired with exactly 2 steps."""
    router, reqs = _kill_one_of_three()
    assert router.replicas[1].retired_stats[0]["decode_steps"] == 2
    assert any(len(r.out) for r in reqs if r.retries > 0)


def test_replica_restart_backoff_schedule_on_fake_clock():
    def run(side, reqs):
        clock = FakeClock()
        fc = side.FaultConfig(max_restarts=3, backoff_s=10.0)
        es, router = fleet(side, 1, clock, fault_cfg=fc, n_slots=1,
                           injectors={0: side.FaultInjector(
                               fail_at_steps=(("replica", 1),))})
        for r in reqs:
            router.submit(r)
        while router.counters["replica_faults"] == 0:
            router.run_round()
        rep = router.replicas[0]
        at_fault = (rep.state, rep.restart_at)
        router.serve([])
        return reqs, router.stats(), es, at_fault, clock()

    ref_out, out = both(run, 6, (8, 8), 4)
    assert_same_fleet(ref_out[:2], out[:2], out[2][0])
    assert out[3:] == ref_out[3:]
    assert out[3] == ("dead", pytest.approx(11.0))
    assert out[4] >= 11.0
    assert out[1]["replica_restarts"] == 1
    assert all(r.ok_like for r in out[0])


def test_retry_budget_exhaustion_fails_requests():
    def run(side, reqs):
        fc = side.FaultConfig(max_restarts=0, backoff_s=1.0)
        _, router = fleet(side, 1, FakeClock(), fault_cfg=fc,
                          injectors={0: side.FaultInjector(
                              fail_at_steps=(("replica", 1),))})
        router.serve(reqs)
        return reqs, router.stats()

    ref_out, (reqs, st) = both(run, 7, (8,) * 4, 6)
    assert_same_fleet(ref_out, (reqs, st))
    assert all(r.done and r.status == "failed" for r in reqs)
    assert st["retries_exhausted"] == 4
    assert st["replica_restarts"] == 0
    assert st["replica_states"] == ["dead"]
    assert all(r.out is not None for r in reqs)


# ------------------------------------------------------------ backpressure


def test_backpressure_sheds_over_capacity_arrivals():
    late = requests(9, (8,), 3)

    def run(side, reqs):
        es, router = fleet(side, 1, FakeClock(), n_slots=1,
                           router_cfg=side.RouterConfig(n_replicas=1,
                                                        queue_limit=2))
        accepted = [router.submit(r) for r in reqs]
        while not router.idle:
            router.run_round()
        again = router.submit(late[SIDES.index(side)][0])
        router.serve([])
        return reqs, router.stats(), es, accepted, again

    ref_out, out = both(run, 8, (8,) * 5, 3)
    reqs, st, es, accepted, again = out
    assert_same_fleet(ref_out[:2], out[:2], es[0])
    assert (accepted, again) == tuple(ref_out[3:]) == (
        [True, True, False, False, False], True)
    shed = [r for r in reqs if r.status == "shed"]
    assert len(shed) == 3 and all(r.done and r.out == [] for r in shed)
    assert st["shed"] == 3
    assert all(r.ok_like for r in reqs if r.status != "shed")
    assert_same_serving(late[0], late[1])
    assert late[1][0].ok_like and \
        late[1][0].out == oracle(es[0], late[1][0])


# ----------------------------------------------------------- FIFO fairness


def test_fifo_fairness_across_replicas_under_sustained_overload():
    def run(side, reqs):
        es, router = fleet(side, 2, FakeClock(), n_slots=2, page_size=8,
                           n_pages=5)
        router.serve(reqs)
        return reqs, router.stats(), es

    ref_out, (reqs, st, es) = both(run, 12, (8,) * 8, 5)
    assert_same_fleet(ref_out[:2], (reqs, st), es[0])
    assert all(r.ok_like for r in reqs)
    slotted_at = [r.arrival_t + r.queue_s for r in reqs]
    assert slotted_at == sorted(slotted_at)


# ---------------------------------------------------------------- draining


def test_drain_replica_finishes_residents_then_recycles():
    def run(side, reqs):
        es, router = fleet(side, 2, FakeClock(), n_slots=1,
                           router_cfg=side.RouterConfig(n_replicas=2,
                                                        steps_per_round=1))
        runners = [getattr(e, "_runner", None) for e in es]
        for r in reqs:
            router.submit(r)
        router.run_round()
        resident = len(router.replicas[0].session.inflight())
        router.drain_replica(0)
        state = router.replicas[0].state
        while not router.idle:
            router.run_round()
        return (reqs, router.stats(), es, resident, state,
                router.replicas[0].state, runners)

    ref_out, out = both(run, 10, (8,) * 4, 8)
    reqs, st, es = out[:3]
    assert_same_fleet(ref_out[:2], out[:2], es[0])
    assert out[3:6] == ref_out[3:6]
    assert out[3] > 0 and out[4:6] == ("draining", "healthy")
    assert all(r.ok_like for r in reqs)
    assert st["drains"] == 1 and st["migrations"] == 0
    assert st["completed"] == 4
    assert [e._runner for e in es] == out[6]


# -------------------------------------------------- per-arrival deadlines


def test_deadline_measured_from_arrival_not_session_start():
    ref, eng = engines(clock=True, max_seq=S_MAX, n_slots=1, page_size=PS)
    out = []
    for e, (a, b, c) in zip((ref, eng), requests(3, (8,) * 3, [7, 3, 3],
                                                 [None, 3.0, 0.5])):
        session = e.start_session()
        session.submit(a)
        session.step(5)
        t_mid = e.clock()
        session.submit(b)
        session.submit(c)
        session.drain()
        out.append(([a, b, c], session.stats_snapshot(), t_mid))
    assert_same_fleet(out[0][:2], out[1][:2])
    (a, b, c), st, t_mid = out[1]
    assert t_mid == pytest.approx(5.0)
    assert b.arrival_t == pytest.approx(5.0)
    assert a.ok_like and b.ok_like
    assert b.queue_s == pytest.approx(1.0)
    assert c.status == "timed_out" and "in queue" in c.error
    assert st["timed_out"] == 1


def test_serve_batch_deadline_semantics_unchanged():
    ref, eng = engines(clock=True, max_seq=S_MAX, n_slots=1, page_size=PS)
    pair_ = requests(4, (8, 8), [8, 4], [None, 2.0])
    for e, reqs in zip((ref, eng), pair_):
        e.serve(reqs)
    assert_same_serving(*pair_, ref.paging_stats, eng.paging_stats,
                        timing=True)
    long, tight = pair_[1]
    assert long.ok_like
    assert tight.status == "timed_out"
    assert tight.arrival_t == pytest.approx(0.0)


# --------------------------------------------------------- stats plumbing


def test_merge_replica_stats_shapes():
    per = [{"requests": 3, "completed": 3, "page_high_water": 4,
            "peak_live_tokens": 20, "n_pages": 17, "kv_layout": "paged"},
           {"requests": 2, "completed": 1, "page_high_water": 7,
            "peak_live_tokens": 10, "n_pages": 17, "kv_layout": "paged"}]
    m = paging.merge_replica_stats([dict(p) for p in per])
    assert m == ref_paging.merge_replica_stats([dict(p) for p in per])
    assert m["requests"] == 5 and m["completed"] == 4
    assert m["page_high_water"] == 7
    assert m["page_high_water_per_replica"] == [4, 7]
    assert m["peak_live_tokens"] == 20
    assert m["n_pages"] == 17 and m["kv_layout"] == "paged"
    assert paging.merge_replica_stats([]) == {}


def test_straggler_decode_steps_per_replica():
    def run(side, reqs):
        clock = FakeClock()
        es, router = fleet(side, 2, clock, decode_chunk=1)
        count = [0]
        orig = es[1]._fused_decode

        def slow_fused(*a):
            out = orig(*a)
            for _ in range(int(out[1])):
                clock.advance(9.0 if count[0] >= 8 else 0.0)
                count[0] += 1
            return out

        es[1]._fused_decode = slow_fused
        router.serve(reqs)
        return reqs, router.stats()

    ref_out, (reqs, st) = both(run, 31, (6,) * 6, 12)
    assert_same_fleet(ref_out, (reqs, st))
    assert all(r.ok_like for r in reqs)
    per = st["straggler_decode_steps_per_replica"]
    assert len(per) == 2 and per[0] == 0 and per[1] > 0
    assert sum(per) == st["straggler_decode_steps"]


# ------------------------------------------------- crash-consistent fleets


def _without_generator(snap):
    return dict(snap, sessions=[
        {k: v for k, v in s.items()
         if k not in ("prng_key", "generator_state")}
        for s in snap["sessions"]])


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_kill_all_drill_router_fleet_restore(tmp_path, layout):
    """``test_snapshot.py``'s fleet drill: a shared ("process", 3)
    injector raises through ``run_round``; a rebuilt fleet restores the
    last router snapshot from disk and drains."""
    def run(side, reqs):
        clock = FakeClock()
        fc = side.FaultConfig(max_restarts=2, backoff_s=0.5)
        rcfg = side.RouterConfig(n_replicas=2, queue_limit=16)
        inj = side.FaultInjector(fail_at_steps=(("process", 3),))
        es, router = fleet(side, 2, clock, fault_cfg=fc, router_cfg=rcfg,
                           injectors={0: inj, 1: inj}, kv_layout=layout)
        for r in reqs:
            router.submit(r)
        mgr = side.checkpoint.SnapshotManager(
            str(tmp_path / f"rsnaps_{SIDES.index(side)}"))
        with pytest.raises(side.ProcessKilled):
            while not router.idle:
                mgr.save(router.snapshot())
                router.run_round()
        model = es[0].params if side is PORT else None
        es2, router2 = fleet(side, 2, clock, fault_cfg=fc, router_cfg=rcfg,
                             kv_layout=layout, params=model)
        state, _ = mgr.restore_latest()
        restored = router2.restore(state)
        while not router2.idle:
            router2.run_round()
        return restored, router2.stats(), es2, state

    (r_ref, st_ref, _, snap_ref), (r_port, st, es2, snap) = both(
        run, 24, (8,) * 6, 8)
    assert _without_generator(snap) == _without_generator(snap_ref)
    assert_same_fleet((r_ref, st_ref), (r_port, st), es2[0])
    assert len(r_port) == 6 and all(r.ok_like for r in r_port)
    assert st["failed"] == 0
    assert "straggler_decode_steps_per_replica" in st
    assert es2[1].params is es2[0].params


def test_snapshot_manager_roundtrip_retention_atomicity(tmp_path):
    for side in SIDES:
        d = str(tmp_path / f"snaps_{SIDES.index(side)}")
        mgr = side.checkpoint.SnapshotManager(d, keep=3)
        for i in range(5):
            mgr.save({"seq": i})
        files = sorted(f for f in os.listdir(d) if f.startswith("snap_"))
        assert files == [f"snap_{i:09d}.json" for i in (2, 3, 4)]
        assert not any(f.endswith(".tmp") for f in os.listdir(d))
        assert side.checkpoint.latest_snapshot(d) == 4
        state, seq = mgr.restore_latest()
        assert state == {"seq": 4} and seq == 4
        assert side.checkpoint.restore_snapshot(d, 3) == {"seq": 3}
        with pytest.raises(FileNotFoundError):
            side.checkpoint.restore_snapshot(d, 0)
        assert mgr.next_seq == 5
    # either package reads the other's snapshots
    for writer, reader in ((REF, PORT), (PORT, REF)):
        d = str(tmp_path / f"cross_{SIDES.index(writer)}")
        writer.checkpoint.SnapshotManager(d).save({"queue": [1, 2]})
        assert reader.checkpoint.SnapshotManager(d).restore_latest() == (
            {"queue": [1, 2]}, 0)


def test_snapshot_manager_empty_dir_raises(tmp_path):
    for side in SIDES:
        mgr = side.checkpoint.SnapshotManager(
            str(tmp_path / f"none_{SIDES.index(side)}"))
        with pytest.raises(FileNotFoundError):
            mgr.restore_latest()


def test_router_snapshot_is_plain_json():
    """A router snapshot mid-serve holds only Python ints, floats, strings
    and lists, so ``save_snapshot`` writes it as JSON."""
    _, router = fleet(PORT, 2, FakeClock(), router_cfg=RouterConfig(
        n_replicas=2, steps_per_round=1))
    for r in requests(11, (8,) * 5, 6)[1]:
        router.submit(r)
    router.run_round()
    snap = router.snapshot()
    assert json.loads(json.dumps(snap)) == snap
    assert all(s["requests"] for s in snap["sessions"]) and snap["queue"]


# ------------------------------------------------------- the port's own


def test_failover_with_the_rgcsr_ffn():
    """A replica fault under the RgCSR FFN (K2's plain version here): the
    same streams, statuses and stats as the reference; one plan per layer
    for the whole fleet."""
    def run(side, reqs):
        fc = side.FaultConfig(max_restarts=3, backoff_s=0.5)
        es, router = fleet(side, 2, FakeClock(), fault_cfg=fc, sparse=True,
                           decode_chunk=4,
                           injectors={1: side.FaultInjector(
                               fail_at_steps=(("replica", 2),))})
        router.serve(reqs)
        return reqs, router.stats(), es

    ref_out, (reqs, st, es) = both(run, 17, (8, 11, 9, 8, 10), 6)
    assert_same_fleet(ref_out[:2], (reqs, st), es[0])
    assert st["replica_faults"] == 1 and st["migrations"] >= 1
    assert all(r.ok_like for r in reqs)
    assert [e.plans_warmed for e in es] == [2, 0]
    builds = [m.plan_builds for m in es[0].model.modules()
              if isinstance(m, ffn.SparseLinear)]
    assert builds == [1, 1]


def test_an_engine_built_from_params_shares_the_model():
    """``Engine(cfg, scfg, params=first.params)`` takes the first engine's
    model as it is: no plan build, no second compute-dtype copy, only its
    own serving state."""
    cfg = dataclasses.replace(pair(True)[2], dtype="bfloat16")
    tree = pair(True)[3]
    scfg = ServeConfig(max_seq=S_MAX, n_slots=2, page_size=PS)
    first = Engine(cfg, scfg, params=tree, device="cpu")
    reqs = requests(19, (8, 9), 4)[1]
    first.serve(reqs)
    layers = [m for m in first.model.modules()
              if isinstance(m, ffn.SparseLinear)]
    casts = {id(m): dict(m._casts) for m in first.model.modules()
             if hasattr(m, "_casts")}
    assert sum(len(c) for c in casts.values()) > 0
    second = Engine(cfg, scfg, params=first.params)
    again = requests(19, (8, 9), 4)[1]
    second.serve(again)
    assert [r.out for r in again] == [r.out for r in reqs]
    assert second.model is first.model and second.plans_warmed == 0
    assert [m.plan_builds for m in layers] == [1] * len(layers)
    for m in first.model.modules():
        if hasattr(m, "_casts"):
            assert m._casts.keys() == casts[id(m)].keys()
            for key, hit in m._casts.items():
                assert hit[2] is casts[id(m)][key][2]
    assert second._loop is not first._loop
    ptrs = [{t.data_ptr() for c in e._loop.caches for t in c.values()}
            for e in (first, second)]
    assert not ptrs[0] & ptrs[1]
    with pytest.raises(ValueError, match="another config"):
        Engine(pair(True)[2], scfg, params=first.params)
    built = Router.build(cfg, scfg, 2, params=tree, device="cpu")
    assert built.replicas[1].engine.params is built.replicas[0].engine.params
