"""The port's Chrome trace export (``obs/export.py``, a copy of the
reference's) against the reference's: the same FakeClock serve — one
engine, a failover fleet, a crash drill — exports byte-identical JSON from
both packages, the exports validate and cross-check against the run's own
counters, spans left open by a crash are closed, and ``span_summary`` and
the validator's and cross-check's verdicts agree."""
import json

import numpy as np
import pytest
import torch

from _torch_serving import (PORT, SIDES, FakeClock, both, engines, fleet,
                            requests)
from repro.obs import export as ref_export
from repro.obs import trace as ref_trace
from repro_torch.obs import export, trace
from repro_torch.serve import Request

torch.set_num_threads(1)

MODULES = ((ref_export, ref_trace), (export, trace))


def _exports(tracers):
    texts = [mod.export_chrome_trace(tr)
             for (mod, _), tr in zip(MODULES, tracers)]
    assert texts[1] == texts[0]
    assert export.span_summary(tracers[1]) == \
        ref_export.span_summary(tracers[0])
    doc = json.loads(texts[1])
    assert export.validate_chrome_trace(doc) == []
    return doc


def test_engine_trace_is_byte_identical_to_the_reference():
    ref, eng = engines(clock=True, max_seq=64, n_slots=3, page_size=8,
                       n_pages=5, decode_chunk=4)
    tracers = [mod.Tracer(clock=e.clock)
               for (_, mod), e in zip(MODULES, (ref, eng))]
    ref.tracer, eng.tracer = tracers
    for e, reqs in zip((ref, eng), requests(7, (8,) * 4, 5)):
        e.serve(reqs)
    doc = _exports(tracers)
    assert export.cross_check_counters(doc, eng.paging_stats) == []
    summ = export.span_summary(doc)
    assert summ["spans"]["request"]["n"] >= 4
    assert summ["spans"]["prefill"]["n"] >= 4
    assert summ["events"]["fused_dispatch"] >= 1
    assert summ["events"]["preempt"] == eng.paging_stats["preemptions"] > 0


def test_failover_trace_is_byte_identical_and_cross_checks():
    def run(side, reqs):
        clock = FakeClock()
        tracer = MODULES[SIDES.index(side)][1].Tracer(clock=clock)
        fc = side.FaultConfig(max_restarts=3, backoff_s=0.5)
        _, router = fleet(side, 2, clock, fault_cfg=fc, tracer=tracer,
                          injectors={1: side.FaultInjector(
                              fail_at_steps=(("replica", 2),))})
        router.serve(reqs)
        return tracer, router.stats()

    (ref_tr, _), (tr, st) = both(run, 5, (8,) * 4, 5)
    doc = _exports([ref_tr, tr])
    assert st["replica_faults"] == 1 and st["migrations"] >= 1
    assert export.cross_check_counters(doc, st) == []
    pnames = {ev["pid"]: ev["args"]["name"] for ev in doc["traceEvents"]
              if ev.get("ph") == "M" and ev.get("name") == "process_name"}
    faults = [ev for ev in doc["traceEvents"]
              if ev.get("name") == "replica_fault" and ev.get("ph") == "i"]
    assert faults and all(pnames[ev["pid"]] == "replica1" for ev in faults)


def test_crash_drill_trace_closes_abandoned_spans(tmp_path):
    """A ("process", 3) kill leaves spans open; a rebuilt fleet restores
    the last snapshot on the same tracer.  The export closes what the
    crash left open, validates, and holds at least every counted event."""
    def run(side, reqs):
        clock = FakeClock()
        tracer = MODULES[SIDES.index(side)][1].Tracer(clock=clock)
        fc = side.FaultConfig(max_restarts=2, backoff_s=0.5)
        inj = side.FaultInjector(fail_at_steps=(("process", 3),))
        es, router = fleet(side, 2, clock, fault_cfg=fc, tracer=tracer,
                           injectors={0: inj, 1: inj})
        for r in reqs:
            router.submit(r)
        mgr = side.checkpoint.SnapshotManager(
            str(tmp_path / f"s{SIDES.index(side)}"))
        with pytest.raises(side.ProcessKilled):
            while not router.idle:
                mgr.save(router.snapshot())
                router.run_round()
        _, router2 = fleet(side, 2, clock, fault_cfg=fc, tracer=tracer,
                           params=es[0].params if side is PORT else None)
        router2.restore(mgr.restore_latest()[0])
        router2.serve([])
        return tracer, router2.stats()

    (ref_tr, _), (tr, st) = both(run, 24, (8,) * 6, 8)
    doc = _exports([ref_tr, tr])
    assert export.cross_check_counters(doc, st, mode="at_least") == []
    closers = [ev for ev in doc["traceEvents"]
               if (ev.get("args") or {}).get("abandoned")]
    assert closers


def _scripted(mod, tmod):
    """A hand-written event stream: spans left open, counters, instants,
    a request lifeline, and a wrong-replica attribution."""
    clock = FakeClock()
    tr = tmod.Tracer(clock=clock)
    req = Request(tokens=np.zeros(2, np.int32), max_new_tokens=1)
    tr.request_begin(req, ("router", "main"), prompt=2)
    tr.begin("prefill", ("replica0", "slot0"), tokens=2)
    clock.advance(1.0)
    tr.end("prefill", ("replica0", "slot0"))
    tr.begin("decode_chunk", ("replica0", "session"), chunk=4)
    tr.instant("preempt", ("replica0", "slot0"), slot=0)
    tr.instant("migrate", ("replica0", "session"), replica=1)
    tr.counter("free_pages", ("replica0", "session"), free=3)
    tr.request_point(req, "migrated", ("router", "main"))
    clock.advance(0.25)
    doc = json.loads(mod.export_chrome_trace(tr))
    return (mod.export_chrome_trace(tr), mod.validate_chrome_trace(doc),
            mod.span_summary(tr),
            mod.cross_check_counters(doc, {"migrations": 1,
                                           "preemptions": 1}),
            mod.cross_check_counters(doc, {"preemptions": 2},
                                     mode="at_least"),
            mod.validate_chrome_trace({"traceEvents": [
                {"name": "a", "ph": "B", "ts": 1, "pid": 1, "tid": 1},
                {"name": "b", "ph": "E", "ts": 0, "pid": 1, "tid": 1}]}))


def test_scripted_trace_and_verdicts_match_the_reference():
    got, want = (_scripted(*m) for m in reversed(MODULES))
    assert got == want
    text, problems, summ, attribution, at_least, bad = got
    assert problems == []
    assert summ["spans"]["prefill"]["n"] == 1
    assert summ["spans"]["prefill"]["total_s"] == pytest.approx(1.0)
    assert summ["events"]["migrated"] == 1
    assert attribution and at_least and bad
    closers = [ev for ev in json.loads(text)["traceEvents"]
               if (ev.get("args") or {}).get("abandoned")]
    assert {ev["ph"] for ev in closers} == {"E", "e"}
    assert export.DEFAULT_COUNTER_EVENTS == ref_export.DEFAULT_COUNTER_EVENTS
