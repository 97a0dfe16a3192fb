"""The port's copies of the framework-free modules — ``obs/metrics.py``,
``obs/trace.py`` and ``train/fault.py`` — give the reference's outputs on
the same inputs: registry snapshots and restores, ``merge_stats`` (the
serving merge spec included), tracer events, and the fault injector's and
watchdog's decisions."""
import numpy as np
import pytest

from repro.obs import metrics as ref_metrics
from repro.obs import trace as ref_trace
from repro.serve import paging as ref_paging
from repro.train import fault as ref_fault
from repro_torch.obs import metrics, trace
from repro_torch.serve import paging
from repro_torch.train import fault


def _registry_story(mod, seed):
    """Fill a registry from a seeded stream of updates; return its
    snapshot, its scalars, a restored copy's snapshot and the view."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    view = reg.view(counters=("steps", "dispatches"),
                    gauges=("peak", "frag"))
    view["frag"] = 0.0
    for _ in range(40):
        op = int(rng.integers(0, 5))
        if op == 0:
            view["steps"] += int(rng.integers(1, 4))
        elif op == 1:
            reg.counter("faults", replica=int(rng.integers(0, 2))).inc()
        elif op == 2:
            view["peak"] = max(view["peak"], int(rng.integers(0, 100)))
        elif op == 3:
            reg.histogram("latency_s").observe(float(rng.uniform(0, 2)))
        else:
            reg.gauge("level", slot=int(rng.integers(0, 3))).set_max(
                float(rng.uniform(0, 9)))
    snap = reg.snapshot()
    again = mod.MetricsRegistry()
    again.restore(snap)
    return snap, reg.scalars(), again.snapshot(), dict(view)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_registry_matches_the_reference(seed):
    assert _registry_story(metrics, seed) == _registry_story(ref_metrics,
                                                             seed)


def _replica_stats(seed):
    rng = np.random.default_rng(seed)
    out = []
    for r in range(3):
        hist = {"samples": [float(v) for v in rng.uniform(0, 1, 5)]}
        out.append({
            "requests": int(rng.integers(0, 9)),
            "completed": int(rng.integers(0, 9)),
            "decode_steps": int(rng.integers(0, 99)),
            "straggler_decode_steps": int(rng.integers(0, 3)),
            "page_high_water": int(rng.integers(0, 40)),
            "n_pages": 41, "page_size": 16, "kv_layout": "paged",
            "request_timing": {"latency_s": hist},
            **({"peak_live_tokens": 7} if r else {}),
        })
    return out


def test_merge_stats_and_the_serving_spec_match_the_reference():
    per_replica = _replica_stats(4)
    assert paging.merge_replica_stats(per_replica) == \
        ref_paging.merge_replica_stats(per_replica)
    assert set(paging.SERVE_MERGE_SPEC) == set(ref_paging.SERVE_MERGE_SPEC)
    spec = {"a": metrics.MergeRule("sum", list_as="a_each"),
            "b": metrics.MergeRule("max", gate="g"),
            "c": metrics.MergeRule("first")}
    ref_spec = {k: ref_metrics.MergeRule(r.kind, r.list_as, r.gate)
                for k, r in spec.items()}
    rows = [{"a": 1, "c": "x", "g": 0}, {"a": 5, "b": 3}]
    assert metrics.merge_stats(rows, spec) == \
        ref_metrics.merge_stats(rows, ref_spec)
    timing = {"q": {"samples": [0.5, 0.1, 0.9, 0.3]}}
    assert metrics.timing_percentiles(timing) == \
        ref_metrics.timing_percentiles(timing)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


class _Req:
    pass


def _trace_story(mod):
    tr = mod.Tracer(clock=_Clock())
    reqs = [_Req(), _Req()]
    for req in reqs:
        tr.request_begin(req, ("replica0", "session"), prompt=8)
    tr.request_begin(reqs[0], ("replica0", "session"))      # idempotent
    tr.begin("decode_chunk", ("replica0", "session"), chunk=8)
    tr.counter("free_pages", ("replica0", "session"), free=12)
    tr.instant("preempt", ("replica0", "slot1"), slot=1)
    tr.request_point(reqs[1], "admitted", ("replica0", "slot1"))
    tr.end("decode_chunk", ("replica0", "session"), steps=8)
    tr.request_end(reqs[0], ("replica0", "session"), status="ok")
    tr.request_end(reqs[0], ("replica0", "session"))         # closed
    noop = mod.NOOP
    noop.begin("x", ("a", "b"))
    return tr.events, noop.enabled


def test_tracer_events_match_the_reference():
    assert _trace_story(trace) == _trace_story(ref_trace)


def _fault_story(mod):
    inj = mod.FaultInjector(fail_at_steps=(
        ("prefill", 1), ("decode", 2), 7, ("replica", 5), ("process", 9),
        ("page", 3), ("page", 1), ("page_nan", 4)))
    log = []
    for site, step, exact in (("prefill", 0, False), ("prefill", 1, False),
                              ("decode", 2, False), ("replica", 7, False),
                              ("process", 7, True), ("process", 9, True)):
        try:
            inj.check(step, site=site, exact=exact)
            log.append("pass")
        except Exception as e:  # noqa: BLE001 — the decision is the output
            log.append((type(e).__name__, str(e)))
    log.append(inj.next_armed("replica", 0, 10))
    log.append(inj.next_armed("process", 0, 10, exact=True))
    log += [inj.take("page"), inj.take("page"), inj.take("page"),
            inj.take("page_nan")]
    dog = mod.Watchdog(mod.FaultConfig(straggler_factor=2.0))
    flags = [dog.observe(i, dt) for i, dt in enumerate(
        [1.0, 1.1, 0.9, 1.0, 1.05, 1.0, 9.0, 1.0, 1.0, 3.5, 1.0])]
    return log, inj.fired, flags, list(dog.events)


def test_fault_injector_and_watchdog_decide_as_the_reference():
    got, want = _fault_story(fault), _fault_story(ref_fault)
    assert got == want
    assert any(got[2])                       # a straggler was flagged
    assert ("ProcessKilled", "injected fault at process 9") in got[0]
