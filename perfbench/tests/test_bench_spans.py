"""The span metrics' readers (``perfbench/spans.py``): exact shares on
hand-made events and busy intervals, the chat shares within the Slice's
idle time, and the span stretch: none in a ``--trace 0`` run, none for a
program without the process-wide tracer, and on the CPU, at small sizes,
the program's spans recorded and read."""
import time
import types

import pytest

from conftest import small
from perfbench import harness, spans

TRACK = ("replica0", "host")
READERS = ("admit_idle.decode", "dispatch_idle.decode", "commit_idle.decode",
           "port_call_us.sparse", "launch_us.sparse")


def _ev(ph, name, us, track=TRACK):
    return {"ph": ph, "name": name, "ts": us, "track": track}


# one step, in µs: admit 0-40 (a prefill 10-30), schedule 40-50, dispatch
# 50-90 (the first replay launched at 60, then wait 60-90), commit 90-100
STEP = [_ev("B", "session.step", 0), _ev("B", "session.admit", 0),
        _ev("B", "session.prefill", 10), _ev("E", "session.prefill", 30),
        _ev("E", "session.admit", 40), _ev("B", "session.schedule", 40),
        _ev("E", "session.schedule", 50), _ev("B", "decode.dispatch", 50),
        _ev("B", "decode.wait", 60), _ev("E", "decode.wait", 90),
        _ev("E", "decode.dispatch", 90), _ev("B", "session.commit", 90),
        _ev("E", "session.commit", 100), _ev("E", "session.step", 100)]


def _run(events, busy_us, t0=0, t1=100):
    """A run whose stretch recorded ``events`` and a Slice over [t0, t1]
    µs busy on ``busy_us``."""
    sl = types.SimpleNamespace(t0=t0 * 1000, t1=t1 * 1000, gpu=[("k", 0, 1,
                                                                 False)],
                               busy=[(a * 1000, b * 1000)
                                     for a, b in busy_us])
    return types.SimpleNamespace(host={"span_events": events,
                                       "span_slice": sl, "span_count": 1})


@pytest.mark.parametrize("busy,want", [
    # the prefill's kernels 12-28 and the replays 55-88 keep the card busy
    ([(12, 28), (55, 88)],
     {"admit": 24.0, "dispatch": 10.0 + 5, "commit": 10.0}),
    # nothing on the card: each phase's whole length
    ([], {"admit": 40.0, "dispatch": 20.0, "commit": 10.0}),
    # busy all through: no idle anywhere
    ([(0, 100)], {"admit": 0.0, "dispatch": 0.0, "commit": 0.0})])
def test_idle_shares_are_exact(busy, want):
    run = _run(STEP, busy)
    got = {"admit": spans.idle_share(run, spans.ADMIT),
           "dispatch": spans.idle_share(run, spans.DISPATCH),
           "commit": spans.idle_share(run, spans.COMMIT)}
    assert got == pytest.approx(want, abs=1e-12)
    idle = 100.0 - sum(b - a for a, b in busy)
    assert sum(got.values()) <= idle + 1e-9


def test_chat_shares_sum_within_the_slices_idle():
    """Over many steps, with a window wider than the spans and busy
    intervals that straddle the phases: the three shares count disjoint
    parts of the card's idle time."""
    events = [dict(ev, ts=ev["ts"] + 100 * k) for k in range(5)
              for ev in STEP]
    busy = [(100 * k + 5, 100 * k + 45) for k in range(5)] \
        + [(100 * k + 58, 100 * k + 95) for k in range(5)]
    run = _run(events, sorted(busy), t0=-20, t1=520)
    parts = [spans.idle_share(run, names) for names in
             (spans.ADMIT, spans.DISPATCH, spans.COMMIT)]
    idle = 100.0 * (540 - sum(b - a for a, b in busy)) / 540
    assert all(p > 0 for p in parts) and sum(parts) < idle


def test_self_time_and_per_product_means():
    # session.step: no time outside its children
    assert spans.self_seconds(STEP, TRACK) == pytest.approx({
        "session.admit": 20e-6,
        "session.prefill": 20e-6, "session.schedule": 10e-6,
        "decode.dispatch": 10e-6, "decode.wait": 30e-6,
        "session.commit": 10e-6})
    k = ("kernels", "host")
    call = [_ev("B", "sparse.call", 0, k), _ev("B", "sparse.launch", 3, k),
            _ev("E", "sparse.launch", 9, k), _ev("E", "sparse.call", 10, k)]
    events = call + [dict(ev, ts=ev["ts"] + 20) for ev in call]
    events[-1] = dict(events[-1], ts=34)        # the second call: 14 µs
    run = _run(events, [])
    assert spans.per_product_us(run, "sparse.call") == pytest.approx(12.0)
    assert spans.per_product_us(run, "sparse.launch") == pytest.approx(6.0)


def test_readers_find_nothing_without_a_stretch(bench):
    class Empty:
        trace = False
        substitute = None
        host = {}
        traffic = {"runner": "closed_loop"}
    for name in READERS:
        assert bench.reader(name).read(Empty()) is None
    assert "span_events" in Empty.host and not spans.recorded(Empty())


def test_a_plain_run_installs_no_tracer(bench, monkeypatch):
    """A ``--trace 0`` run of a CPU-substituted cell: no tracer installed,
    no span stretch, nothing of it in ``run.host``."""
    from repro_torch.obs import trace

    def refuse(*args, **kwargs):
        raise AssertionError("a tracer was installed in a --trace 0 run")
    monkeypatch.setattr(trace, "recording", refuse)
    cfg, tr = small("fem2d.spmv")
    run, runner, st, _ = harness.execute(
        bench, "fem2d.spmv", 3, 0.2, False, "cpu", time.perf_counter(),
        config_override=cfg, traffic_override=tr,
        substitute=lambda st: (lambda x: x.clone()))
    runner.check(run, st)
    assert trace.active() is trace.NOOP
    assert not [k for k in run.host if k.startswith("span_")]


def _traced(bench, cell, **kw):
    cfg, tr = small(cell)
    run, runner, st, _ = harness.execute(
        bench, cell, 11, 0.3, True, "cpu", time.perf_counter(),
        config_override=cfg, traffic_override={**tr, "trace_seconds": 0.3},
        **kw)
    return run


def test_a_program_without_the_slot_reads_none(bench, monkeypatch):
    """The parent's program has no ``recording``: the readers return None
    and run no stretch."""
    from repro_torch.obs import trace
    monkeypatch.delattr(trace, "recording")
    run = _traced(bench, "fem2d.spmv")
    reader = bench.reader("port_call_us.sparse")
    monkeypatch.setattr(harness, "load_module", None)   # no set-up again
    assert reader.read(run) is None
    assert run.host["span_events"] is None


@pytest.mark.parametrize("cell", ["fem2d.spmv", "fem2d.spmm64"])
def test_the_products_stretch_records_the_sparse_spans(bench, cell):
    """Whole blocks of ``enqueue_products``, and no profiler beside them."""
    run = _traced(bench, cell)
    call = bench.reader("port_call_us.sparse").read(run)
    launch = bench.reader("launch_us.sparse").read(run)
    block = int(bench.traffic(run.cell["traffic"])["enqueue_products"])
    assert run.host["span_count"] > 0 and run.host["span_count"] % block == 0
    assert run.host["span_slice"] is None
    assert len(spans.spans(run.host["span_events"], "sparse.call")) \
        == run.host["span_count"]
    assert 0 < launch < call
    from repro_torch.obs import trace
    assert trace.active() is trace.NOOP


def test_the_serving_stretch_records_the_session_spans(bench):
    """On the CPU: the session's spans recorded and nested, no device
    activity, so the idle shares read nothing."""
    run = _traced(bench, "gqa2b.chat")
    assert spans.recorded(run) and run.host["span_count"] > 0
    events = run.host["span_events"]
    assert spans.session_track(events) == TRACK
    names = set(spans.self_seconds(events, TRACK))
    assert {"session.step", "session.admit", "session.schedule",
            "decode.dispatch", "decode.wait", "session.commit"} <= names
    for name in READERS[:3]:
        assert bench.reader(name).read(run) is None


def test_the_serving_stretch_lasts_half_a_deck_of_admissions(bench):
    """Sized by work: step calls until ``deck // 2`` requests have been
    prefilled in the stretch, the last call the one that got there."""
    cfg, tr = small("gqa2b.chat")
    run = _traced(bench, "gqa2b.chat")
    assert spans.recorded(run)
    events = run.host["span_events"]
    steps = [i for i, ev in enumerate(events)
             if ev["ph"] == "B" and ev["name"] == "session.step"]
    assert len(steps) == run.host["span_count"]

    def admitted(upto):
        return sum(ev["ph"] == "B" and ev["name"] == "session.prefill"
                   for ev in events[:upto])
    assert admitted(len(events)) >= tr["deck"] // 2 > admitted(steps[-1])


def test_the_serving_stretch_profiles_the_card_alone(bench, monkeypatch):
    """The stretch's Slice asks the profiler for the card's activity and
    no host operation, and on the CPU for the host's alone."""
    import torch
    import torch.profiler as tp
    run = _traced(bench, "gqa2b.chat")
    assert spans.recorded(run)
    assert isinstance(run.host["span_slice"], spans.CardSlice)
    asked = []

    class Profile:
        def __init__(self, activities):
            asked.append(activities)

        def start(self):
            pass
    monkeypatch.setattr(tp, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    spans.CardSlice(torch.device("cuda", 0)).start()
    spans.CardSlice(torch.device("cpu")).start()
    assert asked == [[tp.ProfilerActivity.CUDA], [tp.ProfilerActivity.CPU]]
