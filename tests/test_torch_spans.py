"""The port's host-layer spans on the process-wide tracer
(``obs.trace.active`` / ``recording``): their clock is the profiler's, they
cost nothing while no tracer is active, they nest as the serving session
and the sparse layer run and balance when a prefill fails, they leave the
engine's own event stream as it was, and a plan or work list built is one
``host_build`` instant."""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.configs.base import SparsityConfig
from repro_torch.core import from_dense, spmm, spmv
from repro_torch.kernels import ops
from repro_torch.obs import export, trace
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.train.fault import FaultInjector

HOST = ("replica0", "host")
# each span of the serving session and the sparse layer, and its parent
PARENT = {"session.step": None, "session.admit": "session.step",
          "session.prefill": "session.admit",
          "session.schedule": "session.step",
          "decode.dispatch": "session.step",
          "decode.wait": "decode.dispatch",
          "session.commit": "session.step",
          "sparse.call": None, "sparse.launch": "sparse.call"}


def _engine(**serve_kw):
    """Smoke granite-3-2b in float32 with the RgCSR FFN (K2's plain
    version on the CPU), its weights drawn from the engine's seed."""
    cfg = dataclasses.replace(
        get_smoke("granite-3-2b"), dtype="float32",
        kv_cache_dtype="float32",
        sparsity=SparsityConfig(enabled=True, density=0.25, group_size=128,
                                impl="kernel"))
    kw = dict(max_seq=64, n_slots=2, page_size=8, decode_chunk=4)
    return Engine(cfg, ServeConfig(**{**kw, **serve_kw}), device="cpu")


def _requests(seed, lens=(6, 9, 5), max_new=5):
    rng = np.random.default_rng(seed)
    return [Request(tokens=rng.integers(0, 512, (n,)).astype(np.int32),
                    max_new_tokens=max_new) for n in lens]


def _matrix(seed=0, n=300, m=200):
    a = np.random.default_rng(seed).standard_normal((n, m)).astype(
        np.float32)
    a[np.abs(a) < 1.2] = 0
    return from_dense(a, "rgcsr", device="cpu")


def _nesting(events, track):
    """``(name, parent, args of its end)`` of each span on ``track``, in
    the order they end; every end must close the innermost open span."""
    stack, out = [], []
    for ev in events:
        if tuple(ev["track"]) != track:
            continue
        if ev["ph"] == "B":
            stack.append(ev["name"])
        elif ev["ph"] == "E":
            assert stack and stack[-1] == ev["name"], (stack, ev)
            stack.pop()
            out.append((ev["name"], stack[-1] if stack else None,
                        ev.get("args", {})))
    assert not stack, stack
    return out


def test_spans_share_the_profilers_clock():
    """A span around a ``record_function`` range encloses the profiler's
    interval of it, to within the microsecond the span rounds to."""
    from torch.profiler import ProfilerActivity, profile, record_function
    tr = trace.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.begin("outer", HOST)
        with record_function("inner"):
            torch.ones(256, 256).sum()
        tr.end("outer", HOST)
    inner, = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "inner"]
    begin, end = (ev["ts"] * 1000 for ev in tr.events)
    assert inner.duration_ns() > 0
    assert begin - 1000 <= inner.start_ns()
    assert inner.start_ns() + inner.duration_ns() <= end + 1000


def test_nothing_is_recorded_while_no_tracer_is_active(monkeypatch):
    """With :func:`trace.active` at NOOP, serving and the sparse products
    build no tracer and record no event."""
    def refuse(*args, **kwargs):
        raise AssertionError("a Tracer was built or written to while "
                             "tracing was off")

    eng = _engine()
    monkeypatch.setattr(trace.Tracer, "__init__", refuse)
    monkeypatch.setattr(trace.Tracer, "_emit", refuse)
    assert trace.active() is trace.NOOP
    done = eng.serve(_requests(1))
    assert all(r.ok_like for r in done)
    a = _matrix()
    spmv(a, torch.ones(200), impl="kernel")
    spmm(a, torch.ones(200, 3), impl="kernel")
    assert trace.active() is trace.NOOP and not hasattr(trace.NOOP,
                                                        "events")


def test_the_sparse_path_reads_the_slot_without_a_call(monkeypatch):
    """A product whose plan is built reads the slot itself, one load and
    one branch a site: it never calls :func:`trace.active`, on or off."""
    def refuse():
        raise AssertionError("trace.active() called on the sparse path")

    a = _matrix(7)
    spmv(a, torch.ones(200), impl="kernel")          # builds the plan
    monkeypatch.setattr(trace, "active", refuse)
    spmv(a, torch.ones(200), impl="kernel")
    with trace.recording(trace.Tracer()) as tr:
        spmv(a, torch.ones(200), impl="kernel")
        spmm(a, torch.ones(200, 3), impl="kernel")
    assert [ev["name"] for ev in tr.events if ev["ph"] == "E"] \
        == ["sparse.launch", "sparse.call"] * 2


def test_recording_installs_the_tracer_and_puts_back_the_last():
    outer, inner = trace.Tracer(), trace.Tracer()
    with trace.recording(outer):
        with pytest.raises(KeyError):
            with trace.recording(inner):
                assert trace.active() is inner
                raise KeyError
        assert trace.active() is outer
    assert trace.active() is trace.NOOP


def test_session_spans_nest_as_the_session_runs():
    eng = _engine()
    with trace.recording(trace.Tracer()) as tr:
        done = eng.serve(_requests(2))
    assert all(r.ok_like for r in done)
    spans = _nesting(tr.events, HOST)
    names = {name for name, _, _ in spans}
    assert names == {n for n, p in PARENT.items()
                     if not n.startswith("sparse.")}
    for name, parent, _ in spans:
        assert PARENT[name] == parent, (name, parent)
    # each step's phases in their order: admit, schedule, dispatch, commit
    order = [name for name, parent, _ in spans if parent == "session.step"]
    assert order[:4] == ["session.admit", "session.schedule",
                         "decode.dispatch", "session.commit"]
    steps = [a for n, _, a in spans if n == "decode.dispatch"]
    assert sum(a["steps"] for a in steps) == eng.paging_stats["decode_steps"]
    assert sum(n == "session.prefill" for n, _, _ in spans) == 3
    # K2's plain version in each layer of each prefill and (eager on the
    # CPU) each decode step: sparse.launch on the kernels track
    forwards = 3 + eng.paging_stats["decode_steps"]
    assert [n for n, _, _ in _nesting(tr.events, trace.KERNELS)] \
        == ["sparse.launch"] * (forwards * eng.model.cfg.n_layers)
    assert export.validate_chrome_trace(export.chrome_trace(tr)) == []


@pytest.mark.parametrize("strict", [False, True])
def test_spans_balance_when_a_prefill_fails(strict):
    """An injected prefill fault: the request fails alone and its
    ``session.prefill`` ends with ``error``; under ``strict`` the fault
    escapes ``step()`` and every span it left open ends with ``error``."""
    eng = _engine(strict=strict)
    eng.fault_injector = FaultInjector(fail_at_steps=(("prefill", 1),))
    with trace.recording(trace.Tracer()) as tr:
        with pytest.raises(RuntimeError) if strict \
                else contextlib.nullcontext():
            done = eng.serve(_requests(3))
    spans = _nesting(tr.events, HOST)
    failed = [(p, a) for n, p, a in spans
              if n == "session.prefill" and a.get("error")]
    assert failed == [("session.admit", {"error": True})]
    if strict:
        assert spans[-1] == ("session.step", None, {"error": True})
    else:
        assert [r.status for r in done].count("failed") == 1
    doc = export.chrome_trace(tr, close_open=False)
    assert export.validate_chrome_trace(doc) == []


def test_the_engines_own_events_are_unchanged_by_recording():
    """The engine's tracer, on its injected clock, records the same
    events with the port's spans recorded beside it as without."""
    def served(record):
        eng = _engine()
        ticks = iter(range(1, 10**6))
        eng.clock = lambda: float(next(ticks))
        eng.tracer = trace.Tracer(clock=eng.clock)
        with trace.recording(trace.Tracer()) if record \
                else contextlib.nullcontext():
            eng.serve(_requests(4))
        return eng.tracer.events

    plain = served(False)
    assert plain and served(True) == plain


def test_sparse_spans_nest_and_a_plan_is_built_once():
    a = _matrix(5)
    with trace.recording(trace.Tracer()) as tr:
        spmv(a, torch.ones(200), impl="kernel")
        spmv(a, torch.ones(200), impl="kernel")
        spmm(a, torch.ones(200, 3), impl="kernel")
    spans = _nesting(tr.events, trace.KERNELS)
    assert [(n, p) for n, p, _ in spans] == [
        ("sparse.launch", "sparse.call"), ("sparse.call", None)] * 3
    builds = [ev["args"]["what"] for ev in tr.events
              if ev["name"] == "host_build"]
    assert builds == ["plan_cache"]


def test_a_work_list_build_is_one_host_build_instant():
    """``RgCSRPlan.work_list`` at a new ``part_bytes`` (K2's G·d·4: each
    new width) records one ``host_build``; a repeat records none."""
    plan = ops.make_plan(_matrix(6))
    with trace.recording(trace.Tracer()) as tr:
        for d in (8, 8, 64, 8, 64):
            plan.work_list("rgcsr_spmm", n_sm=132, part_bytes=128 * d * 4)
    keys = [ev["args"]["key"] for ev in tr.events
            if ev["name"] == "host_build"
            and ev["args"]["what"] == "work_list"]
    assert keys == [repr(("rgcsr_spmm", 132, 128 * d * 4, None))
                    for d in (8, 64)]
