"""Chrome trace-event JSON export + validation (DESIGN.md §13.3).

:func:`chrome_trace` turns a :class:`~repro_torch.obs.trace.Tracer`'s raw
events into the Chrome trace-event format (the JSON-object flavour with
a ``traceEvents`` array plus ``metadata``), loadable in Perfetto or
``chrome://tracing``.  Each distinct track process (replica, router)
becomes a pid with a ``process_name`` metadata record; each lane
(session, slot*k*, device) becomes a tid with a ``thread_name`` record —
so the timeline renders as one track per replica with per-slot lanes.

pids/tids are assigned by first appearance in the event stream, which is
itself deterministic under FakeClock, so
:func:`export_chrome_trace`'s canonical JSON (sorted keys, no
whitespace) is byte-identical across identical runs — the property the
determinism tests pin.

:func:`validate_chrome_trace` and :func:`cross_check_counters` are the
CI trace-lane gates: schema + monotonic-timestamps + balanced spans, and
"every counted migration/preemption/restore appears as a trace event on
the right replica track".
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["chrome_trace", "export_chrome_trace", "validate_chrome_trace",
           "cross_check_counters", "span_summary", "DEFAULT_COUNTER_EVENTS"]


def _events_of(source) -> List[Dict]:
    return list(source.events if hasattr(source, "events") else source)


def _close_abandoned(events: Sequence[Dict]) -> List[Dict]:
    """Synthesize closing events for spans still open at the end of the
    recording (a crash drill kills the process mid-request), so exported
    traces always balance.  Synthesized closers carry
    ``args.abandoned = true`` and the last seen timestamp."""
    open_sync: Dict[tuple, List[Dict]] = {}
    open_async: Dict[tuple, Dict] = {}
    last_ts = 0
    for ev in events:
        last_ts = max(last_ts, ev["ts"])
        ph = ev["ph"]
        if ph == "B":
            open_sync.setdefault(tuple(ev["track"]), []).append(ev)
        elif ph == "E":
            stack = open_sync.get(tuple(ev["track"]))
            if stack:
                stack.pop()
        elif ph == "b":
            open_async[(ev.get("cat"), ev.get("id"))] = ev
        elif ph == "e":
            open_async.pop((ev.get("cat"), ev.get("id")), None)
    closers: List[Dict] = []
    for track, stack in sorted(open_sync.items()):
        for ev in reversed(stack):
            closers.append({"ph": "E", "name": ev["name"], "ts": last_ts,
                            "track": track, "args": {"abandoned": True}})
    for (cat, uid), ev in sorted(open_async.items(),
                                 key=lambda kv: (kv[0][0] or "", kv[0][1])):
        closers.append({"ph": "e", "name": ev["name"], "ts": last_ts,
                        "track": tuple(ev["track"]), "cat": cat, "id": uid,
                        "args": {"abandoned": True}})
    return list(events) + closers


def chrome_trace(source, close_open: bool = True) -> Dict:
    """Build the Chrome trace-event document from a tracer (or a raw
    event list).  ``close_open`` finalizes abandoned spans (see
    :func:`_close_abandoned`) so crash-drill traces still validate."""
    events = _events_of(source)
    if close_open:
        events = _close_abandoned(events)

    pids: Dict[str, int] = {}
    tids: Dict[Tuple[str, str], int] = {}
    meta: List[Dict] = []
    body: List[Dict] = []
    for ev in events:
        proc, lane = ev["track"]
        pid = pids.get(proc)
        if pid is None:
            pid = pids[proc] = len(pids) + 1
            meta.append({"ph": "M", "name": "process_name", "pid": pid,
                         "tid": 0, "ts": 0, "args": {"name": proc}})
        tid = tids.get((proc, lane))
        if tid is None:
            tid = tids[(proc, lane)] = \
                sum(1 for p, _ in tids if p == proc) + 1
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": tid, "ts": 0, "args": {"name": lane}})
        out: Dict = {"name": ev["name"], "ph": ev["ph"], "ts": ev["ts"],
                     "pid": pid, "tid": tid,
                     "cat": ev.get("cat", "serve")}
        if ev["ph"] == "i":
            out["s"] = "t"
        if ev["ph"] in ("b", "n", "e"):
            out["id"] = ev["id"]
        if "args" in ev:
            out["args"] = ev["args"]
        body.append(out)
    return {"traceEvents": meta + body, "displayTimeUnit": "ms",
            # the reference's format tag: both packages export the same bytes
            "metadata": {"format": "repro.obs chrome-trace", "version": 1}}


def export_chrome_trace(source, path: Optional[str] = None) -> str:
    """Canonical JSON text of the trace (sorted keys, compact separators
    — the byte-identical form the determinism tests compare); optionally
    written to ``path``."""
    doc = source if isinstance(source, dict) else chrome_trace(source)
    text = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


# ---------------------------------------------------------------------------
# validation (CI trace-export smoke lane)
# ---------------------------------------------------------------------------

_REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")


def validate_chrome_trace(doc: Dict) -> List[str]:
    """Return a list of problems (empty == valid): required keys on every
    event, non-decreasing timestamps per (pid, tid) track, balanced and
    name-matched B/E duration stacks, and balanced async b/e pairs per
    (cat, id)."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]

    last_ts: Dict[tuple, int] = {}
    stacks: Dict[tuple, List[Dict]] = {}
    async_open: Dict[tuple, Dict] = {}
    for i, ev in enumerate(events):
        for k in _REQUIRED_KEYS:
            if k not in ev:
                problems.append(f"event {i}: missing key {k!r}")
        ph = ev.get("ph")
        if ph == "M":
            continue
        track = (ev.get("pid"), ev.get("tid"))
        ts = ev.get("ts", 0)
        if track in last_ts and ts < last_ts[track]:
            problems.append(
                f"event {i} ({ev.get('name')}): ts {ts} < {last_ts[track]} "
                f"on track pid={track[0]} tid={track[1]}")
        last_ts[track] = max(last_ts.get(track, 0), ts)
        if ph == "B":
            stacks.setdefault(track, []).append(ev)
        elif ph == "E":
            stack = stacks.get(track) or []
            if not stack:
                problems.append(
                    f"event {i}: E {ev.get('name')!r} with no open B on "
                    f"track pid={track[0]} tid={track[1]}")
            else:
                b = stack.pop()
                if b.get("name") != ev.get("name"):
                    problems.append(
                        f"event {i}: E {ev.get('name')!r} closes B "
                        f"{b.get('name')!r} (bad nesting)")
        elif ph == "b":
            key = (ev.get("cat"), ev.get("id"))
            if key in async_open:
                problems.append(f"event {i}: duplicate async begin {key}")
            async_open[key] = ev
        elif ph == "e":
            key = (ev.get("cat"), ev.get("id"))
            if key not in async_open:
                problems.append(f"event {i}: async end with no begin {key}")
            else:
                del async_open[key]
        elif ph == "n":
            key = (ev.get("cat"), ev.get("id"))
            if key not in async_open:
                problems.append(
                    f"event {i}: async instant outside lifeline {key}")
        elif ph in ("i", "C"):
            pass
        else:
            problems.append(f"event {i}: unknown phase {ph!r}")
    for track, stack in stacks.items():
        for ev in stack:
            problems.append(
                f"unclosed B {ev.get('name')!r} on track pid={track[0]} "
                f"tid={track[1]}")
    for key in async_open:
        problems.append(f"unclosed async lifeline {key}")
    return problems


# (stats counter key, trace event name) pairs the CI lane gates on:
# every counted occurrence must appear as exactly that many trace events.
DEFAULT_COUNTER_EVENTS = (
    ("migrations", "migrate"),
    ("preemptions", "preempt"),
    ("restores", "restore"),
    ("replica_faults", "replica_fault"),
    ("replica_restarts", "replica_restart"),
    ("shed", "shed"),
    ("timed_out", "deadline_expired"),
    ("pages_quarantined", "page_quarantine"),
)


def _process_names(doc: Dict) -> Dict[int, str]:
    return {ev["pid"]: ev["args"]["name"]
            for ev in doc.get("traceEvents", ())
            if ev.get("ph") == "M" and ev.get("name") == "process_name"}


def cross_check_counters(doc: Dict, stats: Dict,
                         checks=DEFAULT_COUNTER_EVENTS,
                         mode: str = "exact") -> List[str]:
    """Gate that the trace and the merged stats agree: for each (counter,
    event-name) pair with the counter present in ``stats``, the trace
    must contain exactly that many events of that name; and any event
    carrying an ``args.replica`` attribution must sit on the pid whose
    process_name is ``replica<r>``.

    ``mode="at_least"`` relaxes the count check to ``trace >= counter``:
    a crash drill restores counters from the last snapshot, so work done
    (and traced) after that snapshot rolls back in the stats but its
    events legitimately remain in the continuous trace."""
    if mode not in ("exact", "at_least"):
        raise ValueError(f"mode must be 'exact' or 'at_least', got {mode!r}")
    problems: List[str] = []
    names = _process_names(doc)
    by_name: Dict[str, int] = {}
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") == "M":
            continue
        point = (ev.get("args") or {}).get("point")
        key = point if point is not None else ev.get("name")
        by_name[key] = by_name.get(key, 0) + 1
        rep = (ev.get("args") or {}).get("replica")
        if rep is not None:
            proc = names.get(ev.get("pid"), "")
            if proc != f"replica{rep}":
                problems.append(
                    f"event {ev.get('name')!r} tagged replica={rep} sits "
                    f"on process {proc!r}")
    for counter, event_name in checks:
        if counter not in stats:
            continue
        want = int(stats[counter])
        got = by_name.get(event_name, 0)
        if (got < want) if mode == "at_least" else (got != want):
            problems.append(
                f"counter {counter}={want} but trace has {got} "
                f"{event_name!r} events" +
                (" (at_least mode)" if mode == "at_least" else ""))
    return problems


def span_summary(source) -> Dict:
    """Per-name span duration stats + instant counts for the launcher's
    drill report (works on a tracer or a chrome-trace doc)."""
    if isinstance(source, dict):
        events = [dict(ev, track=(ev.get("pid"), ev.get("tid")))
                  for ev in source.get("traceEvents", ())
                  if ev.get("ph") != "M"]
    else:
        events = _close_abandoned(_events_of(source))
    spans: Dict[str, List[float]] = {}
    instants: Dict[str, int] = {}
    stacks: Dict[tuple, List[Dict]] = {}
    for ev in events:
        track = tuple(ev["track"])
        ph = ev["ph"]
        if ph == "B":
            stacks.setdefault(track, []).append(ev)
        elif ph == "E":
            stack = stacks.get(track)
            if stack:
                b = stack.pop()
                spans.setdefault(b["name"], []).append(
                    (ev["ts"] - b["ts"]) / 1e6)
        elif ph in ("i", "n"):
            name = (ev.get("args") or {}).get("point") or ev["name"]
            instants[name] = instants.get(name, 0) + 1
    out_spans = {}
    for name in sorted(spans):
        ds = spans[name]
        out_spans[name] = {"n": len(ds),
                           "total_s": round(sum(ds), 6),
                           "mean_s": round(sum(ds) / len(ds), 6),
                           "max_s": round(max(ds), 6)}
    return {"spans": out_spans,
            "events": {k: instants[k] for k in sorted(instants)}}
