"""Serving launcher: bring up the paged continuous-batching engine, or a
fault-tolerant multi-replica router over it.

The PyTorch counterpart of ``repro.launch.serve``, with its flags, report
lines and exit rule, plus ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions on the host).  ``main(argv)`` returns the exit
code.

Usage:
  python -m repro_torch.launch.serve --arch granite-3-2b --smoke \
      --requests 8 --kv-layout paged --page-size 16 --mixed-lengths

Overload drills (DESIGN.md §6.4): shrink the pool below aggregate worst
case with --n-pages and the default prompt-pages admission policy serves
the queue via recompute preemption; --admission-policy worst_case restores
FIFO deferral; --deadline-s puts a completion deadline on every request;
--strict restores fail-stop serving (oversized requests raise).  The
overload report prints per-status counts and the preemption counters.

Multi-replica drills (DESIGN.md §7):
  --replicas N      front N engine replicas (shared params, independent
                    KV pools) with the health-checked Router: failover
                    migrates in-flight requests off faulted replicas,
                    re-prefilling prompt + generated prefix on survivors.
  --router-queue K  bound the router queue at K waiting requests;
                    over-capacity arrivals are shed (status="shed")
                    instead of queueing unboundedly.  0 = unbounded.
  --retry-budget R  per-request migration budget AND per-replica restart
                    budget (FaultConfig.max_restarts).
  --drain I         drain replica I after the first scheduling round:
                    stop admitting to it, let residents finish, recycle
                    it with a fresh session (planned maintenance).
  --kill-replica I --kill-at-step K
                    inject a replica-tier fault (FaultInjector site
                    "replica") on replica I's K-th decode step — the
                    failover drill the router bench and tests run.

Crash-consistency drills (DESIGN.md §7.6):
  --snapshot-every N   write a crash-consistent snapshot (session or
                       whole-router state, train/checkpoint.py atomic
                       write + rolling retention) every N scheduling
                       rounds into --snapshot-dir.
  --restore-from DIR   start by restoring the latest snapshot under DIR
                       (the dead process's queue and in-flight requests
                       resume token-identically), then serve the new
                       requests behind them.
  --kill-process-at K  inject a ("process", K) fault: the whole process
                       dies at decode step K.  With --snapshot-every set
                       the launcher then runs the full drill in-process:
                       rebuild the fleet from params, restore the latest
                       snapshot, drain — the crash lane's CI check.  The
                       dead engines are dropped first, so their caches
                       and decode graphs go back to the card.
  --corrupt-page IDX   inject KV-page corruption into live page IDX at a
                       chunk boundary (--corrupt-nan: NaN poison caught
                       by the logit screen instead of silent garbage
                       caught by the checksum verify); requires
                       --kv-integrity for detection/recovery.
  --kv-integrity       arm per-page crc32 checksums + NaN/Inf logit
                       screening (detection quarantines the page and
                       recompute-preempts exactly the touched requests).

Observability (DESIGN.md §13):
  --trace-out PATH     attach a Tracer to every engine/router and export
                       the run's span timeline (request lifelines, prefill
                       and decode-chunk spans, fault/migration/restore
                       instants) as Chrome trace-event JSON at PATH —
                       loadable in Perfetto or chrome://tracing — with
                       the port's host-layer spans beside them (the same
                       Tracer is obs.trace.active for the run: session
                       phases, fused dispatch, sparse call and launch).
                       The report also prints a span-timeline summary.
  --metrics-json PATH  write the final stats dict (merged metrics-registry
                       view, including request_timing histogram states and
                       latency percentiles) as JSON — the file CI's
                       check_trace.py cross-checks against the trace.
"""
import argparse
import gc
import sys
import time
from collections import Counter

import numpy as np
import torch


def _release():
    """Give a dead fleet's KV caches and decode-graph pools back to the
    card: the engines hold each other through their sessions, so the
    collector frees them, then the caching allocator's free blocks go."""
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--kv-layout", choices=("paged", "dense"),
                    default="paged")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="decode steps fused per on-device dispatch "
                         "(graph replays per host sync, DESIGN.md §7.1); "
                         "1 = stepwise host sync every token")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="page-pool size; 0 = dense capacity + null page "
                         "(size below worst case to exercise preemption)")
    ap.add_argument("--mixed-lengths", action="store_true",
                    help="cycle prompt lengths instead of a uniform 16")
    ap.add_argument("--admission-policy", choices=("prompt", "worst_case"),
                    default="prompt",
                    help="prompt: admit on resident pages, preempt on "
                         "exhaustion; worst_case: reserve the worst case "
                         "and defer admissions (PR 5 behavior)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request completion deadline in seconds from "
                         "the request's arrival; 0 = none")
    ap.add_argument("--strict", action="store_true",
                    help="fail-stop: oversized requests / mid-request "
                         "faults raise out of serve() instead of failing "
                         "only that request")
    ap.add_argument("--straggler-factor", type=float, default=2.0,
                    help="watchdog: flag decode steps slower than this "
                         "factor times the EWMA step time")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the router; 1 = single "
                         "engine, no router (DESIGN.md §7)")
    ap.add_argument("--router-queue", type=int, default=0,
                    help="router queue bound; arrivals beyond it are shed "
                         "(status=\"shed\"); 0 = unbounded")
    ap.add_argument("--retry-budget", type=int, default=3,
                    help="per-request migration / per-replica restart "
                         "budget (FaultConfig.max_restarts)")
    ap.add_argument("--drain", type=int, default=-1, metavar="REPLICA",
                    help="drain this replica index after the first round "
                         "(finish residents, recycle); -1 = off")
    ap.add_argument("--kill-replica", type=int, default=-1,
                    help="inject a replica-tier fault on this replica "
                         "index (failover drill); -1 = off")
    ap.add_argument("--kill-at-step", type=int, default=2,
                    help="decode step of the injected replica fault")
    ap.add_argument("--kv-integrity", action="store_true",
                    help="arm per-page checksums + NaN/Inf logit "
                         "screening (DESIGN.md §7.6)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="write a crash-consistent snapshot every N "
                         "scheduling rounds; 0 = off")
    ap.add_argument("--snapshot-dir", default="snapshots_serve",
                    help="directory for --snapshot-every / the crash "
                         "drill's restore point")
    ap.add_argument("--restore-from", default="",
                    help="restore the latest snapshot under this "
                         "directory before serving new requests")
    ap.add_argument("--kill-process-at", type=int, default=-1,
                    help="inject a (\"process\", K) fault at decode step "
                         "K; with --snapshot-every the launcher rebuilds "
                         "and restores in-process (crash drill); -1 = off")
    ap.add_argument("--corrupt-page", type=int, default=-1,
                    help="corrupt live KV page IDX at a chunk boundary "
                         "(page-corruption drill); -1 = off")
    ap.add_argument("--corrupt-nan", action="store_true",
                    help="NaN-poison the corrupted page (logit-screen "
                         "path) instead of silent garbage (checksum path)")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="record a per-request span timeline and write it "
                         "as Chrome trace-event JSON (load in Perfetto / "
                         "chrome://tracing) to PATH (DESIGN.md §13)")
    ap.add_argument("--metrics-json", default="", metavar="PATH",
                    help="write the final stats dict (the merged metrics "
                         "registry view) as JSON to PATH")
    ap.add_argument("--device", default="cuda",
                    help="the engines' device: cuda (the card) or cpu")
    args = ap.parse_args(argv)
    if not args.trace_out:
        return _serve(args, None)
    from repro_torch.obs.trace import Tracer, recording
    # the engines' events and the port's host-layer spans on one timeline
    with recording(Tracer()) as tracer:
        return _serve(args, tracer)


def _serve(args, tracer) -> int:
    """Serve ``args``'s requests; ``tracer`` (or None) records them."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.serve import Engine, Request, Router, RouterConfig, \
        ServeConfig
    from repro_torch.train.checkpoint import SnapshotManager, \
        restore_snapshot
    from repro_torch.train.fault import FaultConfig, FaultInjector, \
        ProcessKilled

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    scfg = ServeConfig(
        max_seq=args.max_seq, n_slots=args.slots, kv_layout=args.kv_layout,
        page_size=args.page_size, n_pages=args.n_pages,
        decode_chunk=args.decode_chunk,
        admission_policy=args.admission_policy, strict=args.strict,
        deadline_s=args.deadline_s, kv_integrity=args.kv_integrity)
    fault_cfg = FaultConfig(straggler_factor=args.straggler_factor,
                            max_restarts=args.retry_budget)
    fail_at = []
    if args.kill_process_at >= 0:
        fail_at.append(("process", args.kill_process_at))
    if args.corrupt_page >= 0:
        fail_at.append(("page_nan" if args.corrupt_nan else "page",
                        args.corrupt_page))
    injector = FaultInjector(fail_at_steps=fail_at) if fail_at else None
    write_mgr = SnapshotManager(args.snapshot_dir) \
        if args.snapshot_every > 0 else None
    rng = np.random.default_rng(0)
    lengths = [16] * args.requests
    if args.mixed_lengths:
        mix = (8, 24, 16, 48)
        lengths = [min(mix[i % len(mix)], args.max_seq - args.max_new)
                   for i in range(args.requests)]
    reqs = [Request(tokens=rng.integers(0, cfg.vocab, (ln,)).astype(np.int32),
                    max_new_tokens=args.max_new)
            for ln in lengths]

    restored = []
    crash_recovered = False
    killed = None
    snap_seq = None
    if args.replicas > 1:
        first = Engine(cfg, scfg, device=args.device, fault_cfg=fault_cfg)
        engines = [first] + [Engine(cfg, scfg, params=first.params,
                                    fault_cfg=fault_cfg)
                             for _ in range(args.replicas - 1)]
        if 0 <= args.kill_replica < len(engines):
            engines[args.kill_replica].fault_injector = FaultInjector(
                fail_at_steps=(("replica", args.kill_at_step),))
        if injector is not None:
            # process/page sites fire once — sharing the injector arms
            # whichever replica reaches the step first
            for e in engines:
                e.fault_injector = injector
            del e      # the crash drill frees the fleet: hold no engine

        def build_router(es):
            # the same tracer survives the crash-drill rebuild, so the
            # exported timeline spans the whole run including recovery
            return Router(es, cfg=RouterConfig(
                n_replicas=args.replicas, queue_limit=args.router_queue),
                fault_cfg=fault_cfg, tracer=tracer)

        router = build_router(engines)
        if args.restore_from:
            restored = router.restore(restore_snapshot(args.restore_from))
        t0 = time.time()
        for r in reqs:
            router.submit(r)
        rounds = 0
        try:
            while not router.idle:
                if write_mgr and rounds % args.snapshot_every == 0:
                    write_mgr.save(router.snapshot())
                router.run_round()
                rounds += 1
                if rounds == 1 and 0 <= args.drain < len(engines):
                    router.drain_replica(args.drain)
        except ProcessKilled as exc:
            if write_mgr is None:
                raise
            killed = repr(exc)
        if killed is not None:
            # the whole-process crash drill: every replica, session, and
            # queue is gone — rebuild the fleet from params and resume
            # from the last crash-consistent snapshot
            crash_recovered = True
            print(f"process killed ({killed}); rebuilding the fleet and "
                  "restoring the latest snapshot")
            model = first.params
            del first, engines, router
            _release()
            engines = [Engine(cfg, scfg, params=model, fault_cfg=fault_cfg)
                       for _ in range(args.replicas)]
            router = build_router(engines)
            state, snap_seq = write_mgr.restore_latest()
            restored = router.restore(state)
            while not router.idle:
                router.run_round()
        dt = time.time() - t0
        done = [r for r in reqs if r.done] + restored
        ps = router.stats()
    else:
        eng = Engine(cfg, scfg, device=args.device, fault_cfg=fault_cfg,
                     fault_injector=injector)
        if tracer is not None:
            eng.tracer = tracer       # before any session is started
        t0 = time.time()
        if write_mgr is None and not args.restore_from:
            done = eng.serve(reqs)
            dt = time.time() - t0
            ps = eng.paging_stats
        else:
            sess = eng.start_session()
            if args.restore_from:
                restored = sess.restore(
                    restore_snapshot(args.restore_from))
            for r in reqs:
                sess.submit(r)
            rounds = 0
            try:
                while not sess.idle:
                    if write_mgr and rounds % args.snapshot_every == 0:
                        write_mgr.save(sess.snapshot())
                    sess.step(max(1, args.decode_chunk))
                    rounds += 1
            except ProcessKilled as exc:
                if write_mgr is None:
                    raise
                killed = repr(exc)
            if killed is not None:
                crash_recovered = True
                print(f"process killed ({killed}); rebuilding the engine "
                      "and restoring the latest snapshot")
                model = eng.params
                del eng, sess
                _release()
                eng = Engine(cfg, scfg, params=model, fault_cfg=fault_cfg)
                if tracer is not None:
                    eng.tracer = tracer
                state, snap_seq = write_mgr.restore_latest()
                sess, restored = eng.restore_session(state)
                sess.drain()
            dt = time.time() - t0
            done = [r for r in reqs if r.done] + restored
            eng.paging_stats = sess.stats_snapshot()
            ps = eng.paging_stats

    total = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests / {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s); all done: {all(r.done for r in done)}")
    by_status = Counter(r.status for r in done)
    print("request status:", dict(sorted(by_status.items())))
    if ps:
        d = max(ps.get("decode_dispatches", 0), 1)
        print(f"fused decode: {ps['decode_steps']} decode steps in "
              f"{ps.get('decode_dispatches', 0)} dispatches "
              f"(chunk {args.decode_chunk}, "
              f"{ps['decode_steps'] / d:.1f} tokens/dispatch)")
    if ps and ps.get("kv_layout") == "paged":
        print(f"paging: high-water {ps['page_high_water']} pages, "
              f"{ps['admission_deferrals']} admission deferrals")
        print(f"overload: policy {ps['admission_policy']}, "
              f"{ps['preemptions']} preemptions "
              f"({ps['recompute_tokens']} recompute tokens, "
              f"{ps['pages_evicted']} pages evicted), "
              f"{ps['rejected']} rejected, {ps['failed']} failed, "
              f"{ps['timed_out']} timed out, "
              f"{ps['straggler_decode_steps']} straggler decode steps")
    if crash_recovered:
        n_ok = sum(r.ok_like for r in restored)
        print(f"crash drill: restored {len(restored)} requests from "
              f"snapshot seq {snap_seq}; {n_ok} completed ok, "
              f"{len(restored) - n_ok} not ok")
    if args.kv_integrity and ps:
        print(f"integrity: {ps.get('nonfinite_logits', 0)} non-finite "
              f"logit events, {ps.get('pages_quarantined', 0)} pages "
              f"quarantined, {ps.get('double_release', 0)} double "
              f"releases, {ps.get('restores', 0)} restores "
              f"({ps.get('restore_recompute_tokens', 0)} restore-"
              "recompute tokens)")
    if args.replicas > 1:
        print(f"router: {ps['n_replicas']} replicas "
              f"{ps['replica_states']}, per-replica page high-water "
              f"{ps.get('page_high_water_per_replica')}, "
              f"{ps['migrations']} migrations, "
              f"{ps['replica_faults']} replica faults / "
              f"{ps['replica_restarts']} restarts, "
              f"{ps['retries_exhausted']} retry-budget exhaustions, "
              f"{ps['shed']} shed, {ps['drains']} drains")
    if ps and ps.get("latency_percentiles"):
        parts = []
        for name in ("queue_s", "prefill_s", "latency_s"):
            q = ps["latency_percentiles"].get(name)
            if q:
                parts.append(f"{name} p50/p95/p99 = {q['p50'] * 1e3:.1f}/"
                             f"{q['p95'] * 1e3:.1f}/{q['p99'] * 1e3:.1f} ms")
        if parts:
            print("percentiles:", "; ".join(parts))
    if args.metrics_json:
        import json
        with open(args.metrics_json, "w") as fh:
            json.dump(ps, fh, indent=2, sort_keys=True,
                      default=lambda o: o.item() if hasattr(o, "item")
                      else str(o))
        print(f"metrics written to {args.metrics_json}")
    if tracer is not None:
        from repro_torch.obs import export as obs_export
        obs_export.export_chrome_trace(tracer, args.trace_out)
        summ = obs_export.span_summary(tracer)
        spans = ", ".join(
            f"{name}×{s['n']} ({s['total_s']:.3f}s total, "
            f"{s['mean_s'] * 1e3:.1f}ms mean)"
            for name, s in sorted(summ["spans"].items()))
        events = ", ".join(f"{name}×{n}" for name, n
                           in sorted(summ["events"].items()))
        print(f"span timeline: {spans or 'none'}")
        print(f"trace events: {events or 'none'}")
        print(f"trace written to {args.trace_out} "
              f"({len(tracer.events)} events)")
    # chaos-lane gate (CI): a drill run must leave no request unfinished,
    # and under an injected kill or page corruption every request must end
    # in an ok-like state — anything else is a recovery bug, exit non-zero
    if not all(r.done for r in done):
        print("# FAIL: unfinished requests", file=sys.stderr)
        return 1
    drill = crash_recovered or args.corrupt_page >= 0 \
        or args.kill_process_at >= 0
    if drill and any(not r.ok_like for r in done):
        print("# FAIL: a request did not survive the fault drill",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
