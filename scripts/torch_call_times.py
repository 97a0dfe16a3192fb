#!/usr/bin/env python3
"""Time the port's SpMV / SpMM calls as a user makes them, on one CUDA card.

Builds ``fem2d_2048`` and ``raj1_full`` with the recipes of ``chip_smoke.py``
and times, for each matrix, K1 and K2 on the block plan through
``ops.rgcsr_spmv(plan, x)`` and ``ops.rgcsr_spmm(plan, X)`` (d = 64; the
launch and its wrapper, no plan-cache lookup), the whole ``spmv``, ``spmm``
and ``ops.ell_spmv`` calls (plan-cache lookup, wrapper work and epilogue
included), and on ``raj1_full`` the whole ``spmv`` call on its adaptive
plan with ``spill_threshold=64``.  Only calls that exist in every tree of
the port are used, so any two trees compare.  For each call it reports
``wait_ms``, what a caller waits per call in a loop (one pair of CUDA
events around many back-to-back calls, over their count: the card's time
where the card is the slower, the host's where the host is); ``device_ms``,
the card's time alone (the same, behind a spin kernel that holds the card
until every call is queued — a per-kernel metric that hides the host); and
``host_ms``, the host's time per call to enqueue them (perf_counter around
the loop, before the end event is waited on).  Medians of repeats.  Prints
one JSON line.

To compare two trees on the same card, run them in turns on one machine::

    python3 scripts/torch_call_times.py --src OLD/src --label parent
    python3 scripts/torch_call_times.py --label change
    python3 scripts/torch_call_times.py --label change
    python3 scripts/torch_call_times.py --src OLD/src --label parent
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def call_ms(fn, calls: int, repeats: int = 7):
    """Median ``wait_ms``, ``device_ms`` and ``host_ms`` per call.

    The timer is this script's own and not ``repro_torch.core.timing``:
    ``--src`` may name an older tree whose ``time_us`` times differently,
    and two trees compare only under one timer.  The spin that holds the
    card for ``device_ms`` outlasts the host's enqueue of all ``calls``
    (1.5× the last repeat's enqueue time, 2.5 ms at the first)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    cycles_per_ms = 1e7 / start.elapsed_time(end)
    wait, device, host = [], [], [2.5 / calls]
    for _ in range(repeats):
        for held in (False, True):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if held:
                torch.cuda._sleep(int(cycles_per_ms
                                      * (1.5 * host[-1] * calls + 0.2)))
            start.record()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            t1 = time.perf_counter()
            end.record()
            end.synchronize()
            (device if held else wait).append(start.elapsed_time(end) / calls)
            if not held:
                host.append((t1 - t0) * 1e3 / calls)
    return (float(np.median(wait)), float(np.median(device)),
            float(np.median(host[1:])))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory to import repro_torch from")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_call_times: no CUDA card is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.core import ELLPACK, from_csr, spmm, spmv
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(chip_smoke.SEED)
    out = {"label": args.label, "src": args.src,
           "card": chip_smoke.card_line(), "wait_ms": {}, "device_ms": {},
           "host_ms": {}}
    for name, a in (("fem2d_2048", chip_smoke.fem2d_csr(2048, 2048)),
                    ("raj1_full", chip_smoke.raj1_csr())):
        def build(fmt):
            return from_csr(a.data, a.indices, a.indptr, a.shape, fmt,
                            device=dev)

        m = build("rgcsr")
        if name == "raj1_full":   # the ELL part of Hybrid, as chip_smoke
            h = build("hybrid")
            ell = ELLPACK(values=h.ell_values, columns=h.ell_columns,
                          shape=h.shape)
            del h
        else:
            ell = build("ellpack")
        ell = ops.make_ell_plan(ell)
        x = torch.from_numpy(rng.standard_normal(a.shape[1])
                             .astype(np.float32)).to(dev)
        xm = torch.from_numpy(rng.standard_normal((a.shape[1], 64))
                              .astype(np.float32)).to(dev)
        p = ops.get_plan(m)
        slow = name == "raj1_full"   # the parent's K1/K2 take 5 / 44 ms
        calls = {
            "k1_ops": (lambda: ops.rgcsr_spmv(p, x), 20 if slow else 50),
            "k2_ops": (lambda: ops.rgcsr_spmm(p, xm), 10),
            "spmv_call": (lambda: spmv(m, x), 20 if slow else 50),
            "spmm_call": (lambda: spmm(m, xm), 10),
            "ell_spmv_call": (lambda: ops.ell_spmv(ell, x), 50),
        }
        if slow:      # Raj1's remedy: the adaptive plan with spill
            calls["adaptive_spmv_call"] = (lambda: spmv(
                m, x, ordering="adaptive", spill_threshold=64), 50)
        times = {k: call_ms(fn, n) for k, (fn, n) in calls.items()}
        for i, key in enumerate(("wait_ms", "device_ms", "host_ms")):
            out[key][name] = {k: t[i] for k, t in times.items()}
        del m, ell, p
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
