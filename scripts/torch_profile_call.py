#!/usr/bin/env python3
"""Trace whole calls of the port with ``torch.profiler`` on one CUDA card.

Builds ``raj1_full`` with the recipe of ``chip_smoke.py`` and traces, after
two warmup calls, ``--calls`` back-to-back calls of each of: the block
``spmv`` call, the block ``spmm`` call (d = 64) and the ``spmv`` call on
the adaptive plan with ``spill_threshold=64``.  For each call it prints one
JSON line: the total device µs per call, and the profiler's ops and
kernels, each with its count, host (self CPU) µs and device µs per call,
the largest first.  Only calls that exist in every tree of the port are
used, so ``--src`` can name another tree, and two trees compare in turns on
one machine::

    python3 scripts/torch_profile_call.py --src OLD/src --label parent
    python3 scripts/torch_profile_call.py --label change
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def trace(fn, calls: int, top: int):
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        rows.append({"name": ev.key[:100], "count": ev.count / calls,
                     "cpu_us": ev.self_cpu_time_total / calls,
                     "device_us": dev_us / calls})
    rows.sort(key=lambda r: -max(r["cpu_us"], r["device_us"]))
    return {"device_us": sum(r["device_us"] for r in rows),
            "ops": rows[:top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory to import repro_torch from")
    ap.add_argument("--label", default="")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--top", type=int, default=16)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_profile_call: no CUDA card is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.core import from_csr, spmm, spmv

    dev = torch.device("cuda")
    rng = np.random.default_rng(chip_smoke.SEED)
    a = chip_smoke.raj1_csr()
    m = from_csr(a.data, a.indices, a.indptr, a.shape, "rgcsr", device=dev)
    x = torch.from_numpy(rng.standard_normal(a.shape[1])
                         .astype(np.float32)).to(dev)
    xm = torch.from_numpy(rng.standard_normal((a.shape[1], 64))
                          .astype(np.float32)).to(dev)
    calls = {
        "raj1_full spmv": lambda: spmv(m, x),
        "raj1_full spmm d64": lambda: spmm(m, xm),
        "raj1_full adaptive spill64 spmv": lambda: spmv(
            m, x, ordering="adaptive", spill_threshold=64),
    }
    card = chip_smoke.card_line()
    for what, fn in calls.items():
        print(json.dumps({"label": args.label, "src": args.src, "card": card,
                          "call": what, **trace(fn, args.calls, args.top)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
