#!/usr/bin/env python3
"""Time the port's SpMV / SpMM calls as a user makes them, on one CUDA card.

Builds ``fem2d_2048`` and ``raj1_full`` with the recipes of ``chip_smoke.py``
and times, for each matrix, the K1 launch alone and the whole ``spmv``,
``spmm`` (d = 64) and ``ops.ell_spmv`` calls (plan-cache lookup, wrapper
work and epilogue included), and on ``raj1_full`` the whole ``spmv`` call
on its adaptive plan with ``spill_threshold=64``.  The timer is this script's own — one pair of
CUDA events around many back-to-back calls, divided by their count — so two
source trees compare on equal terms.  Prints one JSON line.

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
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def device_ms(fn, calls: int, repeats: int = 7) -> float:
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


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
    from repro_torch.kernels.rgcsr_spmv import rgcsr_spmv_launch

    dev = torch.device("cuda")
    rng = np.random.default_rng(chip_smoke.SEED)
    out = {"label": args.label, "src": args.src,
           "card": chip_smoke.card_line(), "ms": {}}
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
        xp = x.new_zeros(-(-a.shape[1] // 128) * 128)
        xp[: a.shape[1]] = x
        slow = name == "raj1_full"
        out["ms"][name] = {
            "k1_launch": device_ms(lambda: rgcsr_spmv_launch(
                p.values2d, p.columns2d, p.step_group, p.group_step_ptr, xp),
                5 if slow else 50),
            "spmv_call": device_ms(lambda: spmv(m, x), 5 if slow else 50),
            "spmm_call": device_ms(lambda: spmm(m, xm), 2 if slow else 10),
            "ell_spmv_call": device_ms(lambda: ops.ell_spmv(ell, x), 50),
        }
        if slow:      # Raj1's remedy: the adaptive plan with spill
            out["ms"][name]["adaptive_spmv_call"] = device_ms(
                lambda: spmv(m, x, ordering="adaptive", spill_threshold=64),
                50)
        del m, ell, p
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
