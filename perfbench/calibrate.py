"""Readings for a cell's limits: the program's number on many seeds, and
the control's on some, in one process on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 \\
        --control 3 --seconds <s> [--seed0 <n>] [--out <file.jsonl>]

For each seed it runs the cell as a run does (set-up, a window of
``--seconds``, the program's state released) and reads the number each
check compares; for the first ``--control`` seeds it also reads the
control's: the reference in the program's place, a precision below the
configuration's (``control_reading`` of the cell's runner), on the same
inputs.  A limit lies above the largest program reading and below the
smallest control reading (``PERF.md`` gives both and the limit).  It
prints one JSON line a seed.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path.cwd()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed0", type=int, default=2**31 + 101)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    for path in (ROOT / "src", ROOT):
        sys.path.insert(0, str(path))
    import torch
    from perfbench import harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.Bench(ROOT)
    for i in range(args.seeds):
        seed = args.seed0 + 7919 * i
        t = time.perf_counter()
        run, runner, state, peak = harness.execute(
            bench, args.workload, seed, args.seconds, False, "cuda:0", t)
        line = {"workload": args.workload, "seed": seed,
                "checks": {n: v for n, v, _ in runner.check(run, state)},
                "e2e": run.e2e, "setup_s": run.setup_s, "peak": peak}
        if i < args.control:
            line["control"] = runner.control_reading(run, state)
        line["wall_s"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del run, runner, state
        harness.free_device_memory()
    return 0


if __name__ == "__main__":
    sys.exit(main())
