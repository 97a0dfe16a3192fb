"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number compared with its limit); the last lines
of standard error repeat the checks.  With ``--trace 0`` the metrics are
the cell's end-to-end ones, with ``--trace 1`` its per-layer ones.

It needs the CUDA cards the cell asks for and prints no result without
them; it never falls back to the CPU.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; few host threads."""
    cache = ROOT / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    os.environ["USE_FLAX"] = "0"
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def fail(msg: str, code: int = 2) -> "NoReturn":  # noqa: F821
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "BENCHMARK.json").is_file():
        fail(f"no BENCHMARK.json in {ROOT}: run from a checkout's root")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch under {ROOT}: the program under test is "
             f"missing")
    _environment()
    from perfbench import harness
    bench = harness.Bench(ROOT)
    try:
        cell = bench.cell(args.workload)
    except KeyError as err:
        fail(str(err.args[0]))
    import torch
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available():
        fail("no CUDA card: this benchmark measures the port on the card "
             "and does not fall back to the CPU")
    if torch.cuda.device_count() < chips:
        fail(f"{args.workload} needs {chips} CUDA cards, "
             f"{torch.cuda.device_count()} found")
    torch.set_num_threads(4)
    try:
        result, checks = harness.run_cell(
            bench, args.workload, args.seed, args.seconds, bool(args.trace),
            "cuda:0", STARTED)
    except harness.ForeignImport as err:
        fail(str(err))
    found = harness.foreign_modules()
    if found:
        fail(str(harness.ForeignImport(found)))
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r}) "
              f"{'ok' if value <= limit else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
