"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs it once, and assembles its result.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by name:

- ``configs/<config>.json``: the configuration (its ``maker`` names the
  file in ``makers/`` that builds its inputs);
- ``traffic/<traffic>.json``: the mix (its ``runner`` names the file in
  ``runners/`` that runs it);
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``,
  which returns a number or ``None`` when it finds nothing to read.

A runner module has ``setup(run)``, ``window(run, state)``,
``release(run, state)``, ``check(run, state)`` and, for ``calibrate.py``,
``control_reading(run, state)``; it measures the cell's end-to-end metrics
on the host's clock itself and leaves in ``run.host`` what its readers
need.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent
# imports that must never reach the process that prints a result, compared
# by whole top-level name: the JAX package and JAX itself
FOREIGN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """One run of one cell: what the runner and the readers share."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    started: float                       # perf_counter at process start
    window_t0: Optional[float] = None    # perf_counter at the window's start
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    host: Dict[str, Any] = dataclasses.field(default_factory=dict)
    slice: Any = None                    # trace.Slice of a --trace 1 run
    maker: Any = None                    # the configuration's maker module
    # (phase, perf_counter at its end) of set-up, for the log
    phases: List[Tuple[str, float]] = dataclasses.field(default_factory=list)

    def mark(self, phase: str) -> None:
        self.phases.append((phase, time.perf_counter()))
    # a stand-in for the program's timed call (the control, a fault)
    substitute: Optional[Callable] = None

    @property
    def setup_s(self) -> float:
        return self.window_t0 - self.started


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark by its file (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(BENCH_DIR.parent)}")
    spec = importlib.util.spec_from_file_location(
        "perfbench._found." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` and the files it names under ``bench_dir``."""

    def __init__(self, root: Path, bench_dir: Path = BENCH_DIR):
        self.root, self.dir = Path(root), Path(bench_dir)
        self.index = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for c in self.index["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       f"{[c['name'] for c in self.index['workloads']]}")

    def metrics(self, cell: str, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
        return [m for m in self.index[kind]
                if "workloads" not in m or cell in m["workloads"]]

    def config(self, name: str) -> dict:
        return load_json(self.dir / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.dir / "traffic" / f"{name}.json")

    def runner(self, traffic: dict):
        return load_module(self.dir / "runners" / f"{traffic['runner']}.py",
                           "runner." + traffic["runner"])

    def maker(self, config: dict):
        return load_module(self.dir / "makers" / f"{config['maker']}.py",
                           "maker." + config["maker"])

    def reader(self, metric: str):
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           "metric." + metric)


def foreign_modules() -> List[str]:
    """Top-level names of loaded modules that no run may load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FOREIGN))


def free_device_memory() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def execute(bench: Bench, cell_name: str, seed: int, seconds: float,
            trace: bool, device, started: float, *,
            config_override: Optional[dict] = None,
            traffic_override: Optional[dict] = None,
            substitute: Optional[Callable] = None):
    """Set-up, the measured window, the peak memory read, the foreign
    imports checked, the program's state released.  Returns ``(run,
    runner, state, peak bytes)``, ready for ``runner.check``.  The
    overrides replace keys of the configuration or the mix (the tests'
    small sizes); ``substitute`` stands in for the program's timed call."""
    import torch
    cell = bench.cell(cell_name)
    config = {**bench.config(cell["config"]), **(config_override or {})}
    traffic = {**bench.traffic(cell["traffic"]), **(traffic_override or {})}
    run = Run(cell=cell, config=config, traffic=traffic, seed=int(seed),
              seconds=float(seconds), trace=bool(trace),
              device=torch.device(device), started=started,
              substitute=substitute, maker=bench.maker(config))
    runner = bench.runner(traffic)
    state = runner.setup(run)
    runner.window(run, state)
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(run.device)
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    found = foreign_modules()
    if found:
        raise ForeignImport(found)
    runner.release(run, state)
    free_device_memory()
    return run, runner, state, peak


def run_cell(bench: Bench, cell_name: str, seed: int, seconds: float,
             trace: bool, device, started: float, **kw) -> Tuple[dict, list]:
    """Run cell ``cell_name`` once (:func:`execute`), compare with the
    reference, and assemble the result.  Returns ``(result, checks)``;
    ``checks`` holds ``(name, value, limit)``, each passing when ``value
    <= limit``."""
    import torch
    run, runner, state, peak = execute(bench, cell_name, seed, seconds,
                                       trace, device, started, **kw)
    checks = runner.check(run, state)
    correct = all(v <= lim for _, v, lim in checks)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(cell_name, kind):
        if trace:
            value = bench.reader(m["name"]).read(run)
        elif m["name"] == "setup_s":
            value = run.setup_s
        else:
            value = run.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    cuda = run.device.type == "cuda"
    device_info = {"platform": "gpu" if cuda else run.device.type,
                   "kind": (torch.cuda.get_device_name(run.device) if cuda
                            else "cpu"),
                   "count": int(run.cell.get("chips", 1)),
                   "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics,
              "device": device_info}
    if trace and run.slice is not None:
        device_info["busy_s"] = run.slice.busy_s
        device_info["window_s"] = run.slice.window_s
        result["breakdown"] = run.slice.breakdown()
    result["phases"] = {name: t - run.started for name, t in run.phases}
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    return result, checks


class ForeignImport(RuntimeError):
    def __init__(self, names):
        super().__init__("the run loaded " + ", ".join(names)
                         + ", which no run of the port may load")
        self.names = names


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, linear between the closest ranks."""
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def now() -> float:
    return time.perf_counter()
