"""``BENCHMARK.json`` against the files it names, and the harness finding
a new cell, configuration, mix and metric by their files alone."""
import ast
import json
import shutil
import time

import pytest

from conftest import FEM_SMALL, ROOT


def _index():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_names_files_that_exist(bench):
    idx = _index()
    cells = {c["name"] for c in idx["workloads"]}
    for c in idx["workloads"]:
        config = bench.config(c["config"])
        traffic = bench.traffic(c["traffic"])
        assert (bench.dir / "makers" / f"{config['maker']}.py").is_file()
        assert (bench.dir / "runners" / f"{traffic['runner']}.py").is_file()
    for kind in ("end_to_end", "per_layer"):
        for m in idx[kind]:
            assert set(m.get("workloads", cells)) <= cells, m["name"]
    for m in idx["per_layer"]:
        assert hasattr(bench.reader(m["name"]), "read"), m["name"]


def test_every_cell_reports_what_it_must(bench):
    idx = _index()
    e2e = {m["name"] for m in idx["end_to_end"]}
    for c in idx["workloads"]:
        mine = {m["name"] for m in bench.metrics(c["name"], "end_to_end")}
        assert "setup_s" in mine and len(mine) >= 2, c["name"]
        layer = bench.metrics(c["name"], "per_layer")
        assert layer, c["name"]
        for m in layer:
            assert m["moves"] in e2e and m["moves"] in mine, (c["name"],
                                                              m["name"])


def test_configs_files_are_the_ones_named():
    idx = _index()
    for cfg in idx["configs"]:
        path = ROOT / cfg["file"]
        assert path.is_file()
        data = json.loads(path.read_text())
        assert data["name"] == cfg["name"]
        for key in cfg["reduced"]:
            assert key in data


def test_a_new_cell_is_found_by_its_files(tmp_path):
    """A cell added by data alone (a configuration, a mix and a per-layer
    metric, each a new file, and entries in BENCHMARK.json) runs with no
    edit of the harness."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    idx = _index()
    fem = json.loads((ROOT / "perfbench/configs/fem2d_2048.json").read_text())
    fem.update(FEM_SMALL, name="fem2d_small")
    (root / "perfbench/configs/fem2d_small.json").write_text(json.dumps(fem))
    mix = json.loads((ROOT / "perfbench/traffic/spmv.json").read_text())
    mix.update(vectors=3, samples=2)
    (root / "perfbench/traffic/spmm3.json").write_text(json.dumps(mix))
    (root / "perfbench/metrics/window_seconds.py").write_text(
        "def read(run):\n    return run.window_s\n")
    idx["configs"].append({**idx["configs"][0], "name": "fem2d_small",
                           "file": "perfbench/configs/fem2d_small.json"})
    idx["workloads"].append({"name": "fem2d_small.spmm3",
                             "config": "fem2d_small", "traffic": "spmm3",
                             "chips": 1, "why": "a test cell"})
    idx["per_layer"].append({"name": "window_seconds", "unit": "s",
                             "better": "lower", "source": "host_clock",
                             "layer": "device", "moves": "sparse_gflop_s",
                             "workloads": ["fem2d_small.spmm3"]})
    for m in idx["end_to_end"]:
        if m["name"] == "sparse_gflop_s":
            m["workloads"].append("fem2d_small.spmm3")
    (root / "BENCHMARK.json").write_text(json.dumps(idx))
    from perfbench import harness
    bench = harness.Bench(root, root / "perfbench")
    res, checks = harness.run_cell(bench, "fem2d_small.spmm3", 5, 0.3,
                                   False, "cpu", time.perf_counter())
    assert res["correct"] and set(res["metrics"]) == {"sparse_gflop_s",
                                                      "setup_s"}
    res, _ = harness.run_cell(bench, "fem2d_small.spmm3", 6, 0.3, True,
                              "cpu", time.perf_counter())
    assert res["correct"] and "window_seconds" in res["metrics"]


def test_harness_code_names_no_cell():
    """The harness's code holds no cell, configuration or mix name: it
    finds them by the names in BENCHMARK.json."""
    idx = _index()
    names = {c["name"] for c in idx["workloads"]} \
        | {c["name"] for c in idx["configs"]} \
        | {c["traffic"] for c in idx["workloads"]}
    for path in (ROOT / "perfbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        consts = {n.value for n in ast.walk(tree)
                  if isinstance(n, ast.Constant) and isinstance(n.value, str)}
        assert not consts & names, (path, consts & names)


@pytest.mark.parametrize("name", ["k1_roofline", "k2_roofline.decode",
                                  "mfu.decode", "device_idle.sparse"])
def test_reader_finds_nothing_without_a_slice(bench, name):
    class Empty:
        slice = None
        host = {}
        window_s = 0.0
        config = {}
        traffic = {"vectors": 1}
    assert bench.reader(name).read(Empty()) is None


def test_chat_window_opens_after_the_loop_has_started(bench):
    """The closed loop's clients start in set-up: ``open_after`` requests
    have completed before the window opens, and the window counts only
    the tokens delivered inside it."""
    import torch
    from conftest import small
    from perfbench import harness
    cell = bench.cell("gqa2b.chat")
    cfg, tr = small(cell["name"])
    cfg = {**bench.config(cell["config"]), **cfg}
    tr = {**bench.traffic(cell["traffic"]), **tr}
    run = harness.Run(cell=cell, config=cfg, traffic=tr, seed=9,
                      seconds=0.5, trace=False, device=torch.device("cpu"),
                      started=time.perf_counter(), maker=bench.maker(cfg))
    runner = bench.runner(tr)
    st = runner.setup(run)
    runner.window(run, st)
    before = [r for r in st.loop.requests if r.done is not None
              and r.done <= run.window_t0]
    assert len(before) >= tr["open_after"]
    assert not set(map(id, before)) & set(map(id, st.requests))
    assert any(r.at_open for r in st.requests)
    delivered = sum(r.at_close - r.at_open for r in st.requests)
    assert run.e2e["tokens_per_s"] == pytest.approx(delivered
                                                    / run.window_s)
