"""The PyTorch twins of the four examples (``examples/torch_*.py``) on the
CPU, each through its ``main(argv)`` with ``--device cpu``.

The quickstart's and the suite's structural columns (each format's stored
elements, fill % and bytes; RgCSR's fill per corpus matrix; the
pathological twins' fill before and after the descending ordering) equal
what the reference examples print for the same matrices (the reference
suite run with its timer replaced by a constant: its rates are not
structural and the port's are the host's wall clock here).  The serving
twin's requests all end done; the training twin's loss falls (its own
assert) and its sparse run trains ``values2d`` through the segment sum.
"""
import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


def _load(name):
    """The example ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return buf.getvalue(), out


@pytest.fixture(scope="module")
def reference_runs(monkeypatch_module):
    """The reference quickstart's and suite's printed output."""
    monkeypatch_module.syspath_prepend(str(ROOT))
    quick, _ = _run(_load("quickstart").main)
    suite = _load("spmv_suite")
    monkeypatch_module.setattr(suite, "spmv_gflops_measured",
                               lambda mat, x, repeats=5: (1.0, 1.0))
    monkeypatch_module.setattr(sys, "argv", ["spmv_suite.py"])
    table, _ = _run(suite.main)
    return quick, table


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


_FORMAT_ROW = re.compile(r"^(\w+)\s+stored=\s*(\d+) fill=\s*([-\d.]+)% "
                         r"bytes=\s*(\d+) ")
_SUITE_ROW = re.compile(r"^(\S+)\s+[\d.]+\s+[\d.]+\s+[\d.]+\s+([\d.]+)%  ")
_TWIN_ROW = re.compile(r"^(\S+)\s+fill\s+([\d.]+)% -> descending\s+"
                       r"([\d.]+)%")


def _rows(pattern, text):
    return [m.groups() for m in map(pattern.match, text.splitlines()) if m]


def test_quickstart_twin_prints_the_reference_formats(reference_runs):
    text, _ = _run(_load("torch_quickstart").main, ["--device", "cpu"])
    ref, _ = reference_runs
    got, want = _rows(_FORMAT_ROW, text), _rows(_FORMAT_ROW, ref)
    assert len(got) == 7 and got == want
    assert "quickstart OK" in text and "modeled_gflops(h100)" in text
    table1 = [line.split(":")[0].split()[0] for line in text.splitlines()
              if "GFLOPS uncached" in line]
    assert table1 == ["gtx280"] * 2 + ["h100_sxm"] * 2
    assert "tpu" not in text.lower() and "v5e" not in text


def test_spmv_suite_twin_prints_the_reference_structure(reference_runs):
    text, wins = _run(_load("torch_spmv_suite").main, ["--device", "cpu"])
    _, ref = reference_runs
    got, want = _rows(_SUITE_ROW, text), _rows(_SUITE_ROW, ref)
    assert len(got) == 23 and got == want
    twins = _rows(_TWIN_ROW, text)
    assert len(twins) == 4 and twins == _rows(_TWIN_ROW, ref)
    assert "rates: GFLOP/s, cpu wall" in text
    assert sum(wins.values()) == 23 and set(wins) == {"csr", "hybrid",
                                                      "rgcsr"}


def test_serve_twin_finishes_every_request():
    text, done = _run(_load("torch_serve_lm").main, ["--device", "cpu"])
    assert len(done) == 10 and all(r.done for r in done)
    assert all(r.status == "ok" for r in done)
    assert "all done: True" in text and "tok/s on CPU" in text
    assert re.search(r"paging: peak \d+ pages in use", text)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_train_twin_loss_falls(sparse):
    argv = ["--device", "cpu", "--tiny"] + (["--sparse"] if sparse else [])
    text, trainer = _run(_load("torch_train_lm").main, argv)
    first, last = trainer.history[0]["loss"], trainer.history[-1]["loss"]
    assert last < first and len(trainer.history) == 30
    assert f"trained 30 steps: loss {first:.3f} -> {last:.3f}" in text
    assert f"sparse_ffn={sparse}" in text
    w_out = trainer.model.layers[0].ffn.w_out
    assert hasattr(w_out, "values2d") == sparse


def test_twins_refuse_a_missing_card():
    """``--device`` defaults to ``cuda``: without a card each twin raises
    before it computes anything (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for name in ("torch_quickstart", "torch_spmv_suite", "torch_serve_lm",
                 "torch_train_lm"):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            _load(name).main([])
