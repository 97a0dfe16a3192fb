"""The port's formats against the reference's, array for array.

``repro_torch.core.formats`` builds every format from CSR arrays with no
per-row loop; on the reference's small corpus every array, the fill ratio
and the byte accounting must equal ``repro.core.formats.from_dense``.
"""
import ast
import dataclasses
import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same_fields, numpy_fields, rand_sparse

import repro.core.analyze as ref_analyze
import repro.core.formats as ref_formats
import repro.core.ordering as ref_ordering
import repro.core.suite as ref_suite
import repro.sharding.partitioner as ref_partitioner
import repro_torch.core.analyze as analyze
import repro_torch.core.ordering as ordering
import repro_torch.core.suite as suite
import repro_torch.sharding.partitioner as partitioner
from repro_torch.core import FORMATS, from_csr, from_dense, from_numpy
from repro_torch.core.formats import _csr_arrays
from repro_torch.core.timing import time_us

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SPECS = [s for s in ref_suite.small_corpus() if s.n <= 1024]


@functools.lru_cache(maxsize=None)
def _dense(name):
    return next(s for s in SPECS if s.name == name).build()


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("name", [s.name for s in SPECS])
def test_from_dense_matches_reference(name, fmt):
    a = _dense(name)
    ref = ref_formats.from_dense(a, fmt)
    port = from_dense(a, fmt, device="cpu")
    assert_same_fields(ref, port)
    assert port.nnz == ref.nnz
    assert port.stored_elements == ref.stored_elements
    assert port.storage_bytes() == ref.storage_bytes()
    if fmt == "rgcsr":
        assert port.fill_ratio() == ref.fill_ratio()
    np.testing.assert_array_equal(port.to_dense(), ref.to_dense())


@pytest.mark.parametrize("fmt,kw", [
    ("rgcsr", dict(group_size=32, slot_pad=4)),
    ("sliced_ellpack", dict(group_size=16, slot_pad=1)),
    ("hybrid", dict(k1=2)),
    ("blocked_csr", dict(block_size=3)),
])
def test_format_options_match_reference(fmt, kw):
    a = rand_sparse(3, 90, 70, 0.1)
    assert_same_fields(ref_formats.from_dense(a, fmt, **kw),
                       from_dense(a, fmt, device="cpu", **kw))


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_from_csr_sorts_columns_within_rows(fmt):
    """CSR input with columns shuffled inside each row builds the same
    format as the dense matrix."""
    a = rand_sparse(4, 150, 97, 0.12)
    values, cols, rows, row_ptr = _csr_arrays(a)
    rng = np.random.default_rng(5)
    order = np.lexsort((rng.uniform(size=len(rows)), rows))
    port = from_csr(values[order], cols[order], row_ptr, a.shape, fmt,
                    device="cpu")
    assert_same_fields(ref_formats.from_dense(a, fmt), port)


@pytest.mark.parametrize("shape", [(0, 40), (5, 7), (1, 1)])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_degenerate_matrices_match_reference(fmt, shape):
    a = np.zeros(shape, np.float32)
    if shape[0]:
        a[-1, -1] = 2.0
    assert_same_fields(ref_formats.from_dense(a, fmt),
                       from_dense(a, fmt, device="cpu"))


def test_stored_zero_survives_to_csr_arrays():
    """A true element equal to 0.0 keeps its slot: extraction is positional,
    and ``from_csr`` keeps explicit entries, so the round trip through
    ``to_csr_arrays`` reproduces the grouped storage exactly."""
    a = rand_sparse(6, 200, 150, 0.05)
    fields = numpy_fields(ref_formats.from_dense(a, "rgcsr"))
    flat0 = int(np.flatnonzero(fields["values"])[3])
    fields["values"][flat0] = 0.0
    ref = dataclasses.replace(
        ref_formats.from_dense(a, "rgcsr"),
        values=jnp.asarray(fields["values"]))
    port = from_numpy("rgcsr", fields, device="cpu")
    for r, p in zip(ref.to_csr_arrays(), port.to_csr_arrays()):
        np.testing.assert_array_equal(np.asarray(r), p)
    v, c, ptr = port.to_csr_arrays()
    assert len(v) == ref.nnz and (v == 0).sum() == 1
    rebuilt = from_csr(v, c, ptr, a.shape, "rgcsr", device="cpu")
    assert_same_fields(ref, rebuilt)


def test_from_csr_rejects_malformed_input():
    with pytest.raises(ValueError):
        from_csr(np.ones(3), np.array([0, 1, 5]), np.array([0, 2, 3]), (2, 4),
                 device="cpu")
    with pytest.raises(ValueError):
        from_csr(np.ones(3), np.array([0, 1, 2]), np.array([0, 2]), (2, 4),
                 device="cpu")
    with pytest.raises(ValueError):
        from_dense(np.zeros((2, 2), np.float32), "dia", device="cpu")


def test_default_device_raises_without_a_card(monkeypatch):
    """Entry points default to the card and never quietly fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = rand_sparse(7, 20, 20, 0.2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        from_dense(a)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        from_csr(*(_csr_arrays(a)[i] for i in (0, 1, 3)), a.shape, "ellpack")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        from_numpy("coo", numpy_fields(ref_formats.from_dense(a, "coo")))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        time_us(lambda: None)
    with pytest.raises(ValueError, match="times CUDA work"):
        time_us(lambda: None, device="cpu")


def test_copied_modules_match_reference():
    for family in ("stencil", "fem2d", "powerlaw", "uniform", "circuit",
                   "blockrand", "banded"):
        np.testing.assert_array_equal(suite.generate(family, 64, seed=3),
                                      ref_suite.generate(family, 64, seed=3))
    assert [s.name for s in suite.small_corpus()] == \
        [s.name for s in ref_suite.small_corpus()]
    a = rand_sparse(8, 60, 60, 0.1)
    for name in ("without", "descending", "rcm"):
        np.testing.assert_array_equal(ordering.ORDERINGS[name](a),
                                      ref_ordering.ORDERINGS[name](a))
    lens = (a != 0).sum(axis=1)
    for got, want in zip(ordering.split_spill_rows(lens, 7),
                         ref_ordering.split_spill_rows(lens, 7)):
        np.testing.assert_array_equal(got, want)
    for fmt in ("csr", "ellpack", "rgcsr"):
        assert analyze.format_report(from_dense(a, fmt, device="cpu")) == \
            ref_analyze.format_report(ref_formats.from_dense(a, fmt))
    assert analyze.row_stats(a) == ref_analyze.row_stats(a)
    assert analyze.H100_SXM.mem_bandwidth_gbs == 3350.0
    assert analyze.H100_SXM.x_cache_bytes == 50 * 2 ** 20
    for name in ("TRAIN_RULES", "SERVE_RULES"):
        assert dataclasses.asdict(getattr(partitioner, name)) == \
            dataclasses.asdict(getattr(ref_partitioner, name))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    files.extend(sorted((REPO / "scripts").glob("torch_*.py")))
    twins = sorted((REPO / "examples").glob("torch_*.py"))
    assert [f.name for f in twins] == [
        "torch_quickstart.py", "torch_serve_lm.py", "torch_spmv_suite.py",
        "torch_train_lm.py"]
    files.extend(twins)
    # what the spawned ranks and the card's tests import
    files.extend(REPO / "tests" / f for f in (
        "_torch_dist.py", "_torch_parity.py", "test_torch_gpu.py"))
    assert len(files) > 10
    scanned = {str(f.relative_to(REPO)) for f in files}
    for module in ("obs/metrics.py", "obs/trace.py", "train/fault.py",
                   "serve/paging.py", "serve/device_loop.py",
                   "serve/engine.py", "serve/router.py", "launch/serve.py",
                   "obs/export.py", "train/checkpoint.py",
                   "kernels/autotune.py", "train/data.py",
                   "train/optimizer.py", "train/trainer.py",
                   "launch/steps.py", "launch/train.py", "models/moe.py",
                   "models/recurrent.py", "sharding/__init__.py",
                   "sharding/partitioner.py", "launch/mesh.py",
                   "models/shardlib.py", "sharding/layout.py",
                   "configs/__init__.py", "launch/dryrun.py",
                   "launch/hlo_cost.py", "launch/hlo_stats.py",
                   "launch/roofline.py", "launch/hillclimb.py",
                   "launch/report.py"):
        assert f"src/repro_torch/{module}" in scanned, module
    for path in files:
        bad = {r for r in _imported_roots(path)
               if r in ("jax", "jaxlib", "repro", "benchmarks")}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
