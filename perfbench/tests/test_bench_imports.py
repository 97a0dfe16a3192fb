"""What the benchmark imports: never JAX or the JAX package, and in its
plain references nothing of the program either."""
import ast
import subprocess
import sys

import pytest

from conftest import ROOT

FOREIGN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    """Top-level names of every module ``path`` imports (whole names:
    ``repro_torch`` is not ``repro``)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted((ROOT / "perfbench").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not _imports(path) & FOREIGN


@pytest.mark.parametrize("path", sorted(
    (ROOT / "perfbench" / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & ({"repro_torch", "perfbench"} | FOREIGN)


def test_whole_names_are_compared():
    assert "repro_torch".split(".")[0] not in FOREIGN


def test_port_and_harness_load_no_jax():
    """In a fresh process: the harness, its runners and the port's modules
    it reaches load no foreign module."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from perfbench import harness\n"
        "b = harness.Bench(harness.BENCH_DIR.parent)\n"
        "import repro_torch.core, repro_torch.serve, repro_torch.kernels\n"
        "for c in b.index['workloads']:\n"
        "    b.runner(b.traffic(c['traffic'])); b.maker(b.config(c['config']))\n"
        "print(harness.foreign_modules())\n" % (str(ROOT / "src"), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
