"""Synthetic sparse-matrix corpus emulating the paper's 1,596-matrix sets.

The paper draws from the UF collection + NEP collection [12, 13] and splits
into "small" (< 10,000 rows) and "large" (>= 10,000) sets (Table 2).  Offline
we generate structurally equivalent families:

* ``stencil``      — multi-diagonal FD/FEM stencils (3/5/9/27-point): the
                     well-structured case where every format does well.
* ``fem2d``        — 2-D 5-point Laplacian on an nx×ny grid (fd18-like).
* ``powerlaw``     — Zipf row degrees (graph-mining-like; moderate variance).
* ``uniform``      — iid Bernoulli sparsity.
* ``circuit``      — near-diagonal + a few (almost) dense rows:
                     IBM_EDA/trans4- and Rajat/Raj1-like, the RgCSR
                     pathological case (row-length variance → huge fill).
* ``blockrand``    — random bs×bs dense blocks (favours BlockedCSR).
* ``banded``       — random band matrices.

Every generator is deterministic given its seed.  ``paper_twins()`` returns
synthetic stand-ins whose (rows, nnz/row max/mean/min) match the paper's
Table 6 characterization to within sampling noise, scaled down by
``scale`` for CPU runtime.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np

__all__ = ["MatrixSpec", "generate", "corpus", "small_corpus", "paper_twins"]


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    name: str
    family: str
    n: int
    seed: int
    params: Tuple[Tuple[str, float], ...] = ()

    def build(self) -> np.ndarray:
        return generate(self.family, self.n, seed=self.seed,
                        **dict(self.params))


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _stencil(n: int, seed: int, points: int = 5) -> np.ndarray:
    """Multi-diagonal stencil matrix (paper §1: the 'simple' structured case)."""
    offsets = {
        3: [-1, 0, 1],
        5: [-int(np.sqrt(n)), -1, 0, 1, int(np.sqrt(n))],
        9: [-int(np.sqrt(n)) - 1, -int(np.sqrt(n)), -int(np.sqrt(n)) + 1,
            -1, 0, 1,
            int(np.sqrt(n)) - 1, int(np.sqrt(n)), int(np.sqrt(n)) + 1],
        27: list(range(-13, 14)),
    }[int(points)]
    rng = _rng(seed)
    a = np.zeros((n, n), dtype=np.float32)
    for off in offsets:
        diag = rng.uniform(0.5, 1.5, size=n - abs(off)).astype(np.float32)
        if off >= 0:
            a[np.arange(n - off), np.arange(off, n)] = diag
        else:
            a[np.arange(-off, n), np.arange(n + off)] = diag
    return a


def _fem2d(n: int, seed: int) -> np.ndarray:
    """5-point Laplacian on a grid with ~n unknowns (fd18/G2_circuit-like)."""
    nx = max(2, int(np.sqrt(n)))
    ny = max(2, n // nx)
    m = nx * ny
    a = np.zeros((m, m), dtype=np.float32)
    idx = lambda i, j: i * ny + j
    for i in range(nx):
        for j in range(ny):
            r = idx(i, j)
            a[r, r] = 4.0
            if i > 0:
                a[r, idx(i - 1, j)] = -1.0
            if i < nx - 1:
                a[r, idx(i + 1, j)] = -1.0
            if j > 0:
                a[r, idx(i, j - 1)] = -1.0
            if j < ny - 1:
                a[r, idx(i, j + 1)] = -1.0
    return a


def _powerlaw(n: int, seed: int, avg_deg: float = 8.0, alpha: float = 1.5) -> np.ndarray:
    rng = _rng(seed)
    raw = rng.zipf(alpha, size=n).astype(np.float64)
    deg = np.minimum(np.maximum((raw / raw.mean()) * avg_deg, 1), n - 1).astype(int)
    a = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        cols = rng.choice(n, size=deg[i], replace=False)
        a[i, cols] = rng.uniform(0.1, 1.0, size=deg[i]).astype(np.float32)
        a[i, i] = 1.0
    return a


def _uniform(n: int, seed: int, density: float = 0.01) -> np.ndarray:
    rng = _rng(seed)
    a = (rng.uniform(size=(n, n)) < density).astype(np.float32)
    a *= rng.uniform(0.1, 1.0, size=(n, n)).astype(np.float32)
    np.fill_diagonal(a, 1.0)
    return a


def _circuit(n: int, seed: int, n_dense_rows: int = 3,
             dense_frac: float = 0.6, base_deg: int = 5) -> np.ndarray:
    """Near-diagonal + a few nearly dense rows: the trans4/Raj1 pathology
    (paper §4.4.2) — max row nnz ≫ mean row nnz."""
    rng = _rng(seed)
    a = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        k = max(1, int(rng.poisson(base_deg)))
        lo = max(0, i - 3 * base_deg)
        hi = min(n, i + 3 * base_deg)
        cols = rng.choice(np.arange(lo, hi), size=min(k, hi - lo), replace=False)
        a[i, cols] = rng.uniform(0.1, 1.0, size=len(cols)).astype(np.float32)
        a[i, i] = 1.0
    dense_rows = rng.choice(n, size=n_dense_rows, replace=False)
    for r in dense_rows:
        cols = rng.choice(n, size=int(dense_frac * n), replace=False)
        a[r, cols] = rng.uniform(0.1, 1.0, size=len(cols)).astype(np.float32)
    return a


def _blockrand(n: int, seed: int, bs: int = 4, block_density: float = 0.02) -> np.ndarray:
    rng = _rng(seed)
    nb = max(1, n // bs)
    mask = rng.uniform(size=(nb, nb)) < block_density
    np.fill_diagonal(mask, True)
    a = np.zeros((nb * bs, nb * bs), dtype=np.float32)
    bi, bj = np.nonzero(mask)
    for r, c in zip(bi, bj):
        a[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] = (
            rng.uniform(0.1, 1.0, size=(bs, bs)).astype(np.float32))
    return a[:n, :n]


def _banded(n: int, seed: int, bandwidth: int = 16, density: float = 0.4) -> np.ndarray:
    rng = _rng(seed)
    a = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo, hi = max(0, i - bandwidth), min(n, i + bandwidth + 1)
        mask = rng.uniform(size=hi - lo) < density
        vals = rng.uniform(0.1, 1.0, size=hi - lo).astype(np.float32) * mask
        a[i, lo:hi] = vals
        a[i, i] = 1.0
    return a


_FAMILIES: Dict[str, Callable[..., np.ndarray]] = {
    "stencil": _stencil,
    "fem2d": _fem2d,
    "powerlaw": _powerlaw,
    "uniform": _uniform,
    "circuit": _circuit,
    "blockrand": _blockrand,
    "banded": _banded,
}


def generate(family: str, n: int, seed: int = 0, **params) -> np.ndarray:
    try:
        fn = _FAMILIES[family]
    except KeyError:
        raise ValueError(f"unknown family {family!r}; options: {sorted(_FAMILIES)}")
    return fn(n, seed=seed, **params)


def corpus(small_n: Tuple[int, ...] = (64, 256, 512, 1024, 2048),
           large_n: Tuple[int, ...] = (4096, 8192),
           seeds: Tuple[int, ...] = (0, 1)) -> List[MatrixSpec]:
    """The benchmark corpus.  Structured like the paper's complete set: a mix
    of families across a size range, split small/large at the (scaled-down)
    boundary.  ~120 specs by default; scale with ``seeds``/sizes for more.

    Note: the paper's boundary is 10,000 rows on a 141 GB/s GPU; we scale
    sizes down ~one order of magnitude for single-core-CPU runtime and keep
    the small:large ratio (≈2:1, Table 2)."""
    specs: List[MatrixSpec] = []
    fam_params: Dict[str, Tuple[Tuple[str, float], ...]] = {
        "stencil": (("points", 5),),
        "fem2d": (),
        "powerlaw": (("avg_deg", 8.0),),
        "uniform": (("density", 0.01),),
        "circuit": (("n_dense_rows", 3),),
        "blockrand": (("bs", 4),),
        "banded": (("bandwidth", 16),),
    }
    for fam, params in fam_params.items():
        for n in list(small_n) + list(large_n):
            for seed in seeds:
                specs.append(MatrixSpec(
                    name=f"{fam}_n{n}_s{seed}", family=fam, n=n, seed=seed,
                    params=params))
    # extra stencil widths (the paper's multi-diagonal matrices)
    for points in (3, 9, 27):
        for n in (256, 1024, 4096):
            specs.append(MatrixSpec(name=f"stencil{points}_n{n}", family="stencil",
                                    n=n, seed=7, params=(("points", points),)))
    return specs


def small_corpus() -> List[MatrixSpec]:
    """Fast corpus for tests/CI."""
    return corpus(small_n=(64, 256), large_n=(1024,), seeds=(0,))


def paper_twins(scale: int = 16) -> Dict[str, np.ndarray]:
    """Synthetic twins of the paper's Table 6 matrices, scaled down by
    ``scale``.  The structural signature (max/mean/min nnz per row) is what
    drives the paper's conclusions, and it is preserved:

    =================  ========  =====  =====  ===  =========================
    matrix             rows      max    mean   min  character
    =================  ========  =====  =====  ===  =========================
    Hohn/fd18          16,248    6      3.86   1    FD mesh, low variance
    AMD/G2_circuit     150,102   6      4.84   2    circuit mesh, low variance
    IBM_EDA/trans4     116,835   114k   6.6    1    few dense rows (max≈rows)
    Rajat/Raj1         263,743   40k    4.94   1    few dense rows
    =================  ========  =====  =====  ===  =========================
    """
    return {
        "fd18_twin": _fem2d(16248 // scale, seed=18),
        "g2_circuit_twin": _stencil(150102 // scale, seed=2, points=5),
        "trans4_twin": _circuit(116835 // scale, seed=4, n_dense_rows=2,
                                dense_frac=0.95, base_deg=5),
        "raj1_twin": _circuit(263743 // scale, seed=1, n_dense_rows=4,
                              dense_frac=0.15, base_deg=4),
    }
