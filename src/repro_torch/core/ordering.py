"""Row orderings (paper §4.4.2, Table 7).

The paper evaluates three orderings of the row index:

* ``without``    — natural order.
* ``descending`` — rows sorted by decreasing nonzero count.  Optimal for
  suppressing RgCSR artificial zeros (rows in a group have similar lengths)
  but may shuffle the nonzero pattern (worse x-locality).
* ``amd``        — approximate minimum degree.  We substitute **RCM**
  (reverse Cuthill–McKee, via scipy) — the same role in the experiment: a
  bandwidth/profile-reducing symmetric permutation that improves x-reuse at
  the cost of more artificial zeros than descending.  The substitution is
  recorded in DESIGN.md §9 and labeled in every benchmark table.

All orderings are host-side (numpy/scipy) — format construction time, exactly
as in the paper.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "descending_ordering",
    "descending_from_lengths",
    "split_spill_rows",
    "rcm_ordering",
    "random_ordering",
    "permute_rows",
    "permute_symmetric",
    "ORDERINGS",
]


def descending_ordering(dense: np.ndarray) -> np.ndarray:
    """Permutation sorting rows by decreasing nonzero count (stable)."""
    row_lens = (np.asarray(dense) != 0).sum(axis=1)
    return np.argsort(-row_lens, kind="stable")


def descending_from_lengths(row_lens: np.ndarray) -> np.ndarray:
    """Descending-length permutation straight from a row-length vector.

    The adaptive RgCSR planner (kernels/ops.make_plan, ordering='adaptive')
    already holds exact per-row nonzero counts, so it permutes without
    touching the dense matrix.  Stable: equal-length rows keep their
    original relative order, which keeps the permutation deterministic and
    x-locality as good as descending allows.
    """
    return np.argsort(-np.asarray(row_lens), kind="stable")


def split_spill_rows(row_lens: np.ndarray, threshold: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(grouped_rows, spilled_rows) split at ``threshold`` nonzeros.

    Rows longer than ``threshold`` are pathological for any grouped padded
    format (one long row inflates its whole group's slot count, paper
    Table 6); the adaptive planner routes them to a COO tail instead
    (Bell–Garland Hybrid spill).  ``threshold <= 0`` disables spilling.
    """
    row_lens = np.asarray(row_lens)
    if threshold <= 0:
        return np.arange(len(row_lens)), np.empty(0, dtype=np.int64)
    spilled = np.nonzero(row_lens > threshold)[0]
    grouped = np.nonzero(row_lens <= threshold)[0]
    return grouped, spilled


def rcm_ordering(dense: np.ndarray) -> np.ndarray:
    """Reverse Cuthill–McKee on the symmetrized pattern (AMD stand-in)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    a = sp.csr_matrix(np.asarray(dense) != 0)
    sym = ((a + a.T) > 0).astype(np.int8)
    perm = reverse_cuthill_mckee(sym.tocsr(), symmetric_mode=True)
    return np.asarray(perm, dtype=np.int64)


def random_ordering(dense: np.ndarray, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.permutation(np.asarray(dense).shape[0])


def permute_rows(dense: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Row permutation P·A.  SpMV result comes back permuted: y' = P·(A x)."""
    return np.asarray(dense)[perm]


def permute_symmetric(dense: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Symmetric permutation P·A·Pᵀ (AMD/RCM style); x must be permuted too."""
    d = np.asarray(dense)
    return d[np.ix_(perm, perm)]


ORDERINGS = {
    "without": lambda d: np.arange(np.asarray(d).shape[0]),
    "descending": descending_ordering,
    "rcm": rcm_ordering,
}
