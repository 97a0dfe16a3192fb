"""A 2-D 5-point finite-difference Laplacian as CSR arrays.

Row ``i·ny + j`` of an ``nx × ny`` grid holds the stencil's center at
column ``i·ny + j`` and a neighbour at each of the (up to four) grid
neighbours, columns in ascending order.  The stencil is fixed by the
configuration; the seed draws only the vectors it multiplies.
"""
from __future__ import annotations

import numpy as np


def make_csr(config: dict):
    """``(values float32, columns int32, row_ptr int64, shape)`` of the
    configuration's grid, built vectorised on the host."""
    nx, ny = int(config["nx"]), int(config["ny"])
    n = nx * ny
    r = np.arange(n, dtype=np.int64)
    i, j = r // ny, r % ny
    offsets = np.array([-ny, -1, 0, 1, ny], dtype=np.int64)
    keep = np.stack([i > 0, j > 0, np.ones(n, bool), j < ny - 1,
                     i < nx - 1], axis=1)
    coef = np.where(offsets == 0, config["stencil"]["center"],
                    config["stencil"]["neighbour"]).astype(np.float32)
    columns = (r[:, None] + offsets[None, :])[keep].astype(np.int32)
    values = np.broadcast_to(coef, (n, 5))[keep]
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(keep.sum(axis=1), out=row_ptr[1:])
    if "rows" in config and (n != config["rows"]
                             or len(values) != config["nnz"]):
        raise ValueError(f"{config['name']}: built {n} rows and "
                         f"{len(values)} nonzeros, the configuration states "
                         f"{config['rows']} and {config['nnz']}")
    return values, columns, row_ptr, (n, n)
