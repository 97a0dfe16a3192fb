"""Core: the paper's contribution — sparse formats + SpMV/SpMM + analytics."""
from repro_torch.core.formats import (  # noqa: F401
    COO,
    CSR,
    ELLPACK,
    FORMATS,
    BlockedCSR,
    HybridEllCoo,
    RgCSR,
    ShardedRgCSR,
    SlicedEllpack,
    from_csr,
    from_dense,
    from_numpy,
)
from repro_torch.core.spmv import spmv, spmm  # noqa: F401
