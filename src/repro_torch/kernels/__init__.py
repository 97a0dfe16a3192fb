"""Hand-written CUDA kernels for the paper's compute hot spot (SpMV/SpMM).

Layout: ``csrc/*.cu`` hold the kernels (built for ``sm_90a`` by
``_build.py``); ``rgcsr_spmv.py`` / ``rgcsr_spmm.py`` / ``ell_spmv.py`` hold
each kernel's launcher, plain PyTorch version and launch counter; ``ops.py``
is the public API (plans, the process-wide ``PlanCache`` + wrappers);
``ref.py`` the oracles.  :func:`launch_counts` reports how many times each
CUDA kernel was launched since :func:`reset_launch_counts`.
"""
from repro_torch.kernels import _build
from repro_torch.kernels.ops import (  # noqa: F401
    PLAN_CACHE,
    EllPlan,
    PlanCache,
    RgCSRPlan,
    ell_spmv,
    get_plan,
    make_ell_plan,
    make_plan,
    plan_from_numpy,
    rgcsr_spmm,
    rgcsr_spmv,
)


def launch_counts() -> dict:
    """CUDA launches per kernel (``rgcsr_spmv``, ``rgcsr_spmm``,
    ``ell_spmv``) since the last reset; plain-version runs do not count."""
    return dict(_build.launches)


def reset_launch_counts() -> None:
    for name in _build.launches:
        _build.launches[name] = 0
