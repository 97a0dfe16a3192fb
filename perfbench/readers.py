"""What the per-layer metrics' readers share: rooflines and idle shares
from a traced slice, model-operation utilisation from the window.

A reader returns ``None`` where it finds nothing to read (no slice, no
kernel of its names in it, no work of its kind), and the harness then
leaves the metric out; a share is never given as 0 for want of a reading.
"""
from __future__ import annotations

from typing import Optional, Sequence

from perfbench import counts

# the profiler names of the port's RgCSR kernels: K1, K2, and the combine
# that sums a split group's partial rows for either
K1 = ("rgcsr_spmv_kernel", "combine_partials")
K2 = ("rgcsr_spmm_kernel", "combine_partials")


def idle_percent(run) -> Optional[float]:
    sl = run.slice
    if sl is None or sl.window_s <= 0 or not sl.gpu:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)


def roofline_percent(bound_s: float, run, names: Sequence[str],
                     graph_only: bool = False) -> Optional[float]:
    """``bound_s`` over the traced seconds of the kernels ``names``."""
    sl = run.slice
    if sl is None or bound_s <= 0:
        return None
    t = sl.kernel_seconds(names, graph_only)
    return 100.0 * bound_s / t if t > 0 else None


def product_roofline(run, names: Sequence[str]) -> Optional[float]:
    """A sparse product's bound, counted from the CSR's nonzeros, times
    the products in the slice, over its kernels' traced seconds."""
    n = run.host.get("traced_products", 0)
    if run.slice is None or not n:
        return None
    cfg = run.config
    d = int(run.traffic["vectors"])
    one = counts.product_bound_seconds(cfg["nnz"], cfg["rows"], cfg["rows"],
                                       d, cfg["precision"])
    return roofline_percent(n * one, run, names)


def mfu_percent(run) -> Optional[float]:
    """Model operations of the window's tokens over the window at the
    serving dtype's peak."""
    flops = run.host.get("model_flops")
    if not flops or run.window_s <= 0:
        return None
    peak = counts.PEAK_FLOPS_PER_S[run.host["serving_dtype"]]
    return 100.0 * flops / (run.window_s * peak)


def decode_w_out_roofline(run) -> Optional[float]:
    """The down-projections' bound at the slots' width, one product a
    layer for each decode step in the traced slice, over the traced
    seconds of the K2 kernels a CUDA graph launched."""
    steps = run.host.get("traced_decode_steps", 0)
    if not steps:
        return None
    cfg = run.config
    one = counts.w_out_bound_seconds(cfg, run.host["slots"],
                                     run.host["serving_dtype"])
    return roofline_percent(steps * cfg["num_hidden_layers"] * one, run, K2,
                            graph_only=True)
