"""The paper's own experiment on the PyTorch port, miniaturized: run CSR,
Hybrid and RgCSR over a corpus slice and print the Table-5-style
comparison.

On a card the rates come from CUDA events (``core.timing.time_us``):
RgCSR through its CUDA kernel, Hybrid's ELL half through the ELL kernel
plus its COO spill, CSR through the plain segment sum.  ``--device cpu``
times the plain versions on the host's wall clock, and the column says
so.

Run:  PYTHONPATH=src python examples/torch_spmv_suite.py [--full]
      [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import COO, ELLPACK, from_dense, spmv
from repro_torch.core.formats import resolve_device
from repro_torch.core.ordering import descending_ordering, permute_rows
from repro_torch.core.suite import corpus, paper_twins
from repro_torch.core.timing import time_us
from repro_torch.kernels import ops


def hybrid_spmv(mat):
    """``y = A·x`` of a Hybrid matrix: the ELL kernel on its ELL half,
    plus the COO spill."""
    coo = COO(values=mat.coo_values, rows=mat.coo_rows,
              columns=mat.coo_columns, shape=mat.shape)
    if not mat.k1:
        return lambda x: spmv(coo, x)
    plan = ops.make_ell_plan(ELLPACK(values=mat.ell_values,
                                     columns=mat.ell_columns,
                                     shape=mat.shape))
    if not mat.coo_values.shape[0]:
        return lambda x: ops.ell_spmv(plan, x)
    return lambda x: ops.ell_spmv(plan, x) + spmv(coo, x)


def spmv_gflops_measured(fn, nnz, x, dev, repeats=3):
    """``(GFLOP/s, µs per call)`` of ``fn(x)``: CUDA events on a card
    (what a caller waits per call in a loop), the median of ``repeats``
    calls on the host's wall clock on the CPU."""
    if dev.type == "cuda":
        us = time_us(fn, x, repeats=repeats, device=dev)
    else:
        fn(x)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn(x)
            times.append((time.perf_counter() - t0) * 1e6)
        us = float(np.median(times))
    return 2.0 * nnz / (us * 1e-6) / 1e9, us


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    clock = (f"GFLOP/s on {torch.cuda.get_device_name(dev)} (CUDA events)"
             if dev.type == "cuda" else "GFLOP/s, cpu wall")

    specs = corpus(small_n=(256, 1024), large_n=(2048,), seeds=(0,)) \
        if args.full else corpus(small_n=(256,), large_n=(1024,), seeds=(0,))
    print(f"rates: {clock}")
    print(f"{'matrix':24s} {'csr':>8s} {'hybrid':>8s} {'rgcsr':>8s} "
          f"{'rg fill%':>9s}  winner")
    wins = {"csr": 0, "hybrid": 0, "rgcsr": 0}
    for spec in specs:
        dense = spec.build()
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            dense.shape[1]).astype(np.float32)).to(dev)
        row = {}
        for fmt, kw in (("csr", {}), ("hybrid", {}),
                        ("rgcsr", {"group_size": 128})):
            mat = from_dense(dense, fmt, device=dev, **kw)
            fn = hybrid_spmv(mat) if fmt == "hybrid" else \
                (lambda v, mat=mat: spmv(mat, v))
            gf, _ = spmv_gflops_measured(fn, mat.nnz, x, dev, repeats=3)
            row[fmt] = gf
            if fmt == "rgcsr":
                fill = mat.fill_ratio()
        winner = max(row, key=row.get)
        wins[winner] += 1
        print(f"{spec.name:24s} {row['csr']:8.3f} {row['hybrid']:8.3f} "
              f"{row['rgcsr']:8.3f} {fill:8.1f}%  {winner}")

    print("\nwin counts:", wins)
    print("\n=== the pathological twins (paper Table 6) + descending fix ===")
    for name, dense in paper_twins(scale=32).items():
        rg = from_dense(dense, "rgcsr", group_size=128, device=dev)
        rg_desc = from_dense(permute_rows(dense, descending_ordering(dense)),
                             "rgcsr", group_size=128, device=dev)
        print(f"{name:20s} fill {rg.fill_ratio():9.1f}% -> descending "
              f"{rg_desc.fill_ratio():9.1f}%")
    return wins


if __name__ == "__main__":
    main()
