"""Quickstart on the PyTorch port: the paper's format end-to-end.

1. Build a sparse matrix from the synthetic corpus.
2. Store it in every format the paper discusses; compare fill/bytes.
3. Run SpMV through the RgCSR kernel (the hand-written CUDA kernel on a
   card, its plain PyTorch version on ``--device cpu``) and check it
   against the CSR oracle.
4. Reproduce the paper's Table 1 peak model for GTX280 and the H100.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import FORMATS, from_dense, spmv
from repro_torch.core.analyze import GTX280, H100_SXM, format_report, \
    peak_model_gflops
from repro_torch.core.formats import resolve_device
from repro_torch.core.suite import generate
from repro_torch.kernels import get_plan, rgcsr_spmv


def device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("=== 1. build a matrix (2-D FEM Laplacian, 1,024 unknowns) ===")
    dense = generate("fem2d", 1024, seed=0)
    nnz = int((dense != 0).sum())
    print(f"shape={dense.shape} nnz={nnz} "
          f"density={100 * nnz / dense.size:.2f}%")

    print("\n=== 2. every format from the paper ===")
    kw = {"rgcsr": dict(group_size=128), "sliced_ellpack": dict(group_size=128)}
    for name in FORMATS:
        mat = from_dense(dense, name, device=dev, **kw.get(name, {}))
        rep = format_report(mat, H100_SXM)
        print(f"{name:16s} stored={rep['stored_elements']:8d} "
              f"fill={rep['artificial_zeros_pct']:7.1f}% "
              f"bytes={rep['storage_bytes']:9d} "
              f"modeled_gflops(h100)={rep['gflops_cached']:.1f}")

    where = "CUDA kernel" if dev.type == "cuda" else "plain version"
    print(f"\n=== 3. RgCSR SpMV ({where} on {device_name(dev)}) vs "
          f"oracle ===")
    x = np.random.default_rng(0).standard_normal(
        dense.shape[1]).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    rg = from_dense(dense, "rgcsr", group_size=128, device=dev)
    y_kernel = rgcsr_spmv(get_plan(rg), xt).cpu().numpy()
    y_ref = spmv(from_dense(dense, "csr", device=dev), xt).cpu().numpy()
    err = np.abs(y_kernel - y_ref).max()
    print(f"max |kernel - oracle| = {err:.2e}")
    assert err < 1e-4

    print("\n=== 4. paper Table 1: peak SpMV model ===")
    for hw, pair in ((GTX280, (("single", 4), ("double", 8))),
                     (H100_SXM, (("bf16", 2), ("fp32", 4)))):
        for prec, nbytes in pair:
            un = peak_model_gflops(hw, nbytes, False)
            ca = peak_model_gflops(hw, nbytes, True)
            print(f"{hw.name:8s} {prec:6s}: {un:7.1f} GFLOPS uncached, "
                  f"{ca:7.1f} cached")
    print("\nquickstart OK")


if __name__ == "__main__":
    main()
