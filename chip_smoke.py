#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. print the card (``nvidia-smi``) and build the three CUDA kernels from
   ``src/repro_torch/kernels/csrc/`` — one ``nvcc`` per source, all at once;
2. build two matrices at their published sizes from CSR arrays:
   ``fem2d_2048`` (2-D 5-point Laplacian on a 2048×2048 grid: 4,194,304
   rows, 20,963,328 nonzeros) and ``raj1_full`` (the Raj1 twin of
   ``suite.paper_twins`` at scale 1: 263,743 rows, 4 rows at 15 % density);
3. hold each kernel against its plain PyTorch version on the card, on the
   same inputs: fp32 within 1e-5, bf16 within 3e-2 (both sum in fp32; they
   differ only in summation order and one final rounding);
4. the main path: ``spmv``/``spmm`` on both RgCSR matrices with the default
   ``impl`` (and K3 for the Hybrid comparison format), held against a
   float64 scipy product within 1e-4, with the launch counters set to 0
   just before and read just after, and the plan cache showing one miss
   per matrix and hits after;
5. times (one pair of CUDA events around many back-to-back launches, over
   their count; median of repeats after warmup) of each kernel, its plain
   version and one PyTorch sparse call computing the same function, beside
   the least time the card could take (bytes over 3.35 TB/s, flops over
   67 TFLOP/s fp32): ``bound_ms`` for the plan's stored slots, as the kernel
   reads them, and ``nnz_bound_ms`` for the matrix's nonzeros alone;
6. a ``{"kernels": [...]}`` line, the card's name and power limit, and as
   the last line ``{"ok": true, "device": {...}}``.

Every tolerance ``tol`` above is applied per output element as
``|got - want| <= tol · (1 + Σ_j |a_ij · x_j|)``: the rounding error of a
sum grows with the size of its terms, not with the size of the result, and
Raj1's dense rows sum 39,567 terms whose total cancels to a fraction of
their size.  Where no cancellation happens this is rtol = atol = tol.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
DEVICE = "cuda"
SEED = 0
D_SPMM = 64
FP32_TOL, BF16_TOL, MAIN_TOL = 1e-5, 3e-2, 1e-4

KERNEL_META = {
    "rgcsr_spmv": ("src/repro_torch/kernels/csrc/rgcsr_spmv.cu",
                   "src/repro/kernels/rgcsr_spmv.py:82"),
    "rgcsr_spmm": ("src/repro_torch/kernels/csrc/rgcsr_spmm.cu",
                   "src/repro/kernels/rgcsr_spmm.py:44"),
    "ell_spmv": ("src/repro_torch/kernels/csrc/ell_spmv.cu",
                 "src/repro/kernels/ell_spmv.py:25"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi: " + out.stderr.strip())


# ------------------------------------------------------------------ matrices


def fem2d_csr(nx: int, ny: int):
    """5-point Laplacian on an nx×ny grid (``suite._fem2d``'s recipe)."""
    import scipy.sparse as sp
    n = nx * ny
    r = np.arange(n, dtype=np.int64)
    i, j = r // ny, r % ny
    parts = [(r, r, np.full(n, 4.0, np.float32))]
    for ok, off in ((i > 0, -ny), (i < nx - 1, ny), (j > 0, -1),
                    (j < ny - 1, 1)):
        parts.append((r[ok], r[ok] + off, np.full(ok.sum(), -1.0, np.float32)))
    rows, cols, vals = (np.concatenate(p) for p in zip(*parts))
    a = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    a.sort_indices()
    return a


def raj1_csr(n: int = 263743, seed: int = 1, n_dense_rows: int = 4,
             dense_frac: float = 0.15, base_deg: int = 4):
    """Near-diagonal rows plus a few 15 %-dense rows (``suite._circuit``'s
    recipe with the ``raj1_twin`` parameters, drawn vectorised)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    i = np.arange(n, dtype=np.int64)
    lo = np.maximum(0, i - 3 * base_deg)
    width = np.minimum(n, i + 3 * base_deg) - lo
    k = np.minimum(np.maximum(1, rng.poisson(base_deg, n)), width)
    w = 6 * base_deg
    keys = rng.random((n, w))
    keys[np.arange(w)[None, :] >= width[:, None]] = 2.0   # outside the window
    pick = np.argsort(keys, axis=1)[np.arange(w)[None, :] < k[:, None]]
    rows = np.repeat(i, k)
    cols = lo[rows] + pick
    vals = rng.uniform(0.1, 1.0, len(rows)).astype(np.float32)
    off_diag = cols != rows
    rows = np.concatenate([rows[off_diag], i])
    cols = np.concatenate([cols[off_diag], i])
    vals = np.concatenate([vals[off_diag], np.ones(n, np.float32)])
    for r in rng.choice(n, size=n_dense_rows, replace=False):
        dc = rng.choice(n, size=int(dense_frac * n), replace=False)
        keep = ~((rows == r) & np.isin(cols, dc))
        rows = np.concatenate([rows[keep], np.full(len(dc), r)])
        cols = np.concatenate([cols[keep], dc])
        vals = np.concatenate([vals[keep], rng.uniform(0.1, 1.0, len(dc))
                               .astype(np.float32)])
    a = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    a.sort_indices()
    return a


def ell_head_csr(a, k1: int):
    """The first ``k1`` entries of every row (the ELL part of Hybrid)."""
    import scipy.sparse as sp
    lens = np.diff(a.indptr)
    slot = np.arange(a.nnz) - np.repeat(a.indptr[:-1], lens)
    keep = slot < k1
    ptr = np.concatenate([[0], np.cumsum(np.minimum(lens, k1))])
    return sp.csr_matrix((a.data[keep], a.indices[keep], ptr), shape=a.shape)


# --------------------------------------------------------------------- main


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found beside this script)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.core import COO, ELLPACK, from_csr, spmm, spmv
    from repro_torch.core.timing import time_us
    from repro_torch.kernels import (PLAN_CACHE, _build, launch_counts, ops,
                                     reset_launch_counts)
    from repro_torch.kernels.ell_spmv import ell_spmv_launch, ell_spmv_plain
    from repro_torch.kernels.rgcsr_spmm import (rgcsr_spmm_launch,
                                                rgcsr_spmm_plain)
    from repro_torch.kernels.rgcsr_spmv import (rgcsr_spmv_launch,
                                                rgcsr_spmv_plain)

    dev = torch.device(DEVICE)
    failures = []

    # ---- 1. card and build
    smi = card_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build_logs = _build.build(force=True)
    log(f"build: {len(build_logs)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ---- 2. matrices
    t0 = time.perf_counter()
    fem_csr = fem2d_csr(2048, 2048)
    raj_csr = raj1_csr()
    cut_csr = fem2d_csr(32, 2048)
    log(f"csr: fem2d_2048 {fem_csr.shape[0]} rows {fem_csr.nnz} nnz; "
        f"raj1_full {raj_csr.shape[0]} rows {raj_csr.nnz} nnz, max row "
        f"{np.diff(raj_csr.indptr).max()}; built in "
        f"{time.perf_counter() - t0:.1f} s")

    def build(a, fmt, **kw):
        return from_csr(a.data, a.indices, a.indptr, a.shape, fmt,
                        device=dev, **kw)

    t0 = time.perf_counter()
    fem = build(fem_csr, "rgcsr")
    raj = build(raj_csr, "rgcsr")
    cut = build(cut_csr, "rgcsr")
    fem_ell = build(fem_csr, "ellpack")
    raj_hyb = build(raj_csr, "hybrid")
    torch.cuda.synchronize()
    log(f"formats on the card in {time.perf_counter() - t0:.1f} s: "
        f"fem2d rgcsr {fem.stored_elements} slots, ellpack "
        f"{tuple(fem_ell.values.shape)}; raj1 rgcsr {raj.stored_elements} "
        f"slots, hybrid k1={raj_hyb.k1} + {raj_hyb.coo_values.shape[0]} coo")

    rng = np.random.default_rng(SEED)
    x_np = {"fem2d_2048": rng.standard_normal(fem_csr.shape[1])
            .astype(np.float32),
            "raj1_full": rng.standard_normal(raj_csr.shape[1])
            .astype(np.float32)}
    xm_np = {k: rng.standard_normal((len(v), D_SPMM)).astype(np.float32)
             for k, v in x_np.items()}
    x = {k: torch.from_numpy(v).to(dev) for k, v in x_np.items()}
    xm = {k: torch.from_numpy(v).to(dev) for k, v in xm_np.items()}
    raj_ell = ELLPACK(values=raj_hyb.ell_values, columns=raj_hyb.ell_columns,
                      shape=raj_hyb.shape)
    raj_coo = COO(values=raj_hyb.coo_values, rows=raj_hyb.coo_rows,
                  columns=raj_hyb.coo_columns, shape=raj_hyb.shape)

    # ---- 3. each kernel against its plain version, on the card
    t0 = time.perf_counter()

    errs = {}     # (kernel, matrix) -> max_abs_err at the main path's shapes

    def hold(kernel, label, got, want, scale, tol, key=None):
        """``scale``: Σ_j |a_ij · x_j| per output element."""
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        ok = bool((diff <= tol * (1 + scale)).all())
        if key:
            errs[(kernel, key)] = err
        log(f"check {kernel} {label}: max_abs_err {err:.3e} tol {tol:g} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{kernel} {label}")

    def k1_check(label, plan, xv, dtype=torch.float32, tol=FP32_TOL,
                 x_tile=None, key=None):
        plan = dataclasses.replace(plan, values2d=plan.values2d.to(dtype))
        xp = xv.to(dtype)
        want, scale = (rgcsr_spmv_plain(
            v, plan.columns2d, plan.step_group, xs, n_groups=plan.n_groups,
            chunks_per_step=plan.chunks_per_step).float()
            for v, xs in ((plan.values2d, xp),
                          (plan.values2d.float().abs(), xp.float().abs())))
        if x_tile is None:
            got = rgcsr_spmv_launch(plan.values2d, plan.columns2d,
                                    plan.step_group, plan.group_step_ptr, xp,
                                    chunks_per_step=plan.chunks_per_step)
        else:   # the reference's x column tile; K1 reads x whole
            got = ops.rgcsr_spmv(plan, xp, x_tile=x_tile)
            want = want.reshape(-1)[: plan.n_rows]
            scale = scale.reshape(-1)[: plan.n_rows]
        hold("rgcsr_spmv", label, got, want, scale, tol, key)

    def k2_check(label, plan, xv, dtype=torch.float32, tol=FP32_TOL,
                 key=None):
        vals = plan.values2d.to(dtype)
        xv = xv.to(dtype)
        got = rgcsr_spmm_launch(vals, plan.columns2d, plan.step_group,
                                plan.group_step_ptr, xv,
                                chunks_per_step=plan.chunks_per_step)
        want, scale = (rgcsr_spmm_plain(
            v, plan.columns2d, plan.step_group, xs, n_groups=plan.n_groups,
            chunks_per_step=plan.chunks_per_step).float()
            for v, xs in ((vals, xv), (vals.float().abs(), xv.float().abs())))
        hold("rgcsr_spmm", label, got, want, scale, tol, key)

    def k3_check(label, plan, xv, dtype=torch.float32, tol=FP32_TOL,
                 key=None):
        vals = plan.values2d.to(dtype)
        xp = xv.to(dtype)
        got = ell_spmv_launch(vals, plan.columns2d, xp)
        want = ell_spmv_plain(vals, plan.columns2d, xp)
        scale = ell_spmv_plain(vals.float().abs(), plan.columns2d,
                               xp.float().abs())
        hold("ell_spmv", label, got, want, scale, tol, key)

    fem_plan = ops.make_plan(fem)
    raj_plan = ops.make_plan(raj)
    raj_adapt = ops.make_plan(raj, ordering="adaptive", spill_threshold=64)
    fem_ell_plan = ops.make_ell_plan(fem_ell)
    raj_ell_plan = ops.make_ell_plan(raj_ell)
    x_cut = torch.from_numpy(rng.standard_normal(cut_csr.shape[1])
                             .astype(np.float32)).to(dev)

    k1_check("fem2d_2048 block cps1 fp32", fem_plan, x["fem2d_2048"],
             key="fem2d_2048")
    k1_check("fem2d_2048 block cps1 bf16", fem_plan, x["fem2d_2048"],
             torch.bfloat16, BF16_TOL)
    k1_check("raj1_full block cps1 fp32", raj_plan, x["raj1_full"],
             key="raj1_full")
    k1_check("raj1_full adaptive spill64 fp32", raj_adapt, x["raj1_full"])
    for cps in (2, 4, 8):
        k1_check(f"fem2d_cut65536 block cps{cps} fp32",
                 ops.make_plan(cut, chunks_per_step=cps), x_cut)
    k1_check("fem2d_cut65536 block cps1 x_tile1024 fp32",
             ops.make_plan(cut), x_cut, x_tile=1024)
    k3_check("fem2d_2048 ellpack fp32", fem_ell_plan, x["fem2d_2048"],
             key="fem2d_2048")
    k3_check("fem2d_2048 ellpack bf16", fem_ell_plan, x["fem2d_2048"],
             torch.bfloat16, BF16_TOL)
    k3_check("raj1_full hybrid-ell fp32", raj_ell_plan, x["raj1_full"],
             key="raj1_full")
    k2_check(f"fem2d_2048 block cps1 d{D_SPMM} fp32", fem_plan,
             xm["fem2d_2048"], key="fem2d_2048")
    k2_check(f"fem2d_2048 block cps1 d{D_SPMM} bf16", fem_plan,
             xm["fem2d_2048"], torch.bfloat16, BF16_TOL)
    k2_check(f"raj1_full block cps1 d{D_SPMM} fp32", raj_plan,
             xm["raj1_full"], key="raj1_full")
    k2_check(f"raj1_full adaptive spill64 d{D_SPMM} fp32", raj_adapt,
             xm["raj1_full"])
    log(f"phase 3 in {time.perf_counter() - t0:.1f} s")

    # ---- 4. the main path
    t0 = time.perf_counter()
    PLAN_CACHE.clear()
    torch.cuda.reset_peak_memory_stats()
    ell_plans = {"fem2d_2048": fem_ell_plan, "raj1_full": raj_ell_plan}
    mats = {"fem2d_2048": (fem, fem_csr), "raj1_full": (raj, raj_csr)}
    launches = {}
    reset_launch_counts()
    for name, (m, a) in mats.items():
        before = launch_counts()
        y = spmv(m, x[name])
        y_again = spmv(m, x[name])
        ym = spmm(m, xm[name])
        y_hyb = ops.ell_spmv(ell_plans[name], x[name])
        if name == "raj1_full":
            y_hyb = y_hyb + spmv(raj_coo, x[name])
        torch.cuda.synchronize()
        after = launch_counts()
        launches[name] = {k: after[k] - before[k] for k in after}
        a64, abs64 = a.astype(np.float64), abs(a.astype(np.float64))
        x64, xm64 = x_np[name].astype(np.float64), xm_np[name].astype(
            np.float64)
        ref, scale = a64 @ x64, abs64 @ abs(x64)
        refm, scalem = a64 @ xm64, abs64 @ abs(xm64)
        for what, got, want, sc in (("spmv", y, ref, scale),
                                    ("spmm", ym, refm, scalem),
                                    ("hybrid spmv", y_hyb, ref, scale)):
            got = got.double().cpu().numpy()
            ok = got.shape == want.shape and bool(np.all(
                np.abs(got - want) <= MAIN_TOL * (1 + sc)))
            err = float(np.abs(got - want).max())
            log(f"main {name} {what}: shape {got.shape} max_abs_err vs "
                f"float64 scipy {err:.3e} (tol {MAIN_TOL:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"main {name} {what}")
        if not torch.equal(y, y_again):
            failures.append(f"main {name}: K1 not deterministic")
        log(f"main {name} launches {launches[name]}; K1 repeat bitwise "
            f"equal: {torch.equal(y, y_again)}")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    stats = PLAN_CACHE.stats()
    log(f"main path launch counts {counts}; plan cache {stats}; "
        f"peak memory {peak / 2**30:.2f} GiB; {time.perf_counter() - t0:.1f} s")
    if counts != {"rgcsr_spmv": 4, "rgcsr_spmm": 2, "ell_spmv": 2}:
        failures.append(f"main path launch counts {counts}")
    if stats["misses"] != 2 or stats["hits"] != 4:
        failures.append(f"plan cache {stats}: want 2 misses then 4 hits")

    # ---- 5. times at the main path's shapes
    t0 = time.perf_counter()
    entries = []

    warnings.filterwarnings("ignore", message="Sparse")   # beta notices

    def sparse_csr(a):
        return torch.sparse_csr_tensor(
            torch.from_numpy(a.indptr.astype(np.int64)),
            torch.from_numpy(a.indices.astype(np.int64)),
            torch.from_numpy(a.data), size=a.shape).to(dev)

    def ms(fn, calls):
        return time_us(fn, calls=calls, device=dev) / 1e3

    def bound(nbytes, flops):
        tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
        return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"

    def entry(kernel, shape, run, plain, library, nbytes, flops, nnz_bytes,
              nnz_flops, calls=20):
        """``nbytes``/``flops``: the plan's stored slots, as the kernel reads
        them; ``nnz_bytes``/``nnz_flops``: the matrix's nonzeros alone."""
        b_ms, b_by = bound(nbytes, flops)
        torch.cuda.reset_peak_memory_stats()
        e = {"name": f"{kernel}@{shape}", "route": "cuda",
             "source": KERNEL_META[kernel][0],
             "replaces": KERNEL_META[kernel][1],
             "launches": launches[shape][kernel],
             "max_abs_err": errs[(kernel, shape)],
             "ms": ms(run, calls), "plain_ms": ms(plain, 2),
             "bound_ms": b_ms, "bound_by": b_by,
             "nnz_bound_ms": bound(nnz_bytes, nnz_flops)[0],
             "library_ms": ms(library, calls)}
        e["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"time {e['name']}: kernel {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), nnz "
            f"bound {e['nnz_bound_ms']:.4f} ms, library "
            f"{e['library_ms']:.4f} ms, peak {e['peak_gib']:.2f} GiB")
        entries.append(e)

    for name, (m, a) in mats.items():
        plan = fem_plan if name == "fem2d_2048" else raj_plan
        vals, cols = plan.values2d, plan.columns2d
        sg, ptr = plan.step_group, plan.group_step_ptr
        cps = plan.chunks_per_step
        slots = vals.numel()
        plan_bytes = vals.nbytes + cols.nbytes + ptr.nbytes
        xv, xmv = x[name], xm[name]
        nnz_bytes = a.nnz * 8                     # fp32 value + int32 column
        slow = name == "raj1_full"                # block plan: long groups
        a_t = sparse_csr(a)
        entry("rgcsr_spmv", name,
              lambda: rgcsr_spmv_launch(vals, cols, sg, ptr, xv,
                                        chunks_per_step=cps),
              lambda: rgcsr_spmv_plain(vals, cols, sg, xv,
                                       n_groups=plan.n_groups,
                                       chunks_per_step=cps),
              lambda: a_t @ xv,
              plan_bytes + xv.nbytes + plan.n_groups * plan.group_size * 4,
              2 * slots, nnz_bytes + xv.nbytes + a.shape[0] * 4, 2 * a.nnz,
              calls=5 if slow else 50)
        entry("rgcsr_spmm", name,
              lambda: rgcsr_spmm_launch(vals, cols, sg, ptr, xmv,
                                        chunks_per_step=cps),
              lambda: rgcsr_spmm_plain(vals, cols, sg, xmv,
                                       n_groups=plan.n_groups,
                                       chunks_per_step=cps),
              lambda: a_t @ xmv,
              plan_bytes + xmv.nbytes
              + plan.n_groups * plan.group_size * D_SPMM * 4,
              2 * slots * D_SPMM,
              nnz_bytes + xmv.nbytes + a.shape[0] * D_SPMM * 4,
              2 * a.nnz * D_SPMM, calls=2 if slow else 10)
        ep = ell_plans[name]
        head = a if name == "fem2d_2048" else ell_head_csr(a, raj_hyb.k1)
        head_t = a_t if name == "fem2d_2048" else sparse_csr(head)
        entry("ell_spmv", name,
              lambda: ell_spmv_launch(ep.values2d, ep.columns2d, xv),
              lambda: ell_spmv_plain(ep.values2d, ep.columns2d, xv),
              lambda: head_t @ xv,
              ep.values2d.nbytes + ep.columns2d.nbytes + xv.nbytes
              + ep.values2d.shape[1] * 4,
              2 * ep.values2d.numel(),
              head.nnz * 8 + xv.nbytes + a.shape[0] * 4, 2 * head.nnz,
              calls=50)
        del a_t, head_t
    # whole calls as a user makes them (x padding, plan-cache lookup and the
    # adaptive epilogue included), and Raj1's adaptive plan with spill — the
    # remedy for its pathology, not on the default path
    for name, (m, _) in mats.items():
        slow = name == "raj1_full"
        log(f"call spmv {name}: "
            f"{ms(lambda: spmv(m, x[name]), 5 if slow else 50):.4f} ms; "
            f"spmm d{D_SPMM}: "
            f"{ms(lambda: spmm(m, xm[name]), 2 if slow else 10):.4f} ms")
    p, xr, xmr = raj_adapt, x["raj1_full"], xm["raj1_full"]
    arrays = (p.values2d, p.columns2d, p.step_group, p.group_step_ptr)
    epilogue_bytes = sum(t.nbytes for t in (
        p.gather_idx, p.grouped_mask, p.spill_values, p.spill_rows,
        p.spill_columns))
    k_ms = ms(lambda: rgcsr_spmv_launch(*arrays, xr), 50)
    call_ms = ms(lambda: ops.rgcsr_spmv(p, xr), 50)
    b_ms = bound(p.values2d.nbytes + p.columns2d.nbytes + epilogue_bytes
                 + xr.nbytes + p.n_groups * p.group_size * 4 + p.n_rows * 4,
                 0)[0]
    log(f"time rgcsr_spmv@raj1_full adaptive spill64: kernel {k_ms:.4f} ms, "
        f"whole call {call_ms:.4f} ms, bound of the whole call {b_ms:.4f} ms")
    k_ms = ms(lambda: rgcsr_spmm_launch(*arrays, xmr), 20)
    call_ms = ms(lambda: ops.rgcsr_spmm(p, xmr), 20)
    log(f"time rgcsr_spmm@raj1_full adaptive spill64 d{D_SPMM}: kernel "
        f"{k_ms:.4f} ms, whole call {call_ms:.4f} ms")
    log(f"phase 5 in {time.perf_counter() - t0:.1f} s")

    for kernel in KERNEL_META:
        if counts[kernel] <= 0:
            failures.append(f"{kernel} was not launched on the main path")
    if failures:
        for f in failures:
            print(f"chip_smoke: FAIL: {f}", file=sys.stderr)
        return 1
    log(json.dumps({"kernels": entries}))
    log(f"card: {card_line()}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
