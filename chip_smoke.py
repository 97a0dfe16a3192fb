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
   differ only in summation order and one final rounding) — K1 and K2 also
   with the split of long groups forced at small piece sizes.  K1/K2 skip
   padding (value 0 at column 0), which the plain versions sum as 0·x[0]:
   with the finite x used here the two agree;
4. the main path: ``spmv``/``spmm`` on both RgCSR matrices with the default
   ``impl`` (and K3 for the Hybrid comparison format), held against a
   float64 scipy product within 1e-4, with the launch counters set to 0
   just before and read just after, and the plan cache showing one miss
   per matrix and hits after;
5. times (``core/timing.py``: one pair of CUDA events around many
   back-to-back launches, over their count; median of repeats after
   warmup) of each kernel, its plain version and one PyTorch sparse call
   computing the same function (CSR with int64 and with int32 indices;
   ``library_ms`` is the faster) — the card's time with the host's enqueue
   hidden behind a spin kernel (``ms``), the same after an L2 flush before
   each call (``cold_ms``), and what a caller of the launcher waits per
   call in a loop (``wait_ms``); whole calls of the main path with what
   their caller waits, their card time and their host time; all
   beside the least time the card could take (bytes over 3.35 TB/s, flops
   over 67 TFLOP/s fp32): ``bound_ms`` for what the kernel must read — for
   K1/K2 the slot rows of live segments that the plan's ``seg_slots``
   counts, for K3 the plan's stored slots — plus x, y and the plan's
   metadata, and ``nnz_bound_ms`` for the matrix's nonzeros alone;
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
                 x_tile=None, key=None, piece_rows=None):
        plan = dataclasses.replace(plan, values2d=plan.values2d.to(dtype))
        xp = xv.to(dtype)
        want, scale = (rgcsr_spmv_plain(
            v, plan.columns2d, plan.step_group, xs, n_groups=plan.n_groups,
            chunks_per_step=plan.chunks_per_step).float()
            for v, xs in ((plan.values2d, xp),
                          (plan.values2d.float().abs(), xp.float().abs())))
        if x_tile is None:
            got = rgcsr_spmv_launch(plan, xp, piece_rows=piece_rows)
        else:   # the reference's x column tile; K1 reads x whole
            got = ops.rgcsr_spmv(plan, xp, x_tile=x_tile)
            want = want.reshape(-1)[: plan.n_rows]
            scale = scale.reshape(-1)[: plan.n_rows]
        hold("rgcsr_spmv", label, got, want, scale, tol, key)

    def k2_check(label, plan, xv, dtype=torch.float32, tol=FP32_TOL,
                 key=None, piece_rows=None):
        plan = dataclasses.replace(plan, values2d=plan.values2d.to(dtype))
        vals = plan.values2d
        xv = xv.to(dtype)
        got = rgcsr_spmm_launch(plan, xv, piece_rows=piece_rows)
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

    t1 = time.perf_counter()
    fem_plan = ops.make_plan(fem)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    raj_plan = ops.make_plan(raj)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for p in (fem_plan, raj_plan):   # the work lists of the main path
        p.work_list("rgcsr_spmv", n_sm=n_sm, part_bytes=p.group_size * 4)
        p.work_list("rgcsr_spmm", n_sm=n_sm,
                    part_bytes=p.group_size * D_SPMM * 4)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    raj_adapt = ops.make_plan(raj, ordering="adaptive", spill_threshold=64)
    log(f"host build: block plans with seg_slots fem2d_2048 {t2 - t1:.3f} s, "
        f"raj1_full {t3 - t2:.3f} s; K1+K2 work lists of both "
        f"{t4 - t3:.3f} s ({n_sm} SMs)")
    for name, p in (("fem2d_2048", fem_plan), ("raj1_full", raj_plan)):
        for kernel, part in (("rgcsr_spmv", 4), ("rgcsr_spmm", 4 * D_SPMM)):
            w = p.work_list(kernel, n_sm=n_sm,
                            part_bytes=p.group_size * part)
            what = ("units" if kernel == "rgcsr_spmv" else
                    f"pieces ({w.n_direct} of one-piece groups), d{D_SPMM}")
            log(f"  {name} {kernel}: piece_rows {w.piece_rows}, "
                f"{w.items.shape[0]} {what}, "
                f"{w.combine.shape[0]} split groups, {w.n_parts} partial "
                f"rows; live slot rows "
                f"{int(p.seg_slots.sum())} x 32 of {p.stored_slots} x "
                f"{p.group_size} stored")
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
    # the split forced at small pieces (fem2d's groups are one step deep,
    # so there every piece size keeps the direct path)
    for p in (8, 64):
        k1_check(f"fem2d_2048 block cps1 pieces{p} fp32", fem_plan,
                 x["fem2d_2048"], piece_rows=p)
        k1_check(f"raj1_full block cps1 pieces{p} fp32", raj_plan,
                 x["raj1_full"], piece_rows=p)
        k1_check(f"raj1_full block cps1 pieces{p} bf16", raj_plan,
                 x["raj1_full"], torch.bfloat16, BF16_TOL, piece_rows=p)
        k1_check(f"raj1_full adaptive spill64 pieces{p} fp32", raj_adapt,
                 x["raj1_full"], piece_rows=p)
        k2_check(f"fem2d_2048 block cps1 pieces{p} d{D_SPMM} fp32",
                 fem_plan, xm["fem2d_2048"], piece_rows=p)
        k2_check(f"raj1_full block cps1 pieces{p} d{D_SPMM} fp32", raj_plan,
                 xm["raj1_full"], piece_rows=p)
        k2_check(f"raj1_full block cps1 pieces{p} d{D_SPMM} bf16", raj_plan,
                 xm["raj1_full"], torch.bfloat16, BF16_TOL, piece_rows=p)
        k2_check(f"raj1_full adaptive spill64 pieces{p} d{D_SPMM} fp32",
                 raj_adapt, xm["raj1_full"], piece_rows=p)
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

    def sparse_csr(a, index_dtype=np.int64):
        return torch.sparse_csr_tensor(
            torch.from_numpy(a.indptr.astype(index_dtype)),
            torch.from_numpy(a.indices.astype(index_dtype)),
            torch.from_numpy(a.data), size=a.shape).to(dev)

    def ms(fn, calls, **kw):
        """Per call: the time a caller waits (no keyword), the card's time
        with the host hidden (``hold=True``), or from HBM after an L2 flush
        (``cold=True``) — see ``core/timing.py``."""
        return time_us(fn, calls=calls, device=dev, **kw) / 1e3

    def bound(nbytes, flops):
        tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
        return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"

    def library_times(a, operand, calls):
        """The PyTorch CSR product on ``a`` with int64 and int32 indices:
        card time warm and cold, per index type."""
        out = {}
        for tag, dt in (("int64", np.int64), ("int32", np.int32)):
            a_t = sparse_csr(a, dt)
            try:
                out[tag] = (ms(lambda: a_t @ operand, calls, hold=True),
                            ms(lambda: a_t @ operand, calls, cold=True))
            except RuntimeError as err:     # a yardstick only
                log(f"library {tag} indices: {err}")
            del a_t
        return out

    def entry(kernel, shape, run, plain, library, nbytes, flops, nnz_bytes,
              nnz_flops, calls=50):
        """``nbytes``/``flops``: what the kernel must read and compute;
        ``nnz_bytes``/``nnz_flops``: the matrix's nonzeros alone;
        ``library``: times of the PyTorch CSR call by index type.  ``ms``
        and ``library_ms`` are card times with the host hidden (inputs warm
        in L2 where they fit), ``cold_ms`` and ``library_cold_ms`` the same
        after an L2 flush, ``wait_ms`` what a caller of the launcher waits
        per call in a loop."""
        b_ms, b_by = bound(nbytes, flops)
        torch.cuda.reset_peak_memory_stats()
        e = {"name": f"{kernel}@{shape}", "route": "cuda",
             "source": KERNEL_META[kernel][0],
             "replaces": KERNEL_META[kernel][1],
             "launches": launches[shape][kernel],
             "max_abs_err": errs[(kernel, shape)],
             "ms": ms(run, calls, hold=True),
             "cold_ms": ms(run, calls, cold=True),
             "wait_ms": ms(run, calls),
             "plain_ms": ms(plain, 2, hold=True),
             "bound_ms": b_ms, "bound_by": b_by,
             "nnz_bound_ms": bound(nnz_bytes, nnz_flops)[0],
             "library_ms": min(v[0] for v in library.values()),
             "library_cold_ms": min(v[1] for v in library.values()),
             **{f"library_{k}_ms": v[0] for k, v in library.items()}}
        e["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"time {e['name']}: kernel {e['ms']:.4f} ms (cold "
            f"{e['cold_ms']:.4f}, caller waits {e['wait_ms']:.4f}), plain "
            f"{e['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), nnz "
            f"bound {e['nnz_bound_ms']:.4f} ms, library "
            + ", ".join(f"{k} {v[0]:.4f} ms (cold {v[1]:.4f})"
                        for k, v in library.items())
            + f", peak {e['peak_gib']:.2f} GiB")
        entries.append(e)

    def live_slots(plan):
        """Slots of the live segments (what K1 and K2 must read) and slots
        that are not padding (the products the result needs)."""
        live = int(plan.seg_slots.sum()) * 32
        real = int(((plan.values2d != 0) | (plan.columns2d != 0)).sum())
        return live, real

    def metadata_bytes(plan, part_bytes, kernel):
        """The work list K1 (units) or K2 (tiles) reads, its combine list
        and the segment counts the combine reads."""
        w = plan.work_list(kernel, n_sm=n_sm, part_bytes=part_bytes)
        return plan.seg_slots.nbytes + w.items.nbytes + w.combine.nbytes

    for name, (m, a) in mats.items():
        plan = fem_plan if name == "fem2d_2048" else raj_plan
        vals, cols, sg = plan.values2d, plan.columns2d, plan.step_group
        cps = plan.chunks_per_step
        live, real = live_slots(plan)
        g_rows = plan.n_groups * plan.group_size
        xv, xmv = x[name], xm[name]
        nnz_bytes = a.nnz * 8                     # fp32 value + int32 column
        entry("rgcsr_spmv", name,
              lambda: rgcsr_spmv_launch(plan, xv),
              lambda: rgcsr_spmv_plain(vals, cols, sg, xv,
                                       n_groups=plan.n_groups,
                                       chunks_per_step=cps),
              library_times(a, xv, 50),
              live * 8 + xv.nbytes + g_rows * 4
              + metadata_bytes(plan, plan.group_size * 4, "rgcsr_spmv"),
              2 * live, nnz_bytes + xv.nbytes + a.shape[0] * 4, 2 * a.nnz)
        entry("rgcsr_spmm", name,
              lambda: rgcsr_spmm_launch(plan, xmv),
              lambda: rgcsr_spmm_plain(vals, cols, sg, xmv,
                                       n_groups=plan.n_groups,
                                       chunks_per_step=cps),
              library_times(a, xmv, 10),
              live * 8 + xmv.nbytes + g_rows * D_SPMM * 4
              + metadata_bytes(plan, plan.group_size * D_SPMM * 4,
                               "rgcsr_spmm"),
              2 * real * D_SPMM,
              nnz_bytes + xmv.nbytes + a.shape[0] * D_SPMM * 4,
              2 * a.nnz * D_SPMM, calls=10)
        ep = ell_plans[name]
        head = a if name == "fem2d_2048" else ell_head_csr(a, raj_hyb.k1)
        entry("ell_spmv", name,
              lambda: ell_spmv_launch(ep.values2d, ep.columns2d, xv),
              lambda: ell_spmv_plain(ep.values2d, ep.columns2d, xv),
              library_times(head, xv, 50),
              ep.values2d.nbytes + ep.columns2d.nbytes + xv.nbytes
              + ep.values2d.shape[1] * 4,
              2 * ep.values2d.numel(),
              head.nnz * 8 + xv.nbytes + a.shape[0] * 4, 2 * head.nnz)
    def host_ms(fn, calls):
        """Host time per call to enqueue ``calls`` back-to-back calls."""
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        t = (time.perf_counter() - t) * 1e3 / calls
        torch.cuda.synchronize()
        return t

    # whole calls as a user makes them (plan-cache lookup and the adaptive
    # epilogue included): what a caller waits per call in a loop, the card's
    # time with the host hidden, and the host's time to enqueue each; and
    # Raj1's adaptive plan with spill — the remedy for its pathology, not
    # on the default path
    def call_line(what, fn, calls):
        log(f"call {what}: caller waits {ms(fn, calls):.4f} ms, card "
            f"{ms(fn, calls, hold=True):.4f} ms, host "
            f"{host_ms(fn, calls):.4f} ms per call")

    for name, (m, _) in mats.items():
        call_line(f"spmv {name}", lambda: spmv(m, x[name]), 50)
        call_line(f"spmm d{D_SPMM} {name}", lambda: spmm(m, xm[name]), 10)
    p, xr, xmr = raj_adapt, x["raj1_full"], xm["raj1_full"]
    epilogue_bytes = sum(t.nbytes for t in (
        p.gather_idx, p.grouped_mask, p.spill_values, p.spill_rows,
        p.spill_columns))
    b_ms = bound(live_slots(p)[0] * 8
                 + metadata_bytes(p, p.group_size * 4, "rgcsr_spmv")
                 + epilogue_bytes + xr.nbytes
                 + p.n_groups * p.group_size * 4 + p.n_rows * 4, 0)[0]
    fn = lambda: rgcsr_spmv_launch(p, xr)   # noqa: E731
    log(f"time rgcsr_spmv@raj1_full adaptive spill64: kernel "
        f"{ms(fn, 50, hold=True):.4f} ms (cold {ms(fn, 50, cold=True):.4f}"
        f"), bound of the whole call {b_ms:.4f} ms")
    call_line("rgcsr_spmv raj1_full adaptive spill64",
              lambda: ops.rgcsr_spmv(p, xr), 50)
    fn = lambda: rgcsr_spmm_launch(p, xmr)   # noqa: E731
    log(f"time rgcsr_spmm@raj1_full adaptive spill64 d{D_SPMM}: kernel "
        f"{ms(fn, 20, hold=True):.4f} ms")
    call_line(f"rgcsr_spmm raj1_full adaptive spill64 d{D_SPMM}",
              lambda: ops.rgcsr_spmm(p, xmr), 20)
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
