#!/usr/bin/env python3
"""Time K3 (``csrc/ell_spmv.cu``) at several launch shapes, and an earlier
tree's K3, on one CUDA card.

Builds ``fem2d_2048``'s ELLPACK plan and ``raj1_full``'s Hybrid ELL plan
with the recipes of ``chip_smoke.py`` and compiles the K3 source once per
variant, its ``kThreads`` (threads a CTA), ``kRows`` (consecutive rows a
thread) and ``kUnroll`` (slots a batch) set to the variant's values, and
where a variant names a fourth number, ``__launch_bounds__``' least CTAs
an SM (which caps the registers a thread), each into its own library under
``build/k3_variants/``.  With ``--old DIR`` (an
earlier tree's ``csrc`` directory) it also builds that tree's K3, whose C
interface is ``(values, columns, x, y, k_pad, n_pad, stream)`` and which
reads every stored slot.  Each variant is held against the plain version
(fp32, within 1e-5 · (1 + Σ|a·x|)) and timed with ``core.timing.time_us``:
the card's time with the host hidden (``ms``), after an L2 flush
(``cold_ms``) and what a caller waits (``wait_ms``), beside the bound of
the live slots (the plan's ``seg_slots``) and of every stored slot (bytes
at 3.35 TB/s).  The variants are timed in two turns, first to last and
back; each time is the mean of the two turns' medians.  Prints one JSON
line per matrix and variant, and exits 1 if any variant disagrees::

    python3 scripts/torch_k3_variants.py --old build/parent/csrc
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "k3_variants"
# (kThreads, kRows, kUnroll[, least CTAs an SM])
VARIANTS = ((128, 4, 8), (128, 4, 4), (256, 4, 8), (128, 2, 8), (256, 2, 8),
            (128, 1, 8), (256, 1, 8), (128, 4, 6), (128, 4, 8, 8),
            (64, 4, 4), (64, 4, 8))
TOL = 1e-5


def variant_source(threads: int, rows: int, unroll: int,
                   min_ctas: int = 0) -> str:
    text = (CSRC / "ell_spmv.cu").read_text()
    subs = [(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {v};")
            for name, v in (("kThreads", threads), ("kRows", rows),
                            ("kUnroll", unroll))]
    if min_ctas:
        subs.append((r"__launch_bounds__\(kThreads\)",
                     f"__launch_bounds__(kThreads, {min_ctas})"))
    for pattern, new in subs:
        text, n = re.subn(pattern, new, text)
        if n != 1:
            raise RuntimeError(f"{pattern} not found once in ell_spmv.cu")
    return text


def variant_tag(variant) -> str:
    return "t{}_r{}_u{}".format(*variant) + "".join(
        f"_m{m}" for m in variant[3:])


def build(sources: dict) -> dict:
    """Compile ``{tag: (source text, csrc dir)}`` at once, as ``_build``
    does; returns each library's path and ptxas' register lines."""
    from repro_torch.kernels import _build
    procs = {}
    for tag, (text, csrc) in sources.items():
        d = OUT / tag
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(csrc / "common.cuh", d / "common.cuh")
        (d / "ell_spmv.cu").write_text(text)
        lib = d / "libell_spmv.so"
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
               str(lib), str(d / "ell_spmv.cu")]
        procs[tag] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for tag, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        regs = sorted({m.group(1) for m in re.finditer(
            r"Used (\d+) registers", log)})
        out[tag] = (lib, regs)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="an earlier tree's csrc directory")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_k3_variants: no CUDA card is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.core import ELLPACK, from_csr
    from repro_torch.core.timing import time_us
    from repro_torch.kernels import ops
    from repro_torch.kernels.ell_spmv import ell_spmv_plain

    dev = torch.device("cuda")
    sources = {variant_tag(v): (variant_source(*v), CSRC) for v in VARIANTS}
    if args.old:
        old = Path(args.old)
        sources["old"] = ((old / "ell_spmv.cu").read_text(), old)
    libs = build(sources)
    fns = {}
    for tag, (lib, _) in libs.items():
        fn = ctypes.CDLL(str(lib)).ell_spmv_f32_f32
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64,
                                                ctypes.c_void_p]
                       if tag == "old" else
                       [ctypes.c_void_p] * 5 + [ctypes.c_int64,
                                                ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[tag] = fn

    fem, raj = chip_smoke.fem2d_csr(2048, 2048), chip_smoke.raj1_csr()
    _, x_np, _ = chip_smoke.main_inputs(fem, raj)
    card = chip_smoke.card_line()
    all_ok = True
    for name, a in (("fem2d_2048", fem), ("raj1_full", raj)):
        args_csr = (a.data, a.indices, a.indptr, a.shape)
        if name == "raj1_full":
            h = from_csr(*args_csr, "hybrid", device=dev)
            m = ELLPACK(values=h.ell_values, columns=h.ell_columns,
                        shape=h.shape)
        else:
            m = from_csr(*args_csr, "ellpack", device=dev)
        plan = ops.make_ell_plan(m)
        vals, cols, seg = plan.values2d, plan.columns2d, plan.seg_slots
        k_pad, n_pad = vals.shape
        x = torch.from_numpy(x_np[name]).to(dev)
        want = ell_spmv_plain(vals, cols, x)
        scale = ell_spmv_plain(vals.abs(), cols, x.abs())

        def runner(tag, fn=None):
            def run():
                y = torch.empty(n_pad, device=dev)
                stream = torch.cuda.current_stream(dev).cuda_stream
                if tag == "old":
                    err = fn(vals.data_ptr(), cols.data_ptr(), x.data_ptr(),
                             y.data_ptr(), k_pad, n_pad, stream)
                else:
                    err = fn(vals.data_ptr(), cols.data_ptr(),
                             seg.data_ptr(), x.data_ptr(), y.data_ptr(),
                             n_pad, stream)
                if err:
                    raise RuntimeError(f"{tag}: CUDA error {err}")
                return y
            return run

        runs = {tag: runner(tag, fn) for tag, fn in fns.items()}
        live = int(seg.sum()) * 32
        y_x = x.nbytes + n_pad * 4
        bound_ms = chip_smoke.bound(live * 8 + y_x + seg.nbytes, 2 * live)[0]
        stored_ms = chip_smoke.bound(vals.nbytes + cols.nbytes + y_x,
                                     2 * vals.numel())[0]
        times = {tag: {"ms": [], "cold_ms": [], "wait_ms": []}
                 for tag in runs}
        errs = {}
        for tag, run in runs.items():
            y = run()
            torch.cuda.synchronize()
            diff = (y - want).abs()
            errs[tag] = (diff.max().item(),
                         bool((diff <= TOL * (1 + scale)).all()))
        order = list(runs)
        for turn in (order, order[::-1]):
            for tag in turn:
                for key, kw in (("ms", {"hold": True}),
                                ("cold_ms", {"cold": True}), ("wait_ms", {})):
                    times[tag][key].append(time_us(
                        runs[tag], calls=50, device=dev, **kw) / 1e3)
        for tag in runs:
            t = {k: float(np.median(v)) for k, v in times[tag].items()}
            print(json.dumps({
                "matrix": name, "variant": tag, "card": card,
                "shape": [k_pad, n_pad], "live_slots": live,
                "registers": libs[tag][1], **t,
                "turns": times[tag], "bound_ms": bound_ms,
                "stored_bound_ms": stored_ms,
                "share_of_bound": bound_ms / t["ms"],
                "max_abs_err": errs[tag][0], "ok": errs[tag][1]}),
                flush=True)
        all_ok = all_ok and all(e[1] for e in errs.values())
        del m, plan, vals, cols, seg, runs
        torch.cuda.empty_cache()
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
