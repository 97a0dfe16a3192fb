"""Render a markdown file's result sections from the measured records.

The PyTorch counterpart of ``repro.launch.report``.  ``main`` takes the
markdown file and the records' paths (the repository holds no
``EXPERIMENTS.md``), and replaces the placeholders
``<!-- ROOFLINE_TABLE -->``, ``<!-- PERF_LOG -->`` and
``<!-- PERF_SUMMARY -->`` in it:

  python -m repro_torch.launch.report NOTES.md dryrun.jsonl ... \
      [--hillclimb hillclimb.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.roofline import load_records, render_table


def perf_log_table(path: str) -> str:
    if not os.path.exists(path):
        return "_hillclimb records missing_"
    recs = [json.loads(l) for l in open(path) if l.strip()]
    # keep the last record per iteration name (reruns supersede)
    seen = {}
    for r in recs:
        seen[r["iter"]] = r
    out = ["| iter | hypothesis | compute_s | memory_s | collective_s | "
           "MODEL_FLOPs/HLO | verdict |",
           "|---|---|---|---|---|---|---|"]
    prev = {}
    for name in sorted(seen):
        r = seen[name]
        if r.get("status") != "ok":
            out.append(f"| {name} | {r['hypothesis'][:80]}… | ERROR | | | | "
                       f"{r.get('error', '')[:40]} |")
            continue
        rl = r["roofline"]
        series = name.split(".")[0]
        verdict = ""
        if series in prev:
            p = prev[series]
            deltas = []
            for k, lbl in (("compute_s", "C"), ("memory_s", "M"),
                           ("collective_s", "X")):
                if p[k] > 0:
                    d = 100.0 * (rl[k] - p[k]) / p[k]
                    if abs(d) >= 1:
                        deltas.append(f"{lbl}{d:+.0f}%")
            verdict = " ".join(deltas) or "~no change"
        prev[series] = rl
        hyp = r["hypothesis"].replace("|", "/")
        out.append(f"| {name} | {hyp} | {rl['compute_s']:.3f} | "
                   f"{rl['memory_s']:.3f} | {rl['collective_s']:.3f} | "
                   f"{r.get('model_flops_ratio', 0):.3f} | {verdict} |")
    return "\n".join(out)


def perf_summary(path: str) -> str:
    if not os.path.exists(path):
        return "_hillclimb records missing_"
    recs = [json.loads(l) for l in open(path) if l.strip()]
    seen = {}
    for r in recs:
        seen[r["iter"]] = r
    pairs = [
        ("H1 granite-3-2b train_4k", "h1.0-baseline", "h1.5-bf16-comms"),
        ("H2 deepseek-v3 prefill_32k", "h2.0-baseline",
         "h2.2-capacity-1.0"),
        ("H3 RgCSR-FFN vs dense", "h3.0-dense-ffn-ref",
         "h3.1-rgcsr-ffn-d25"),
    ]
    out = ["| cell | variant | compute_s | memory_s | collective_s | "
           "step lower-bound (max term) | roofline fraction (compute/max) |",
           "|---|---|---|---|---|---|---|"]
    for label, base, best in pairs:
        for tag, key in (("paper-faithful baseline", base),
                         ("beyond-paper optimized", best)):
            r = seen.get(key)
            if not r or r.get("status") != "ok":
                out.append(f"| {label} | {tag} ({key}) | missing | | | | |")
                continue
            rl = r["roofline"]
            mx = max(rl.values())
            frac = rl["compute_s"] / mx if mx else 0.0
            out.append(f"| {label} | {tag} | {rl['compute_s']:.3f} | "
                       f"{rl['memory_s']:.3f} | {rl['collective_s']:.3f} | "
                       f"{mx:.3f} | {frac:.2f} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("markdown")
    ap.add_argument("records", nargs="*",
                    help="dry-run records (JSON list or JSON lines)")
    ap.add_argument("--hillclimb", default="",
                    help="the hill-climb's JSON lines")
    args = ap.parse_args(argv)
    recs = []
    for p in args.records:
        recs += load_records(p)
    # dedupe (arch, shape, mesh): last wins
    seen = {}
    for r in recs:
        seen[(r["arch"], r["shape"], r.get("multi_pod", False))] = r
    recs = list(seen.values())

    n_ok = sum(r.get("status") == "ok" for r in recs)
    header = (f"Cells dry-run OK: {n_ok}/{len(recs)} "
              f"(each cell = one training step on meta tensors over a "
              f"fake process group of the production mesh).\n\n")
    table = (header
             + "### single-pod (16×16 = 256 devices) — the §Roofline "
               "table\n\n"
             + render_table(recs, multi_pod=False)
             + "\n\n### multi-pod (2×16×16 = 512 devices)\n\n"
             + render_table(recs, multi_pod=True))

    with open(args.markdown) as f:
        md = f.read()
    md = md.replace("<!-- ROOFLINE_TABLE -->", table)
    md = md.replace("<!-- PERF_LOG -->", perf_log_table(args.hillclimb))
    md = md.replace("<!-- PERF_SUMMARY -->", perf_summary(args.hillclimb))
    with open(args.markdown, "w") as f:
        f.write(md)
    print(f"{args.markdown} updated: {n_ok}/{len(recs)} cells")


if __name__ == "__main__":
    main()
