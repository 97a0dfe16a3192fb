"""§Perf hill-climb driver: hypothesis → change → dry-run again → measure.

The PyTorch counterpart of ``repro.launch.hillclimb``, over the port's
dry run (``launch/dryrun.py``).  Three series:
  H1 granite-3-2b × train_4k      — the reference's collective-bound cell
  H2 deepseek-v3-671b × prefill_32k — MoE dispatch; a serving cell, run
     by the port's tensor-parallel prefill step with whole-mesh experts.
     A prefill routes dropless, so past ``moe._DROPLESS_EINSUM_BUDGET``
     the einsum dispatch reroutes to the scatter one and no capacity
     applies: at 32 × 32,768 tokens the three iterations run one step, as
     the reference's would
  H3 granite-3-2b × train_4k + RgCSR sparse FFN — the paper's technique

Each iteration is one ``run_cell`` with a config/rules override; results
are appended to ``--out`` (JSON lines) with the iteration's hypothesis
string, so the §Perf tables (``launch/report.py``) come from measured
records.  The hypotheses are the reference's, which were written for a
TPU v5e; h1.5's upcast does not exist in the port, so h1.5 runs h1.3's
cell again.
"""
import argparse
import json
import os
import time

from repro_torch.launch.dryrun import run_cell

H1 = [
    dict(name="h1.0-baseline",
         hypothesis="paper-faithful baseline: FSDP(embed->data)+TP, remat "
                    "full, auto microbatches=8",
         arch="granite-3-2b", shape="train_4k", kw={}),
    dict(name="h1.1-no-fsdp",
         hypothesis="2.5B params fit TP-only (0.6GB/dev params+opt): drop "
                    "FSDP -> weight re-gathers (x8 microbatches x fwd/remat/"
                    "bwd) vanish; expect collective term down ~5-10x, memory "
                    "term down (no gathered-weight writes)",
         arch="granite-3-2b", shape="train_4k",
         kw=dict(rules_override={"embed": None})),
    dict(name="h1.2-micro4",
         hypothesis="halving microbatches 8->4 halves per-step weight "
                    "re-reads; activation checkpoints double (fits after "
                    "h1.1): expect memory term down, compute unchanged",
         arch="granite-3-2b", shape="train_4k",
         kw=dict(rules_override={"embed": None}, microbatch_override=4)),
    dict(name="h1.3-remat-dots",
         hypothesis="remat 'dots' keeps matmul outputs (no fwd recompute of "
                    "dots in bwd): expect compute term down ~20-25%, memory "
                    "(activation) term up",
         arch="granite-3-2b", shape="train_4k",
         kw=dict(rules_override={"embed": None}, microbatch_override=4,
                 cfg_overrides={"remat": "dots"})),
    dict(name="h1.4-seq-attn",
         hypothesis="attention TP via 'seq' (context-parallel q) instead of "
                    "'repeat' avoids materializing repeated kv: expect "
                    "memory down slightly, collective up (kv all-gather)",
         arch="granite-3-2b", shape="train_4k",
         kw=dict(rules_override={"embed": None}, microbatch_override=4,
                 cfg_overrides={"remat": "dots", "attn_shard_mode": "seq"})),
    dict(name="h1.5-bf16-comms",
         hypothesis="the 92%-dominant f32[2,4096,2048] all-reduces are TP "
                    "output reductions on CPU-upcast bf16 dots; TPU reduces "
                    "them at bf16 -> corrected collective term ~0.55x of "
                    "h1.3 (measured via the f32-dot collective bucket)",
         arch="granite-3-2b", shape="train_4k",
         kw=dict(rules_override={"embed": None}, microbatch_override=4,
                 cfg_overrides={"remat": "dots"})),
]

H2 = [
    dict(name="h2.0-baseline",
         hypothesis="paper-faithful GShard einsum dispatch: dispatch/combine "
                    "einsums cost 2*T*E*C*d flops/layer ~ O(100x) the expert "
                    "FFN flops at T=1M tokens",
         arch="deepseek-v3-671b", shape="prefill_32k", kw={}),
    dict(name="h2.1-scatter-dispatch",
         hypothesis="sort-based scatter dispatch moves tokens with gathers "
                    "(0 flops): expect HLO flops down ~10-100x, "
                    "MODEL_FLOPS ratio toward ~0.5+, bottleneck flips to "
                    "memory/collective",
         arch="deepseek-v3-671b", shape="prefill_32k",
         kw=dict(cfg_overrides={"moe": {"dispatch": "scatter"}})),
    dict(name="h2.2-capacity-1.0",
         hypothesis="capacity factor 1.25->1.0 cuts expert buffer (E,C,d) "
                    "by 20%: expect memory term down ~10-20% on top of h2.1",
         arch="deepseek-v3-671b", shape="prefill_32k",
         kw=dict(cfg_overrides={"moe": {"dispatch": "scatter",
                                        "capacity_factor": 1.0}})),
]

H3 = [
    dict(name="h3.0-dense-ffn-ref",
         hypothesis="dense-FFN reference point for the sparse cells "
                    "(same arch/shape as h1.1)",
         arch="granite-3-2b", shape="train_4k",
         kw=dict(rules_override={"embed": None})),
    dict(name="h3.1-rgcsr-ffn-d25",
         hypothesis="RgCSR FFN down-proj at 25% density: FFN w_out dot "
                    "flops (2*T*dff*d) replaced by gather+segsum bytes; "
                    "expect compute term down ~15% (w_out is ~1/3 of FFN), "
                    "memory term up (ref-impl gather traffic)",
         arch="granite-3-2b", shape="train_4k",
         kw=dict(rules_override={"embed": None},
                 cfg_overrides={"sparsity": {"enabled": True,
                                             "density": 0.25,
                                             "impl": "ref"}})),
    dict(name="h3.2-rgcsr-ffn-d125",
         hypothesis="halving density 0.25->0.125 halves sparse bytes: "
                    "expect memory delta vs h3.1 ~2x smaller sparse term",
         arch="granite-3-2b", shape="train_4k",
         kw=dict(rules_override={"embed": None},
                 cfg_overrides={"sparsity": {"enabled": True,
                                             "density": 0.125,
                                             "impl": "ref"}})),
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--series", default="h1,h2,h3")
    ap.add_argument("--out", default="results/hillclimb.jsonl")
    args = ap.parse_args(argv)
    series = {"h1": H1, "h2": H2, "h3": H3}
    todo = [s.strip() for s in args.series.split(",")]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        for s in todo:
            for it in series[s]:
                t0 = time.time()
                try:
                    rec = run_cell(it["arch"], it["shape"], **it["kw"])
                    rec["status"] = "ok"
                except Exception as e:  # noqa: BLE001 — record, go on
                    rec = {"status": "error", "error": repr(e)}
                rec["iter"] = it["name"]
                rec["hypothesis"] = it["hypothesis"]
                rec["wall_s"] = round(time.time() - t0, 1)
                f.write(json.dumps(rec) + "\n")
                f.flush()
                rl = rec.get("roofline", {})
                print(f"[{it['name']}] {rec['status']} "
                      f"compute={rl.get('compute_s', 0):.3f}s "
                      f"mem={rl.get('memory_s', 0):.3f}s "
                      f"coll={rl.get('collective_s', 0):.3f}s "
                      f"ratio={rec.get('model_flops_ratio', 0):.3f}",
                      flush=True)


if __name__ == "__main__":
    main()
