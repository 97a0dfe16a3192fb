"""Roofline table generator: dryrun.jsonl → the §Roofline rows.

The PyTorch counterpart of ``repro.launch.roofline`` (it uses no
framework; a copy with the H100's figures in this note).  Terms (per
device, per step — seconds; ``launch/dryrun.py`` computes them from
``launch.mesh.HW``):
    compute    = product FLOPs / 989e12 (bf16) or 67e12 (fp32), by dtype
    memory     = traffic bytes / 3.35e12
    collective = ring-model collective bytes / 450e9

plus MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference) with N = active
params, the ratio MODEL_FLOPS/HLO_FLOPs, the dominant term, and a
one-line "what would move it" note derived from the dominant term and the
collective mix.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List

__all__ = ["load_records", "roofline_row", "render_table", "main"]


def load_records(path: str) -> List[Dict]:
    recs = []
    with open(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == "[":
            recs = json.load(f)
        else:
            for line in f:
                line = line.strip()
                if line:
                    recs.append(json.loads(line))
    # deduplicate on (arch, shape, multi_pod), last wins (reruns)
    seen = {}
    for r in recs:
        seen[(r["arch"], r["shape"], r.get("multi_pod", False))] = r
    return list(seen.values())


_ADVICE = {
    "compute": "compute-bound: raise per-chip utilization (larger per-device "
               "batch, fuse small dots) or add chips",
    "memory": "memory-bound: cut HBM traffic (fused attention kernel, fewer "
              "microbatch weight re-reads, bf16 buffers)",
    "collective": "collective-bound: reduce FSDP re-gathers / switch "
                  "sharding so weights stay resident; overlap with compute",
}


def roofline_row(rec: Dict) -> Dict:
    r = dict(rec)
    rl = rec.get("roofline", {})
    total = max(rl.values()) if rl else 0.0
    r["dominant"] = rec.get("bottleneck", "?")
    r["advice"] = _ADVICE.get(r["dominant"], "")
    r["step_lower_bound_s"] = total
    return r


def render_table(recs: List[Dict], multi_pod: bool = False) -> str:
    rows = [roofline_row(r) for r in recs
            if r.get("status") == "ok" and r.get("multi_pod") == multi_pod]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = ["| arch | shape | compute_s | memory_s | collective_s | "
           "bottleneck | MODEL_FLOPs/HLO | HBM GiB/dev |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        rl = r.get("roofline", {})
        mem = r.get("memory", {})
        hbm = (mem.get("argument_size_in_bytes", 0)
               + mem.get("output_size_in_bytes", 0)
               + mem.get("temp_size_in_bytes", 0)
               - mem.get("alias_size_in_bytes", 0)) / 2 ** 30
        out.append(
            f"| {r['arch']} | {r['shape']} | "
            f"{rl.get('compute_s', 0):.4f} | {rl.get('memory_s', 0):.4f} | "
            f"{rl.get('collective_s', 0):.4f} | {r['dominant']} | "
            f"{r.get('model_flops_ratio', 0):.3f} | {hbm:.2f} |")
    failed = [r for r in recs
              if r.get("status") != "ok" and r.get("multi_pod") == multi_pod]
    for r in failed:
        out.append(f"| {r['arch']} | {r['shape']} | FAILED: "
                   f"{r.get('error', '?')[:60]} | | | | | |")
    return "\n".join(out)


def main(argv=None):
    path = argv[0] if argv else "results/dryrun.jsonl"
    recs = load_records(path)
    print("## single-pod (16×16 = 256 chips)\n")
    print(render_table(recs, multi_pod=False))
    print("\n## multi-pod (2×16×16 = 512 chips)\n")
    print(render_table(recs, multi_pod=True))


if __name__ == "__main__":
    main(sys.argv[1:])
