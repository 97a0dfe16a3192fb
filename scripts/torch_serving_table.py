"""The dry run's serving table: serving cells on the production (16, 16)
mesh, each in a process of its own, several at once.

Each cell is one ``repro_torch.launch.dryrun.run_cell`` (the
tensor-parallel prefill or decode step on ``meta`` tensors over a fake
process group, counted by ``launch/hlo_cost.py``); the hill-climb's H2
iterations (``launch/hillclimb.py``: deepseek-v3 × ``prefill_32k``,
GShard einsum against scatter dispatch, capacity 1.0) run the same way
with their overrides.  Every number is a prediction from
``launch.mesh.HW``'s H100 figures, no card is used.  The script writes
every record to ``--out`` (JSON) and prints one markdown table::

    PYTHONPATH=src python3 scripts/torch_serving_table.py \\
        --out results/serving.json --jobs 7
"""
import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ("prefill_32k", "decode_32k", "long_500k")
# granite-3-2b, then one arch of each family: MLA, MoE, recurrent,
# encoder-decoder, vision
ARCHS = ("granite-3-2b", "minicpm3-4b", "granite-moe-1b-a400m",
         "recurrentgemma-9b", "seamless-m4t-medium", "pixtral-12b")
H2_DECODE = (("deepseek-v3-671b", "decode_32k"),
             ("deepseek-v3-671b", "long_500k"))


def cells():
    """``(label, arch, shape, run_cell keywords)`` of every cell."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.hillclimb import H2
    out = [(f"{a} {s}", a, s, {}) for a in ARCHS for s in SHAPES]
    out += [(f"{it['name']}", it["arch"], it["shape"], it["kw"])
            for it in H2]
    out += [(f"{a} {s}", a, s, {}) for a, s in H2_DECODE]
    return out


def one(arch: str, shape: str, kw_json: str) -> None:
    """One cell, its record as JSON on the last line of stdout."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.dryrun import run_cell
    t0 = time.perf_counter()
    try:
        rec = run_cell(arch, shape, **json.loads(kw_json))
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — recorded in the table
        rec = {"arch": arch, "shape": shape, "status": "error",
               "error": repr(e)}
    rec["wall_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(rec))


def _row(label, rec):
    if rec.get("status") != "ok":
        return f"| {label} | {rec.get('error', rec.get('status'))} |"
    from repro_torch.launch.dryrun import hbm_gib
    rl, cost = rec["roofline"], rec["cost"]
    moved = ", ".join(f"{k} {v / 1e6:.2f}" for k, v in
                      sorted(cost["collective_bytes_by_axis"].items()))
    return (f"| {label} | {rec['attn_shard_mode']} | "
            f"{cost['flops']:.4e} | {cost['bytes']:.4e} | {moved} | "
            f"{rl['compute_s'] * 1e3:.3f} | {rl['memory_s'] * 1e3:.3f} | "
            f"{rl['collective_s'] * 1e3:.3f} | {rec['bottleneck']} | "
            f"{rec['model_flops_ratio']:.3f} | {hbm_gib(rec):.2f} | "
            f"{rec['wall_s']} |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/serving.json")
    ap.add_argument("--jobs", type=int, default=max(1, os.cpu_count() - 1))
    ap.add_argument("--only", default="",
                    help="comma-separated labels of cells to run")
    args = ap.parse_args(argv)
    todo = [c for c in cells()
            if not args.only or c[0] in args.only.split(",")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")

    def run(cell):
        label, arch, shape, kw = cell
        p = subprocess.run([sys.executable, __file__, "--cell", arch, shape,
                            json.dumps(kw)], capture_output=True, text=True,
                           env=env, cwd=ROOT)
        lines = p.stdout.strip().splitlines()
        try:
            return label, json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            return label, {"status": "error",
                           "error": f"exit {p.returncode}: "
                                    f"{p.stderr[-300:]!r}"}
    with ThreadPoolExecutor(args.jobs) as pool:
        results = list(pool.map(run, todo))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({label: rec for label, rec in results}, f, indent=1)
    sys.path.insert(0, str(ROOT / "src"))
    print("| cell | attention | FLOPs a rank | bytes a rank | collective MB "
          "a rank | compute ms | memory ms | collective ms | bottleneck | "
          "MODEL_FLOPs ratio | HBM GiB a rank | dry run s |")
    print("| --- " * 12 + "|")
    for label, rec in results:
        print(_row(label, rec))
    return 0 if all(r.get("status") == "ok" for _, r in results) else 1


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--cell":
        one(*sys.argv[2:5])
        sys.exit(0)
    sys.exit(main())
