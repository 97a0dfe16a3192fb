"""Multi-pod dry run: one training step of every (arch × shape × mesh) cell,
on ``meta`` tensors over a fake process group.

The PyTorch counterpart of ``repro.launch.dryrun``, which lowers and
compiles each cell against 512 forced host devices.  For each cell this
driver:

  1. builds the model on the ``meta`` device (shapes only: nothing drawn,
     nothing allocated — the 671B cells never materialise) and lays its
     parameters and optimizer state out as DTensors by the partitioner's
     rules on a ``DeviceMesh`` of the production shape — (16, 16) = 256
     ranks single-pod, (2, 16, 16) = 512 multi-pod — over torch's
     ``fake`` process group, this process its rank 0;
  2. runs the port's own tensor-parallel training step
     (``launch.steps.make_train_step(..., partitioner=)``) once on the
     meta batch of ``configs.input_specs``, counting its cost
     (``launch.hlo_cost.analyze_hlo``: product FLOPs, HBM bytes, the
     collective log, and the peak of live storage bytes above the step's
     arguments);
  3. turns the counts into the H100 roofline terms (``launch.mesh.HW``)
     and the ``model_flops_ratio``, into one JSON record per cell.

A serving cell (``prefill_32k``, ``decode_32k``, ``long_500k``) runs the
port's tensor-parallel serving step instead (``launch.steps``'
``make_prefill_step`` / ``make_decode_step`` with ``partitioner=``): the
parameters laid out by the serving rules in bf16 (``cell_overrides``),
the cache built whole as the reference builds it
(``init_cache(global_batch, seq_len, enc_len=)``, ``enc_len`` the
sequence at prefill and 4096 at decode for the encoder-decoder family),
as this rank's slices, which the step takes as arguments
(:func:`serve_cost`).  A process holds one default
process group: the dry run creates its fake group and destroys it before
:func:`run_cell` returns, and refuses to run beside another.

Host reads: the step reads one value on the host, the labelled positions
each CE term divides by (``LanguageModel.token_totals``); a meta batch has
no values, so every position counts there.  Nothing else in the step
reads a value (MoE routing is shape-driven: capacities from shapes,
positions from comparisons and cumulative sums).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  python -m repro_torch.launch.dryrun --shape train_4k --both-meshes \\
      [--out results.json]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import time
import traceback
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, input_specs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.hlo_cost import analyze_hlo
from repro_torch.launch.mesh import HW, make_mesh
from repro_torch.launch.steps import (auto_microbatches, local_zeros,
                                      make_decode_step, make_prefill_step,
                                      make_train_step, shard_for_serving)
from repro_torch.models import LanguageModel
from repro_torch.models.shardlib import resolve_attn_shard_mode
from repro_torch.sharding import layout
from repro_torch.sharding.partitioner import (SERVE_RULES, TRAIN_RULES,
                                              Partitioner, ShardingRules)
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import _attention_on, _flat, \
    distribute_model, lay_out_opt

__all__ = ["run_cell", "step_cost", "serve_cost", "main", "cell_overrides",
           "PEAK_FLOPS"]

# the peaks by the products' input dtype: bf16/fp16 on the tensor cores,
# fp32 outside them (TF32 is off: the port's float32 products run in
# full float32)
PEAK_FLOPS = {"bfloat16": HW.PEAK_FLOPS, "float16": HW.PEAK_FLOPS,
              "float32": HW.PEAK_FLOPS_FP32}
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def cell_overrides(arch: str, shape_kind: str) -> Dict[str, Any]:
    """Per-cell production config choices (the reference's):

    * deepseek-v3: Adafactor (factored stats) + bf16 params; every other
      arch trains AdamW/fp32-master.
    * serving cells run bf16 params (inference precision).
    """
    ov: Dict[str, Any] = {"optimizer": "adamw", "param_dtype": "float32"}
    if arch == "deepseek-v3-671b":
        ov["optimizer"] = "adafactor"
        ov["param_dtype"] = "bfloat16"
    if shape_kind != "train":
        ov["param_dtype"] = "bfloat16"
    return ov


def _cell_config(arch: str, shape_kind: str, mesh_shape: Dict[str, int],
                 cfg_overrides: Optional[Dict[str, Any]] = None,
                 micro_hint: int = 1, global_batch: int = 1):
    """``(cfg, overrides)`` of one cell on a mesh of ``mesh_shape`` (axis
    name → size): the reference's ``_build_model`` updates."""
    cfg = get_config(arch)
    ov = cell_overrides(arch, shape_kind)
    model_axis = mesh_shape["model"]
    batch_axes = ("pod", "data") if "pod" in mesh_shape else ("data",)
    batch_shards = math.prod(mesh_shape[a] for a in batch_axes)
    micro_global = max(1, global_batch // micro_hint)
    updates: Dict[str, Any] = {
        "param_dtype": ov["param_dtype"],
        "act_shard": True,
        "attn_shard_mode": resolve_attn_shard_mode(cfg, model_axis),
        "mesh_batch_axes": batch_axes,
        "shard_batch": micro_global % batch_shards == 0,
    }
    if shape_kind == "train":
        updates["remat"] = "full"
    for k, v in (cfg_overrides or {}).items():
        if k == "moe" and cfg.moe.n_experts:
            updates["moe"] = dataclasses.replace(cfg.moe, **v)
        elif k == "sparsity":
            updates["sparsity"] = dataclasses.replace(cfg.sparsity, **v)
        else:
            updates[k] = v
    return dataclasses.replace(cfg, **updates), ov


def _build_model(arch: str, shape_kind: str, mesh_shape: Dict[str, int],
                 cfg_overrides: Optional[Dict[str, Any]] = None,
                 micro_hint: int = 1, global_batch: int = 1):
    """``(model on meta, overrides)`` of one cell (:func:`_cell_config`)."""
    cfg, ov = _cell_config(arch, shape_kind, mesh_shape, cfg_overrides,
                           micro_hint, global_batch)
    return LanguageModel(cfg, device="meta"), ov


@contextlib.contextmanager
def fake_world(n: int):
    """A default process group of ``n`` ranks over torch's ``fake``
    backend (no communication), this process its rank 0, destroyed when
    the block ends; nothing for ``n`` = 1."""
    import torch.distributed as dist
    if n == 1:
        yield
        return
    if dist.is_initialized():
        raise RuntimeError("the dry run's fake process group needs a "
                           "process without a default group: run it in a "
                           "process of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    local = tree.to_local() if layout.is_dtensor(tree) else tree
    return local.numel() * local.element_size()


def roofline(cost) -> Dict[str, float]:
    """The roofline terms (seconds a step on each rank) of ``cost`` on
    ``launch.mesh.HW``'s H100 figures: products at the peak of their
    dtype (``PEAK_FLOPS``), bytes over HBM, collective traffic over
    NVLink.  ``peak_flops`` is the rate the products run at together."""
    compute_s = sum(f / PEAK_FLOPS[d] for d, f in
                    cost.flops_by_dtype.items())
    return {"compute_s": compute_s,
            "memory_s": cost.bytes / HW.HBM_BW,
            "collective_s": cost.collective_bytes_tpu / HW.ICI_BW,
            "peak_flops": cost.flops / compute_s if compute_s else 0.0}


def step_cost(cfg, mesh_shape: Sequence[int], axes: Sequence[str], *,
              seq: int, batch: int, microbatches: int, optimizer: str,
              rules: Optional[ShardingRules] = None) -> Dict[str, Any]:
    """One training step of ``cfg`` on rank 0 of a fake mesh of
    ``mesh_shape`` (named ``axes``; one device: the single-device step,
    no mesh), ``batch`` × ``seq`` tokens in ``microbatches`` parts, on
    ``meta`` tensors.  ``cfg``'s attention mode is resolved for the
    ``model`` axis as the ``Trainer`` resolves it.  Returns ``n_params``,
    ``n_active_params``, ``attn_shard_mode``, ``memory`` (the reference's
    keys), ``cost`` (``analyze_hlo``'s ``HloCost``), ``roofline``,
    ``bottleneck`` and ``build_s`` / ``run_s``."""
    n = math.prod(mesh_shape)
    meta = torch.device("meta")
    t0 = time.perf_counter()
    with fake_world(n):
        part = None
        if n > 1:
            mesh = make_mesh(mesh_shape, axes, device_type="cpu")
            part = Partitioner(mesh, "train", rules)
            cfg = _attention_on(cfg, mesh)
        model = LanguageModel(cfg, device=meta)
        model.requires_grad_(True)
        opt_cfg = OptimizerConfig(name=optimizer)
        step, opt_init = make_train_step(model, opt_cfg, microbatches,
                                         partitioner=part)
        batch_t = input_specs(cfg, ShapeConfig("dryrun", seq, batch,
                                               "train"))
        held_batch = batch_t
        if part is not None:
            spec = model.spec()
            distribute_model(model, _flat(part.param_shardings(spec)),
                             device=meta)
            params = model.tensors()
            opt_state = lay_out_opt(opt_init(params), part.opt_shardings(
                spec, optimizer, opt_cfg.factored_min_dim))
            rows = part.batch_shardings(batch_t)
            held_batch = {k: layout.local_chunk(v, mesh,
                                                rows[k].placements())
                          for k, v in batch_t.items()}
        else:
            params = model.tensors()
            opt_state = opt_init(params)
        state_bytes = _local_bytes(params) + _local_bytes(opt_state)
        args = state_bytes + _local_bytes(held_batch)
        build_s = time.perf_counter() - t0
        cost = analyze_hlo(lambda: step(params, opt_state, batch_t), n,
                           held=[*params.values(),
                                 *_flat(opt_state).values(),
                                 *batch_t.values()])
        out = {"n_params": model.n_params(),
               "n_active_params": model.n_active_params(),
               "attn_shard_mode": cfg.attn_shard_mode}
        del model, params, opt_state, step
    rl = roofline(cost)
    terms = {k: rl[k] for k in ("compute_s", "memory_s", "collective_s")}
    out.update(
        # the step writes the parameters in place and consumes the old
        # moments: its outputs alias its arguments; eager torch compiles
        # no code
        memory={"argument_size_in_bytes": float(args),
                "output_size_in_bytes": float(state_bytes),
                "temp_size_in_bytes": float(cost.temp_bytes),
                "generated_code_size_in_bytes": 0.0,
                "alias_size_in_bytes": float(state_bytes)},
        cost=cost, roofline=rl,
        bottleneck=max(terms, key=terms.get).replace("_s", ""),
        build_s=round(build_s, 1),
        run_s=round(time.perf_counter() - t0 - build_s, 1))
    return out


def serve_cost(cfg, mesh_shape: Sequence[int], axes: Sequence[str], *,
               shape_kind: str, seq: int, batch: int,
               rules: Optional[ShardingRules] = None) -> Dict[str, Any]:
    """One serving step of ``cfg`` (a prefill of ``batch`` × ``seq``
    tokens, or one decode step against caches of ``seq`` positions) on
    rank 0 of a fake mesh of ``mesh_shape`` (one device: the
    single-device step), on ``meta`` tensors.  The cache is built whole
    as the reference builds it and taken as this rank's slices, arguments
    of the step beside the parameters and the batch's rows.  Returns what
    :func:`step_cost` returns."""
    n = math.prod(mesh_shape)
    meta = torch.device("meta")
    t0 = time.perf_counter()
    with fake_world(n):
        part = None
        if n > 1:
            mesh = make_mesh(mesh_shape, axes, device_type="cpu")
            part = Partitioner(mesh, shape_kind, rules)
            cfg = _attention_on(cfg, mesh)
        model = LanguageModel(cfg, device=meta)
        inputs = input_specs(cfg, ShapeConfig("dryrun", seq, batch,
                                              shape_kind))
        prefill = shape_kind == "prefill"
        enc_len = (seq if prefill else 4096) if cfg.enc_dec else 0
        whole = model.init_cache(batch, seq, shape_kind=shape_kind,
                                 enc_len=enc_len, device=meta)
        held_batch = inputs
        if part is not None:
            shard_for_serving(model, part, device=meta)
            caches = local_zeros(part, whole, meta)
            rows = part.batch_shardings(inputs)
            held_batch = {k: layout.local_chunk(v, mesh,
                                                rows[k].placements())
                          for k, v in inputs.items()}
        else:
            caches = whole
        params = model.tensors()
        if prefill:
            step = make_prefill_step(model, seq, shape_kind,
                                     partitioner=part)
            run = lambda: step(inputs, caches=caches)      # noqa: E731
        else:
            step = make_decode_step(model, shape_kind, partitioner=part)
            run = lambda: step(caches, inputs["tokens"])   # noqa: E731
        cache_bytes = _local_bytes({str(i): c for i, c in enumerate(caches)})
        args = _local_bytes(params) + cache_bytes + _local_bytes(held_batch)
        build_s = time.perf_counter() - t0
        out_bytes = []

        def counted():
            logits, _ = run()
            out_bytes.append(logits.numel() * logits.element_size())
        cost = analyze_hlo(counted, n, held=[*params.values(),
                                             *_flat({"c": caches}).values(),
                                             *inputs.values()])
        out = {"n_params": model.n_params(),
               "n_active_params": model.n_active_params(),
               "attn_shard_mode": cfg.attn_shard_mode}
        del model, params, caches, step, run
    rl = roofline(cost)
    terms = {k: rl[k] for k in ("compute_s", "memory_s", "collective_s")}
    out.update(
        # the caches are written in place: the step's cache outputs alias
        # its cache arguments; its logits are new
        memory={"argument_size_in_bytes": float(args),
                "output_size_in_bytes": float(cache_bytes + out_bytes[0]),
                "temp_size_in_bytes": float(cost.temp_bytes),
                "generated_code_size_in_bytes": 0.0,
                "alias_size_in_bytes": float(cache_bytes)},
        cost=cost, roofline=rl,
        bottleneck=max(terms, key=terms.get).replace("_s", ""),
        build_s=round(build_s, 1),
        run_s=round(time.perf_counter() - t0 - build_s, 1))
    return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             cfg_overrides: Optional[Dict[str, Any]] = None,
             microbatch_override: Optional[int] = None,
             rules_override: Optional[Dict[str, Any]] = None,
             keep_hlo: bool = False) -> Dict[str, Any]:
    """Dry-run one cell; returns the §Dry-run/§Roofline record.

    ``rules_override``: logical-axis → mesh-axis entries merged over the
    default rules of the cell's kind (training's or serving's) — the knob
    the hill-climb turns.  ``keep_hlo`` keeps the step's collective log
    (the port has no HLO text) under ``collective_log``."""
    shape = SHAPES[shape_name]
    train = shape.kind == "train"
    mesh_shape, axes = PRODUCTION_MESHES[multi_pod]
    n_devices = math.prod(mesh_shape)
    sizes = dict(zip(axes, mesh_shape))
    micro = 1
    if train:
        micro = microbatch_override or auto_microbatches(
            get_config(arch), shape.global_batch, shape.seq_len,
            n_devices // sizes["model"])
    cfg, ov = _cell_config(arch, shape.kind, sizes, cfg_overrides,
                           micro_hint=micro,
                           global_batch=shape.global_batch)
    rules = None
    if rules_override:
        base = TRAIN_RULES if train else SERVE_RULES
        rules = ShardingRules(params={**base.params, **rules_override},
                              batch=base.batch)
    if train:
        res = step_cost(cfg, mesh_shape, axes, seq=shape.seq_len,
                        batch=shape.global_batch, microbatches=micro,
                        optimizer=ov["optimizer"], rules=rules)
    else:
        res = serve_cost(cfg, mesh_shape, axes, shape_kind=shape.kind,
                         seq=shape.seq_len, batch=shape.global_batch,
                         rules=rules)
    cost = res["cost"]
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": list(mesh_shape),
        "multi_pod": multi_pod, "n_devices": n_devices,
        "param_dtype": cfg.param_dtype, "optimizer": ov["optimizer"],
        "attn_shard_mode": res["attn_shard_mode"],
        "n_params": res["n_params"],
        "n_active_params": res["n_active_params"],
        **({"microbatches": micro} if train else {}),
        "build_s": res["build_s"],
        "run_s": res["run_s"], "memory": res["memory"],
        "cost": {
            "flops": cost.flops,                # per device, this step
            "flops_by_dtype": cost.flops_by_dtype,
            "bytes": cost.bytes,
            "collective_bytes": cost.collective_bytes,
            "collective_bytes_tpu": cost.collective_bytes_tpu,
            "collective_bytes_f32_dot": cost.collective_bytes_f32_dot,
            "collective_counts": cost.collective_counts,
            "collective_bytes_by_kind": cost.collective_bytes_by_kind,
            "collective_bytes_by_axis": cost.collective_bytes_by_axis,
            "n_loops": len(cost.loops),
        },
        "roofline": {k: res["roofline"][k] for k in
                     ("compute_s", "memory_s", "collective_s")},
        "peak_flops": res["roofline"]["peak_flops"],
        "bottleneck": res["bottleneck"],
    }
    if keep_hlo:
        record["collective_log"] = [dataclasses.asdict(r)
                                    for r in cost.collectives]
    # MODEL_FLOPS: useful work over the work the step runs, per device:
    # 6·N_active·tokens for training (forward and backward), 2·N_active
    # for inference (forward only; a decode step's tokens are the batch)
    tokens = shape.global_batch * (shape.seq_len if shape.kind in
                                   ("train", "prefill") else 1)
    mf = (6.0 if train else 2.0) * res["n_active_params"] * tokens
    record["model_flops_global"] = mf
    record["model_flops_ratio"] = (mf / n_devices) / cost.flops \
        if cost.flops else 0.0
    return record


def hbm_gib(rec: Dict[str, Any]) -> float:
    """A record's HBM a device in GiB: arguments, outputs and temporaries
    less what aliases (the roofline table's column)."""
    mem = rec.get("memory", {})
    return (mem.get("argument_size_in_bytes", 0)
            + mem.get("output_size_in_bytes", 0)
            + mem.get("temp_size_in_bytes", 0)
            - mem.get("alias_size_in_bytes", 0)) / 2 ** 30


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--micro", type=int, default=None)
    ap.add_argument("--skip", default="",
                    help="comma-separated arch:shape cells to skip")
    ap.add_argument("--only", default="",
                    help="comma-separated arch:shape cells to run")
    args = ap.parse_args(argv)
    skip = {tuple(c.split(":")) for c in args.skip.split(",") if c}
    only = {tuple(c.split(":")) for c in args.only.split(",") if c}

    archs = sorted(ARCH_IDS) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    jsonl = open(args.out + "l", "a") if args.out else None
    try:
        for arch in archs:
            for shape in shapes:
                if (arch, shape) in skip or (only and (arch, shape)
                                             not in only):
                    continue
                for mp in meshes:
                    tag = f"{arch} × {shape} × " \
                          f"{'2x16x16' if mp else '16x16'}"
                    try:
                        rec = run_cell(arch, shape, multi_pod=mp,
                                       microbatch_override=args.micro)
                        rec["status"] = "ok"
                        print(f"[dryrun] OK   {tag}: build={rec['build_s']}s"
                              f" step={rec['run_s']}s "
                              f"flops={rec['cost']['flops']:.3e} "
                              f"coll={rec['cost']['collective_bytes']:.3e}B"
                              f" hbm={hbm_gib(rec):.2f}GiB "
                              f"bottleneck={rec['bottleneck']}", flush=True)
                    except Exception as e:  # noqa: BLE001 — record, go on
                        rec = {"arch": arch, "shape": shape,
                               "multi_pod": mp, "status": "error",
                               "error": repr(e),
                               "traceback": traceback.format_exc()}
                        print(f"[dryrun] FAIL {tag}: {e!r}", flush=True)
                    results.append(rec)
                    if jsonl:
                        jsonl.write(json.dumps(rec) + "\n")
                        jsonl.flush()
                    gc.collect()
    finally:
        if jsonl:
            jsonl.close()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {len(results)} records to {args.out}")
    n_err = sum(r["status"] != "ok" for r in results)
    print(f"[dryrun] {len(results) - n_err}/{len(results)} cells OK")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
