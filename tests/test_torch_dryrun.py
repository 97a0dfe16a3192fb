"""The port's dry run (``repro_torch.launch.dryrun``), its cost model
(``hlo_cost``, ``hlo_stats``) and its reports (``roofline``, ``report``)
against the reference's.

In process: ``input_specs`` of every (arch × shape), the cells' config
updates (the reference's ``dryrun.py`` functions compiled from their
source: importing that module sets ``XLA_FLAGS`` for 512 host devices),
``collective_stats`` on synthetic HLO lines against the same collectives
logged, the roofline and report tables on the same records, product
FLOP counts (one product, a ten-step loop, the reference's HLO count of
a jitted smoke train step under remat ``none`` and ``full``), the
counter against ``FlopCounterMode`` and ``MemTracker``.  Then the core
check: rank 0 of a fake (2, 2) mesh against rank 0 of four spawned gloo
ranks (``tests/_torch_dist.py``, ``dryrun_ranks``), the same
tensor-parallel step of granite-3-2b, granite-moe, mamba2-780m and
recurrentgemma-9b (their mixers split), and the same serving steps
(``DRYRUN_SERVE_CASES``: prefill, decode and long_decode): FLOPs and
collective calls and bytes by kind and mesh axis equal exactly.  The
serving cells: a record for each serving shape of every arch's smoke
config on a fake (2, 2), and the one-device prefill and decode FLOPs
against the reference's HLO count of a smoke step.  Last, one
production cell in a subprocess.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
import types
import typing
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist

from _torch_dist import (BATCH, DRYRUN_CASES, DRYRUN_MICRO,
                         DRYRUN_SERVE_CASES, SEQ, collective_summary,
                         dryrun_cfg, dryrun_ranks, dryrun_serve_cfg,
                         run_ranks)

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.configs import input_specs as ref_input_specs
from repro.configs.base import ShapeConfig as RefShape
from repro.launch import hlo_stats as ref_hlo_stats
from repro.launch import report as ref_report
from repro.launch import roofline as ref_roofline
from repro.launch import steps as ref_steps
from repro.launch.hlo_cost import analyze_hlo as ref_analyze_hlo
from repro.models import LanguageModel as RefModel
from repro.train import optimizer as ref_opt
from repro_torch.configs import ARCH_IDS, SHAPES, get_smoke, input_specs
from repro_torch.launch import dryrun, hlo_stats, report, roofline
from repro_torch.launch.hlo_cost import analyze_hlo
from repro_torch.sharding import layout

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ARCHS = sorted(ARCH_IDS)


def _reference_dryrun(*names):
    """Functions of ``repro/launch/dryrun.py`` compiled from its source
    alone, in one scope (the caller adds what their bodies read)."""
    tree = ast.parse((REPO / "src" / "repro" / "launch" /
                      "dryrun.py").read_text())
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)
           and n.name in names]
    scope = {"dataclasses": dataclasses, "Dict": typing.Dict,
             "Any": typing.Any, "Optional": typing.Optional,
             "get_config": ref_get_config,
             "LanguageModel": lambda cfg: cfg}
    exec(compile(ast.Module(fns, []), "dryrun.py", "exec"), scope)
    return scope


# ------------------------------------------------------- inputs, configs


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_are_the_reference_s(arch):
    cfg, ref_cfg = dryrun.get_config(arch), ref_get_config(arch)
    for shape in SHAPES:
        got, want = input_specs(cfg, shape), ref_input_specs(ref_cfg, shape)
        assert list(got) == list(want), shape
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[k].shape, (shape, k)
            assert str(t.dtype).replace("torch.", "") == \
                str(want[k].dtype), (shape, k)


OVERRIDES = (None, {"remat": "dots", "attn_shard_mode": "seq"},
             {"sparsity": {"enabled": True, "density": 0.25,
                           "impl": "ref"}},
             {"moe": {"dispatch": "scatter", "capacity_factor": 1.0}})


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_updates_are_the_reference_s(arch):
    ref = _reference_dryrun("cell_overrides", "resolve_attn_shard_mode",
                            "_build_model")
    for multi in (False, True):
        sizes = {"pod": 2, "data": 16, "model": 16} if multi \
            else {"data": 16, "model": 16}
        mesh = types.SimpleNamespace(shape=sizes, axis_names=tuple(sizes))
        for kind in ("train", "prefill", "decode", "long_decode"):
            assert dryrun.cell_overrides(arch, kind) == \
                ref["cell_overrides"](arch, kind)
            for ov in OVERRIDES:
                for micro, batch in ((1, 256), (8, 256), (1, 1)):
                    want, want_ov = ref["_build_model"](
                        arch, kind, mesh, ov, micro_hint=micro,
                        global_batch=batch)
                    got, got_ov = dryrun._cell_config(
                        arch, kind, sizes, ov, micro_hint=micro,
                        global_batch=batch)
                    assert got_ov == want_ov
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want), (kind, ov, micro)


def test_auto_microbatches_is_the_reference_s_where_that_ends():
    """The reference's loop never ends when the budget asks for more
    microbatches than a shard has sequences (qwen1.5-32b, deepseek-v3 on
    16 × 16); the port clamps to one sequence a microbatch there."""
    from repro_torch.launch.steps import auto_microbatches
    for arch in ARCHS:
        cfg, ref_cfg = dryrun.get_config(arch), ref_get_config(arch)
        for n_data in (1, 4, 16, 32):
            b_dev = 256 // n_data
            asked = -(-b_dev * 4096 * cfg.d_model * 2 * cfg.n_layers
                      // 2.0e9)
            got = auto_microbatches(cfg, 256, 4096, n_data)
            assert b_dev % got == 0
            if asked <= b_dev:
                assert got == ref_steps.auto_microbatches(ref_cfg, 256, 4096,
                                                          n_data)
            else:
                assert got == b_dev, (arch, n_data)


def test_build_model_is_on_meta():
    model, ov = dryrun._build_model("deepseek-v3-671b", "train",
                                    {"data": 16, "model": 16})
    assert ov == {"optimizer": "adafactor", "param_dtype": "bfloat16"}
    assert {t.device.type for t in model.tensors().values()} == {"meta"}
    assert model.n_params() > 6e11 and model.cfg.remat == "full"


# ------------------------------------------------------- collective_stats


def _hlo_line(kind, dtype, result, operand, groups):
    return (f"  %{kind}.7 = {dtype}[{','.join(map(str, result))}]{{1,0}} "
            f"{kind}({dtype}[{','.join(map(str, operand))}]{{1,0}} %p.1), "
            f"channel_id=3{groups}, use_global_device_ids=true")


def test_collective_stats_is_the_reference_s():
    n_devices = 8
    size = {"f32": 4, "bf16": 2}
    lines, records = [], []
    for dtype in ("f32", "bf16"):
        for form, groups in (("explicit", ", replica_groups={{0,1,2,3},"
                              "{4,5,6,7}}"),
                             ("iota", ", replica_groups=[2,4]<=[8]")):
            for kind in ("all-gather", "reduce-scatter", "all-reduce",
                         "all-to-all", "collective-permute"):
                result, operand = (16, 64), (16, 64)
                if kind == "all-gather":
                    operand = (4, 64)
                if kind == "reduce-scatter":
                    result = (4, 64)
                g = "" if kind == "collective-permute" else groups
                lines.append(_hlo_line(kind, dtype, result, operand, g))
                # the log's bytes: the whole tensor moved (a
                # reduce-scatter's operand, else the result)
                whole = operand if kind == "reduce-scatter" else result
                records.append(layout.Collective(
                    kind, "model", 0 if kind == "collective-permute" else 4,
                    whole[0] * whole[1] * size[dtype]))
    lines.append("  %add.1 = f32[16,64]{1,0} add(f32[16,64]{1,0} %a, "
                 "f32[16,64]{1,0} %b)")
    want = ref_hlo_stats.collective_stats("\n".join(lines), n_devices)
    got = hlo_stats.collective_stats(records, n_devices)
    assert got == want
    assert got["total_count"] == 20


def test_the_collective_log_records_only_while_open():
    layout.record_collective("all-reduce", "model", 2, 8)   # no log: nothing
    with layout.collective_log() as outer:
        with layout.collective_log() as inner:
            layout.record_collective("all-gather", "data", 4, 64)
        layout.record_collective("all-reduce", "model", 2, 8)
    layout.record_collective("all-reduce", "model", 2, 8)
    assert inner == [layout.Collective("all-gather", "data", 4, 64)]
    assert outer == inner + [layout.Collective("all-reduce", "model", 2, 8)]
    assert hlo_stats.moved_bytes(outer) == {"all-gather data": 64,
                                            "all-reduce model": 8}


# ------------------------------------------------------ roofline, report


def _records():
    recs = []
    for i, (arch, mp) in enumerate((("granite-3-2b", False),
                                    ("granite-3-2b", True),
                                    ("qwen1.5-32b", False),
                                    ("deepseek-v3-671b", True))):
        recs.append({
            "arch": arch, "shape": "train_4k", "multi_pod": mp,
            "status": "ok",
            "roofline": {"compute_s": 0.5 + i, "memory_s": 0.25 * i,
                         "collective_s": 2.0 - 0.4 * i},
            "bottleneck": ["collective", "collective", "compute",
                           "compute"][i],
            "model_flops_ratio": 0.61 + 0.1 * i,
            "memory": {"argument_size_in_bytes": 2.0 ** 30 * (i + 1),
                       "output_size_in_bytes": 2.0 ** 29,
                       "temp_size_in_bytes": 3.0 * 2 ** 30,
                       "alias_size_in_bytes": 2.0 ** 29}})
    recs.append({"arch": "mamba2-780m", "shape": "prefill_32k",
                 "multi_pod": False, "status": "error",
                 "error": "NotImplementedError('serving cells wait for the "
                          "ROADMAP item, a long message that is cut')"})
    return recs


def _hillclimb(path):
    rows = []
    for name, c, m, x in (("h1.0-baseline", 1.0, 2.0, 8.0),
                          ("h1.1-no-fsdp", 1.0, 1.5, 2.0),
                          ("h1.5-bf16-comms", 0.8, 1.5, 1.99),
                          ("h3.0-dense-ffn-ref", 1.0, 1.5, 2.0),
                          ("h3.1-rgcsr-ffn-d25", 0.85, 1.9, 2.0)):
        rows.append({"iter": name, "status": "ok", "hypothesis":
                     f"{name}: a | hypothesis", "model_flops_ratio": 0.5,
                     "roofline": {"compute_s": c, "memory_s": m,
                                  "collective_s": x}})
    rows.append({"iter": "h2.0-baseline", "status": "error",
                 "hypothesis": "GShard dispatch", "error":
                 "NotImplementedError('serving')"})
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")


def test_roofline_and_report_tables_are_the_reference_s(tmp_path):
    recs = _records()
    for mp in (False, True):
        assert roofline.render_table(recs, mp) == \
            ref_roofline.render_table(recs, mp)
    path = tmp_path / "dry.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs + recs[:1]))
    assert roofline.load_records(str(path)) == \
        ref_roofline.load_records(str(path))
    hill = tmp_path / "hill.jsonl"
    _hillclimb(hill)
    for p in (str(hill), str(tmp_path / "missing.jsonl")):
        assert report.perf_log_table(p) == ref_report.perf_log_table(p)
        assert report.perf_summary(p) == ref_report.perf_summary(p)
    md = tmp_path / "notes.md"
    md.write_text("# notes\n<!-- ROOFLINE_TABLE -->\n<!-- PERF_LOG -->\n"
                  "<!-- PERF_SUMMARY -->\n")
    report.main([str(md), str(path), "--hillclimb", str(hill)])
    text = md.read_text()
    assert ref_roofline.render_table(recs, True) in text
    assert ref_report.perf_log_table(str(hill)) in text
    assert "<!--" not in text


def test_the_hill_climb_records_h2_as_errors(tmp_path, monkeypatch):
    """Every iteration of H1–H3 is recorded with its hypothesis; H2's
    serving cells go through the real ``run_cell`` (at smoke width and a
    cut prefill shape, on the production 16 × 16 mesh) and are recorded
    ``ok``; the report renders the records.  (Named for what it held
    before the serving cells ran: H2 recorded as errors.)"""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import hillclimb

    def smoke(arch):
        # the published 256 experts (8 a token), which the serving rules
        # spread over the 16 × 16 mesh, one a rank
        cfg = get_smoke(arch)
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=256, top_k=8))
    monkeypatch.setattr(dryrun, "get_config", smoke)
    monkeypatch.setattr(dryrun, "SHAPES", {
        "prefill_32k": ShapeConfig("prefill_32k", 32, 32, "prefill")})

    def run_cell(arch, shape, **kw):
        if shape == "prefill_32k":
            return dryrun.run_cell(arch, shape, **kw)
        return {"roofline": {"compute_s": 1.0, "memory_s": 2.0,
                             "collective_s": 0.5},
                "model_flops_ratio": 0.5, "kw": sorted(kw)}
    monkeypatch.setattr(hillclimb, "run_cell", run_cell)
    out = tmp_path / "results" / "hill.jsonl"
    hillclimb.main(["--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    names = [it["name"] for it in hillclimb.H1 + hillclimb.H2 + hillclimb.H3]
    assert [r["iter"] for r in recs] == names
    assert all(r["status"] == "ok" and r["hypothesis"] for r in recs)
    h2 = {r["iter"]: r for r in recs if r["iter"].startswith("h2")}
    assert len(h2) == 3 and not dist.is_initialized()
    for r in h2.values():
        assert r["arch"] == "deepseek-v3-671b" and r["mesh"] == [16, 16]
        assert all(0 <= v < float("inf") for v in r["roofline"].values())
    # a prefill routes dropless: past _DROPLESS_EINSUM_BUDGET the einsum
    # dispatch reroutes to the scatter one, and no capacity applies, so
    # the three iterations run one step (as the reference's would)
    assert len({r["cost"]["flops"] for r in h2.values()}) == 1
    assert "ERROR" not in report.perf_log_table(str(out))
    assert report.perf_log_table(str(out)) == \
        ref_report.perf_log_table(str(out))


# ------------------------------------------------------------ FLOP counts


def test_a_product_counts_2mkn_and_a_loop_its_trips():
    m, k, n = 48, 80, 24
    x = torch.empty(m, k, device="meta", dtype=torch.bfloat16)
    w = torch.empty(k, n, device="meta", dtype=torch.bfloat16)
    assert analyze_hlo(lambda: torch.tanh(x @ w), 1).flops == 2 * m * k * n
    sq = torch.empty(k, k, device="meta")

    def ten(h=torch.empty(m, k, device="meta")):
        for _ in range(10):
            h = torch.tanh(h @ sq)
    cost = analyze_hlo(ten, 1)
    assert cost.flops == 10 * 2 * m * k * k
    assert cost.flops_by_dtype == {"float32": cost.flops}
    assert cost.loops == {} and cost.collective_bytes_f32_dot == 0


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_flops_are_the_reference_s_hlo_count(kind):
    """The reference's count of a jitted smoke prefill (8 × 32 tokens) or
    decode step (8 rows against caches of 32 positions; dense granite)
    against the port's one-device meta step, within 1 %."""
    rcfg = ref_get_smoke("granite-3-2b")
    model = RefModel(rcfg)
    params = model.abstract_params()
    shape = RefShape("s", 32, 8, kind)
    batch = ref_input_specs(rcfg, shape)
    if kind == "prefill":
        fn = jax.jit(ref_steps.make_prefill_step(model, 32, kind))
        lowered = fn.lower(params, batch)
    else:
        caches = jax.eval_shape(lambda: model.init_cache(8, 32,
                                                         shape_kind=kind))
        fn = jax.jit(ref_steps.make_decode_step(model, kind))
        lowered = fn.lower(params, caches, batch["tokens"])
    want = ref_analyze_hlo(lowered.compile().as_text(), 1)
    got = dryrun.serve_cost(get_smoke("granite-3-2b"), (1,), ("model",),
                            shape_kind=kind, seq=32, batch=8)["cost"]
    assert abs(got.flops - want.flops) <= 0.01 * want.flops, (
        f"port {got.flops:.4e} vs reference {want.flops:.4e}\n"
        f"port {sorted(got.dot_flops_by_shape.items())}\n"
        f"reference {sorted(want.dot_flops_by_shape.items())}")


@pytest.mark.parametrize("remat", ["none", "full"])
def test_flops_are_the_reference_s_hlo_count(remat):
    """The reference's loop-aware count of a jitted smoke train step
    (dense granite, micro 2) against the port's meta step, within 1 %."""
    rcfg = dataclasses.replace(ref_get_smoke("granite-3-2b"), remat=remat)
    model = RefModel(rcfg)
    fn, init = ref_steps.make_train_step(model, ref_opt.OptimizerConfig(), 2)
    params = model.abstract_params()
    compiled = jax.jit(fn).lower(
        params, jax.eval_shape(init, params),
        ref_input_specs(rcfg, RefShape("t", 32, 8, "train"))).compile()
    want = ref_analyze_hlo(compiled.as_text(), 1)
    cfg = dataclasses.replace(get_smoke("granite-3-2b"), remat=remat)
    got = dryrun.step_cost(cfg, (1,), ("model",), seq=32, batch=8,
                           microbatches=2, optimizer="adamw")["cost"]
    assert abs(got.flops - want.flops) <= 0.01 * want.flops, (
        f"port {got.flops:.4e} vs reference {want.flops:.4e}\n"
        f"port {sorted(got.dot_flops_by_shape.items())}\n"
        f"reference {sorted(want.dot_flops_by_shape.items())}")


def test_the_counter_is_flopcountermode_and_memtracker_s():
    """The dry run's one counting mode against torch's own tools on the
    same meta step: FLOPs against ``FlopCounterMode``'s products, the
    peak above the arguments against ``MemTracker``'s (module hooks off:
    the peak is the tracker's global one)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.hlo_cost import PRODUCTS
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import LanguageModel
    from repro_torch.train.optimizer import OptimizerConfig
    cfg = dataclasses.replace(get_smoke("granite-moe-1b-a400m"),
                              remat="full")

    def setup():
        model = LanguageModel(cfg, device="meta").requires_grad_(True)
        step, init = make_train_step(model, OptimizerConfig(), 2)
        params = model.tensors()
        opt = init(params)
        batch = input_specs(cfg, ShapeConfig("t", 32, 4, "train"))
        held = [*params.values(), *opt["m"].values(), *opt["v"].values(),
                opt["step"], *batch.values()]
        return (lambda: step(params, opt, batch)), held

    run, held = setup()
    got = analyze_hlo(run, 1, held=held)
    # one tool a run: FlopCounterMode's module hooks keep tensors alive
    # longer, which MemTracker would count
    run, held = setup()
    flops = FlopCounterMode(display=False)
    with flops:
        run()
    counts = flops.get_flop_counts()["Global"]
    assert got.flops == sum(v for op, v in counts.items() if op in PRODUCTS)
    run, held = setup()
    tracker = MemTracker()
    tracker.track_external(*held)
    with tracker:
        tracker._mod_tracker.clear_user_hooks()
        start = tracker.get_tracker_snapshot()[torch.device("meta")]["Total"]
        run()
    peak = tracker.get_tracker_snapshot("peak")[torch.device("meta")]
    assert got.temp_bytes == peak["Total"] - start > 0


# ------------------------------------------- fake (2, 2) against gloo


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("dryrun"), 4, dryrun_ranks)


@pytest.mark.parametrize("case", list(DRYRUN_CASES))
def test_fake_mesh_counts_what_gloo_ranks_run(case, gloo_ranks):
    res = dryrun.step_cost(dryrun_cfg(case), (2, 2), ("data", "model"),
                           seq=SEQ, batch=BATCH, microbatches=DRYRUN_MICRO,
                           optimizer="adamw")
    assert not dist.is_initialized()
    cost, want = res["cost"], gloo_ranks[0][case]
    assert cost.flops == want["flops"] > 0
    assert cost.flops_by_dtype == want["by_dtype"]
    got = collective_summary(cost)
    assert got == want["collectives"]
    assert {k.split()[1] for k in got} == {"data", "model"}
    assert res["roofline"]["compute_s"] > 0 and res["bottleneck"]


@pytest.mark.parametrize("case", list(DRYRUN_SERVE_CASES))
def test_fake_mesh_counts_what_gloo_ranks_serve(case, gloo_ranks):
    """A serving step on rank 0 of a fake (2, 2) mesh against rank 0 of
    the gloo ranks' same step: FLOPs, FLOPs by dtype and collective calls
    and bytes by kind and axis equal exactly."""
    _, _, kind, batch, seq = DRYRUN_SERVE_CASES[case]
    res = dryrun.serve_cost(dryrun_serve_cfg(case), (2, 2),
                            ("data", "model"), shape_kind=kind, seq=seq,
                            batch=batch)
    assert not dist.is_initialized()
    cost, want = res["cost"], gloo_ranks[0][case]
    assert cost.flops == want["flops"] > 0
    assert cost.flops_by_dtype == want["by_dtype"]
    assert collective_summary(cost) == want["collectives"]
    assert res["memory"]["alias_size_in_bytes"] > 0


# ---------------------------------------------------------------- cells


def test_run_cell_on_a_production_mesh_leaves_no_group(monkeypatch):
    """``run_cell`` of a 16 × 16 cell at smoke width (the config and the
    shape cut): the reference's record keys, finite positive terms, and
    no process group after it."""
    from repro_torch.configs.base import ShapeConfig
    monkeypatch.setattr(dryrun, "get_config", get_smoke)
    monkeypatch.setattr(dryrun, "SHAPES", {
        "train_4k": ShapeConfig("train_4k", 32, 32, "train"),
        "decode_32k": SHAPES["decode_32k"]})
    rec = dryrun.run_cell("granite-3-2b", "train_4k", keep_hlo=True)
    assert not dist.is_initialized()
    for key in ("n_params", "n_active_params", "microbatches", "memory",
                "cost", "roofline", "bottleneck", "model_flops_global",
                "model_flops_ratio"):
        assert key in rec, key
    assert rec["mesh"] == [16, 16] and rec["n_devices"] == 256
    assert rec["attn_shard_mode"] == "seq"      # 4 heads on 16 ranks
    assert all(0 < v < float("inf") for v in rec["roofline"].values())
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["collective_log"] and rec["cost"]["n_loops"] == 0
    json.dumps(rec)
    # a serving cell on the same mesh: its record, no microbatches
    rec = dryrun.run_cell("granite-3-2b", "decode_32k")
    assert not dist.is_initialized()
    assert "microbatches" not in rec and rec["n_devices"] == 256
    assert rec["model_flops_global"] == 2.0 * rec["n_active_params"] * 128
    assert all(0 < v < float("inf") for v in rec["roofline"].values())


SERVING_SHAPES = {"prefill_32k": (32, 4, "prefill"),
                  "decode_32k": (32, 8, "decode"),
                  "long_500k": (128, 1, "long_decode")}


@pytest.mark.parametrize("shape", list(SERVING_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_run_cell_records_a_serving_shape(arch, shape, monkeypatch):
    """``run_cell`` of each serving shape, cut to (seq, batch) of
    ``SERVING_SHAPES``, of every arch's smoke config on a fake (2, 2): the
    record's keys, the cache a rank among its arguments (aliased by its
    outputs), positive FLOPs and finite terms, the inference model
    FLOPs, and no process group after it."""
    from repro_torch.configs.base import ShapeConfig
    seq, batch, kind = SERVING_SHAPES[shape]
    monkeypatch.setattr(dryrun, "get_config", get_smoke)
    monkeypatch.setattr(dryrun, "SHAPES", {
        shape: ShapeConfig(shape, seq, batch, kind)})
    monkeypatch.setattr(dryrun, "PRODUCTION_MESHES", {
        False: ((2, 2), ("data", "model"))})
    rec = dryrun.run_cell(arch, shape)
    assert not dist.is_initialized()
    assert rec["mesh"] == [2, 2] and rec["n_devices"] == 4
    assert rec["param_dtype"] == "bfloat16"
    mem = rec["memory"]
    assert 0 < mem["alias_size_in_bytes"] < mem["argument_size_in_bytes"]
    assert rec["cost"]["flops"] > 0
    assert all(0 <= v < float("inf") for v in rec["roofline"].values())
    tokens = batch * (seq if kind == "prefill" else 1)
    assert rec["model_flops_global"] == \
        2.0 * rec["n_active_params"] * tokens
    json.dumps(rec)


def test_one_production_cell_in_a_subprocess():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-moe-1b-a400m", "--shape", "train_4k"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[dryrun] 1/1 cells OK"
