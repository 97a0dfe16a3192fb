"""Tensor-parallel compute over ``model`` in sharded training
(``cfg.act_shard`` on a mesh): head-split attention (``heads``,
``repeat``, ``seq``; MLA), split FFN and RgCSR lanes, expert-parallel
MoE, vocabulary-parallel embedding and loss, against the port's
single-device ``Trainer``.

One module-scoped spawn of four gloo ranks (``tests/_torch_dist.py``,
``tp_ranks``) trains every case of ``TP_CASES`` — granite-3-2b dense,
with the RgCSR FFN (also under remat ``full``) and on (1, 4) (``repeat``:
two kv heads), a six-head variant (``seq``), nemotron-4-15b (an untied,
column-parallel head), granite-moe (AdamW, also under remat ``dots``),
minicpm3-4b (MLA; six heads on (1, 4): MLA's ``seq``),
seamless-m4t-medium (cross attention; six heads: ``seq``), deepseek-v3
(Adafactor: MLA + MoE + MTP), mamba2-780m on (2, 2) and (1, 4) (its SSD
heads split) and recurrentgemma-9b (its RG-LRU channels split; its local
attention ``repeat``) — three steps of ``micro=2`` each, held within
rtol = atol = 1e-5 of one device (losses, ``grad_norm``, parameters, and
a MoE model's routing statistics after them).  A spy on the step's
parameter gathers shows that no parameter crosses the ``model`` group and
that each rank gathers micro × Σ numel / (the leaf's model shards)
elements a step.  In the same ranks each recurrent mixer, split, matches
itself whole (output and every gradient) on (2, 2) and (1, 4).  In
process: the port's ``resolve_attn_shard_mode`` is the reference's on
all ten configs, an explicit mode that does not divide raises, so does a
recurrent mixer whose heads or channels ``model`` does not divide, and
no module of the port redistributes a DTensor or imports functional
collectives.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_dist import (BATCH, MIXER_CASES, SEQ, TP_CASES, TP_MODES,
                         TP_SPIED, TP_STEPS, routing_stats, run_ranks,
                         tp_ranks, tp_trainer)

from repro.configs import get_config as ref_get_config
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import shardlib

torch.set_num_threads(1)

ARCHS = ["granite-3-2b", "granite-moe-1b-a400m", "deepseek-v3-671b",
         "minicpm3-4b", "mamba2-780m", "recurrentgemma-9b",
         "seamless-m4t-medium", "pixtral-12b", "nemotron-4-15b",
         "qwen1.5-32b"]
SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def _reference_resolver():
    """``repro.launch.dryrun.resolve_attn_shard_mode``, compiled from its
    source alone: importing that module sets ``XLA_FLAGS`` for 512 host
    devices, which every later JAX test of the process would see."""
    tree = ast.parse((SRC / "repro" / "launch" / "dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "resolve_attn_shard_mode")
    scope = {}
    exec(compile(ast.Module([fn], []), "dryrun.py", "exec"), scope)
    return scope["resolve_attn_shard_mode"]


@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_attn_shard_mode_is_the_reference_s(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    resolve = _reference_resolver()
    for model in (1, 2, 4, 8, 16):
        want = resolve(ref_cfg, model)
        assert shardlib.resolve_attn_shard_mode(cfg, model) == want
        assert shardlib.attn_mode_for(cfg, model) == want   # "none"


def test_an_explicit_mode_that_does_not_divide_raises():
    cfg = get_smoke("granite-3-2b")            # 4 heads, 2 kv heads
    ok = {("heads", 2), ("repeat", 4), ("seq", 4), ("seq", 3)}
    for mode, n in ok:
        c = dataclasses.replace(cfg, attn_shard_mode=mode)
        assert shardlib.attn_mode_for(c, n) == mode
    for mode, n, what in (("heads", 4, "2 kv heads"),
                          ("repeat", 8, "4 heads")):
        c = dataclasses.replace(cfg, attn_shard_mode=mode)
        with pytest.raises(ValueError, match=what):
            shardlib.attn_mode_for(c, n)
    mla = dataclasses.replace(get_smoke("minicpm3-4b"),
                              attn_shard_mode="heads")
    with pytest.raises(ValueError, match="4 heads"):
        shardlib.attn_mode_for(mla, 8)
    with pytest.raises(ValueError, match="unknown attn_shard_mode"):
        shardlib.attn_mode_for(dataclasses.replace(
            cfg, attn_shard_mode="rows"), 2)


def _plan_on(cfg, shape):
    """``LanguageModel.tensor_parallel_plan`` of ``cfg`` (on meta) on rank
    0 of a duck (data, model) mesh of ``shape``, its cuts the
    partitioner's."""
    import types
    from repro_torch.models import LanguageModel
    from repro_torch.sharding import Partitioner
    from repro_torch.sharding.partitioner import (TensorParallelView,
                                                  _flat_specs, _model_cut)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=shape)
    model = LanguageModel(cfg, device="meta")
    specs = _flat_specs(Partitioner(mesh, "train").param_specs(model.spec()))
    view = TensorParallelView(
        mesh=mesh, mesh_dim=1, size=shape[1], rank=0, group=None,
        batch_dims=(0,), cuts={k: _model_cut(s) for k, s in specs.items()})
    return model.tensor_parallel_plan(view)


@pytest.mark.parametrize("arch,over,what", [
    ("mamba2-780m", {}, None),
    ("recurrentgemma-9b", {}, None),
    # d_inner 96 in heads of 16
    ("mamba2-780m", {"d_model": 48}, "6 SSD heads do not divide"),
    ("recurrentgemma-9b", {"d_model": 66}, "rec .RG-LRU. block"),
])
def test_a_mixer_that_does_not_divide_raises(arch, over, what):
    """The recurrent mixers split on a model axis of 4 where it divides
    their SSD heads (Mamba-2) or ``d_rnn`` channels (RG-LRU), and the plan
    raises where it does not."""
    cfg = dataclasses.replace(get_smoke(arch), **over)
    if what is None:
        modes, classes = _plan_on(cfg, (1, 4))
        assert "split" in modes.values()
        assert classes["layers/0/" + ("mixer/in_proj/kernel"
                                      if arch == "mamba2-780m"
                                      else "rec/rg_w/kernel")] == "split"
        return
    with pytest.raises(ValueError, match=what):
        _plan_on(cfg, (1, 4))


def test_the_port_never_redistributes_a_dtensor():
    """No ``redistribute``, ``full_tensor`` or functional collective in any
    module of the port: its data moves through plain ``torch.distributed``
    calls (``sharding/layout.py``)."""
    found = []
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 40
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Attribute):
                names.append(node.attr)
            elif isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names += [node.module or ""] + [a.name for a in node.names]
            for name in names:
                if name in ("redistribute", "full_tensor") \
                        or "_functional_collectives" in name:
                    found.append(f"{path.relative_to(PORT)}:{node.lineno} "
                                 f"{name}")
    assert not found, found


def test_constrain_refuses_a_dtensor_and_passes_a_plain_tensor(tmp_path):
    from _torch_dist import one_rank
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import layout
    from torch.distributed.tensor import Replicate
    cfg = dataclasses.replace(get_smoke("granite-3-2b"), act_shard=True)
    x = torch.ones(2, 3)
    assert shardlib.constrain(cfg, x, "batch", None) is x
    with one_rank(tmp_path):
        mesh = make_mesh((1,), ("model",), device_type="cpu")
        dt = layout.from_local(x, mesh, (Replicate(),), x.shape)
        with pytest.raises(TypeError, match="never redistributes"):
            shardlib.constrain(cfg, dt, "batch", None)


# ------------------------------------------------ spawned (2, 2), (1, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("tp"), 4, tp_ranks)


def test_region_operators(ranks):
    """copy_in, reduce_out, gather_dim (slice and sum backward), split_dim,
    reduce_scatter_dim and all_reduce_max over the (2, 2) mesh's model
    group: each forward and backward as the operator promises, on every
    rank."""
    for res in ranks:
        reg = res["regions"]
        r, n, ops = reg["rank"], reg["n"], reg["ops"]
        base = lambda k: np.arange(6.0).reshape(2, 3) + 10 * k  # noqa
        ups = sum(1.0 + k for k in range(n))
        y, g = ops["copy_in"]
        np.testing.assert_array_equal(y, base(r))
        np.testing.assert_array_equal(g, np.full((2, 3), ups))
        y, g = ops["reduce_out"]
        np.testing.assert_array_equal(y, sum(base(k) for k in range(n)))
        np.testing.assert_array_equal(g, np.full((2, 3), 1.0 + r))
        whole = np.concatenate([base(k) for k in range(n)], axis=1)
        up = lambda k: np.arange(6.0 * n).reshape(2, 3 * n) + 100 * k  # noqa
        y, g = ops["gather_slice"]
        np.testing.assert_array_equal(y, whole)
        np.testing.assert_array_equal(g, up(r)[:, 3 * r:3 * r + 3])
        y, g = ops["gather_sum"]
        np.testing.assert_array_equal(y, whole)
        np.testing.assert_array_equal(
            g, sum(up(k) for k in range(n))[:, 3 * r:3 * r + 3])
        x = np.arange(4.0 * n).reshape(2, 2 * n)
        y, g = ops["split"]
        np.testing.assert_array_equal(y, x[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(g, np.concatenate(
            [np.full((2, 2), 1.0 + k) for k in range(n)], axis=1))
        x = lambda k: np.arange(4.0 * n).reshape(2, 2 * n) + 10 * k  # noqa
        y, g = ops["reduce_scatter"]
        np.testing.assert_array_equal(
            y, sum(x(k) for k in range(n))[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(g, np.concatenate(
            [np.arange(4.0).reshape(2, 2) + 100 * k for k in range(n)],
            axis=1))
        np.testing.assert_array_equal(ops["max"], base(n - 1))


@pytest.fixture(scope="module")
def single():
    """Each case on one device, here: its history, final parameters and
    (MoE) routing statistics on the first batch."""
    out = {}
    for case in TP_CASES:
        tr = tp_trainer(case, "cpu")
        state, _ = tr.run(tr.init_state(seq_len=SEQ, global_batch=BATCH))
        routing = routing_stats(tr, tr._batch(0)) \
            if tr.model_cfg.moe.n_experts else None
        out[case] = (tr.history, {k: t.detach().numpy()
                                  for k, t in state[0].items()}, routing)
    return out


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tensor_parallel_steps_match_one_device(ranks, single, case):
    history, params, routing = single[case]
    moe = routing is not None
    for res in ranks:
        got = res[case]
        assert got["mode"] == TP_MODES.get(case, "heads")
        assert "vocab" in got["units"]
        if moe:
            assert "experts" in got["units"]
        assert [h["step"] for h in got["history"]] == list(range(TP_STEPS))
        for g, w in zip(got["history"], history, strict=True):
            for k in ("loss", "ce", "grad_norm") + (("load_balance",)
                                                    if moe else ()):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                           atol=1e-5, err_msg=k)
        for k, want in (routing or {}).items():
            np.testing.assert_allclose(got["routing"][k], want, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    whole = ranks[0][case]["params"]
    assert len(whole) == len(params)
    for k, a in params.items():
        np.testing.assert_allclose(whole[f"params/{k}"], a, rtol=1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", TP_SPIED)
def test_each_rank_gathers_its_slices_not_wholes(ranks, case):
    """No parameter is all-gathered over the model group, and the elements
    of floating parameters a rank gathers are micro × Σ numel / (the
    leaf's model shards) a step, as the placements predict."""
    for res in ranks:
        got = res[case]
        assert got["on_model"] == []
        assert got["gathered"] == got["predicted"] > 0


@pytest.mark.parametrize("case,shape", MIXER_CASES)
def test_a_split_mixer_matches_itself_whole(ranks, case, shape):
    """Layer 0's mixer split over ``model`` against the same mixer whole,
    on every rank: the output, x's gradient and every leaf's gradient
    (the rank's slice of a cut leaf's), measured against the float64
    whole's largest value: the float64 split within 1e-12 (the same
    function), the float32 split within 1e-5 of the float32 whole's own
    rounding."""
    for res in ranks:
        gaps = res["mixers"][case, shape]
        assert len(gaps) >= 9
        bad = {k: v for k, v in gaps.items() if not (
            v["exact"] <= 1e-12 and v["split"] <= v["whole"] + 1e-5)}
        assert not bad, bad
        assert all(v["whole"] > 0 for v in gaps.values())
