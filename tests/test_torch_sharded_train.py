"""Sharded training (the partitioner's training half, ``shardlib``,
``Trainer(mesh=, partitioner=)``, ``launch/train.py --mesh``,
``restore_sharded``, MoE on a mesh) against the reference and the port's
one device.

In process: the port's specs equal ``repro.sharding.Partitioner``'s leaf
by leaf, the reference's stacked ``layers`` dim dropped, on duck meshes of
(2, 4), (1, 8), (2, 2) and (2, 2, 2) (the reference's ``_leaf_spec`` reads
only the mesh's shape and axis names; its ``_named`` is patched on the
test's own instance to return the spec).  Across spawned gloo ranks
(``tests/_torch_dist.py``): a (2, 2) mesh trains smoke granite-3-2b with
the RgCSR FFN, three steps of ``micro=2``, under AdamW and Adafactor,
held within rtol = atol = 1e-5 (losses, ``grad_norm``, parameters) of the
port's single-device ``Trainer`` in this process; each rank holds its
placements' slices; the launcher's ``--mesh`` ends in its ``done:`` line;
a checkpoint of the reference's ``save`` and one of the (2, 2) trainer
restore bitwise onto (1, 4) and onto two ranks; two steps each of MLA,
the recurrent families, the encoder-decoder and the vision frontend
match one device within 1e-5, and so do three steps of granite-moe
(AdamW, also under remat "dots") and deepseek-v3 (Adafactor), whose
routing takes the whole microbatch's capacity, positions and aux terms;
deepseek-v3's checkpoint restores bitwise onto the other meshes.  The
reference's own multi-device step is red (ROADMAP queue 3) and is no
oracle here.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from _torch_dist import (BATCH, FAMILIES, MOE_CASES, SEQ, family_trainer,
                         fault_drill, moe_trainer, restore_ranks,
                         routing_stats, run_ranks, sharded_cfg, train_config,
                         train_ranks)

import jax.numpy as jnp
from repro.configs import get_smoke as ref_get_smoke
from repro.configs.base import SparsityConfig as RefSparsityConfig
from repro.models import LanguageModel as RefModel
from repro.models import shardlib as ref_shardlib
from repro.models.spec import P as RefP
from repro.sharding import partitioner as ref_part
from repro.train import checkpoint as ref_checkpoint
from repro_torch.configs import get_smoke
from repro_torch.configs.base import SparsityConfig
from repro_torch.models import LanguageModel, shardlib
from repro_torch.models.model import _layer_places, _stacks, model_spec
from repro_torch.models.spec import P
from repro_torch.sharding import NamedSharding, Partitioner
from repro_torch.train.trainer import Trainer

torch.set_num_threads(1)

MESHES = [((2, 4), ("data", "model")), ((1, 8), ("data", "model")),
          ((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
KINDS = ("train", "decode", "prefill", "long_decode")
SPARSE = dict(enabled=True, density=0.25, group_size=128, impl="ref")
ARCHS = [("granite-3-2b", False), ("granite-3-2b", True),
         ("minicpm3-4b", False), ("mamba2-780m", False),
         ("seamless-m4t-medium", False), ("granite-moe-1b-a400m", False),
         ("deepseek-v3-671b", False)]


def _meshes(shape, axes):
    """(the port's duck mesh, the reference's) of one shape."""
    return (types.SimpleNamespace(mesh_dim_names=axes, shape=shape),
            types.SimpleNamespace(axis_names=axes,
                                  shape=dict(zip(axes, shape))))


def _parts(shape, axes, kind):
    mesh, ref_mesh = _meshes(shape, axes)
    ref = ref_part.Partitioner(ref_mesh, kind)
    ref._named = lambda spec: tuple(spec)
    return Partitioner(mesh, kind), ref


def _cfgs(arch, sparse):
    ref_cfg, cfg = ref_get_smoke(arch), get_smoke(arch)
    if sparse:
        ref_cfg = dataclasses.replace(ref_cfg,
                                      sparsity=RefSparsityConfig(**SPARSE))
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(**SPARSE))
    return ref_cfg, cfg


def _flat(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _ref_leaf(cfg, ref_tree, key):
    """The reference's leaf for the port's ``key`` and whether it is
    stacked (a leading ``layers`` dim)."""
    parts = key.split("/")
    roots = {port: (ref, scfg) for port, ref, scfg in _stacks(cfg)}
    if parts[0] in roots:
        ref, scfg = roots[parts[0]]
        path, r = _layer_places(scfg, ref)[int(parts[1])]
        parts = list(path) + parts[2:]
        stacked = r is not None
    else:
        stacked = False
    node = ref_tree
    for p in parts:
        node = node[p]
    return node, stacked


def _drop(spec, stacked):
    spec = tuple(spec)
    if stacked:
        assert spec[0] is None, spec
        return spec[1:]
    return spec


def _check_placements(mesh, spec, ndim):
    """``NamedSharding(mesh, spec).placements()``: ``Shard(d)`` exactly
    on the mesh dims that the spec names for dim ``d``."""
    from torch.distributed.tensor import Replicate, Shard
    pl = NamedSharding(mesh, spec).placements()
    names = mesh.mesh_dim_names
    want = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                want[names.index(a)] = Shard(d)
    assert list(pl) == want and len(spec) == ndim


# --------------------------------------------------------- the rule tables


def test_partitioner_rules_resolve_like_the_reference():
    """The four cases of the reference's ``test_partitioner_rules_resolve``
    on a (2, 4) mesh, both packages, and their placements."""
    train, ref = _parts((2, 4), ("data", "model"), "train")
    cases = [((16, 8), ("embed", "mlp"), ("data", "model")),
             ((15, 9), ("embed", "mlp"), (None, None)),
             ((8, 8), ("mlp", "mlp2"), ("model", None))]
    for shape, axes, want in cases:
        got = train._leaf_spec(P(shape, axes))
        assert got == want == tuple(ref._leaf_spec(RefP(shape, axes)))
        _check_placements(train.mesh, got, len(shape))
    decode, ref_decode = _parts((2, 4), ("data", "model"), "decode")
    p = ((8, 4, 4), ("experts", "embed", "mlp"))
    got = decode._leaf_spec(P(*p))
    assert got[0] == ("data", "model")
    assert got == tuple(ref_decode._leaf_spec(RefP(*p)))
    from torch.distributed.tensor import Shard
    assert NamedSharding(decode.mesh, got).placements() == (Shard(0),
                                                            Shard(0))


def test_tuple_axes_out_of_mesh_order_are_refused():
    mesh, _ = _meshes((2, 4), ("data", "model"))
    with pytest.raises(ValueError, match="mesh's axis order"):
        NamedSharding(mesh, (("model", "data"),)).placements()


@pytest.mark.parametrize("arch,sparse", ARCHS)
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_param_specs_match_the_reference(arch, sparse, kind):
    ref_cfg, cfg = _cfgs(arch, sparse)
    ref_spec, spec = RefModel(ref_cfg).spec(), model_spec(cfg)
    for shape, axes in MESHES:
        port, ref = _parts(shape, axes, kind)
        want_tree = ref.param_shardings(ref_spec)
        got = _flat(port.param_specs(spec))
        named = _flat(port.param_shardings(spec))
        leaves = _flat(spec)
        assert got.keys() == leaves.keys() == named.keys()
        for key, s in got.items():
            want, stacked = _ref_leaf(cfg, want_tree, key)
            assert s == _drop(want, stacked), (shape, key)
            assert named[key].spec == s and named[key].mesh is port.mesh
            _check_placements(port.mesh, s, len(leaves[key].shape))


@pytest.mark.parametrize("arch,sparse", ARCHS)
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_opt_shardings_match_the_reference(arch, sparse, opt):
    """Layers dim dropped.  Adafactor: the port factors each layer's own
    tensor, so a 1-D per-layer leaf (stacked 2-D in the reference) keeps a
    replicated ``v``; an integer buffer keeps its 0-d placeholder, where
    the reference's table factors it (its ``init`` does not)."""
    ref_cfg, cfg = _cfgs(arch, sparse)
    ref_spec = RefModel(ref_cfg).spec()
    spec = model_spec(cfg)
    leaves = _flat(spec)
    for shape, axes in MESHES:
        port, ref = _parts(shape, axes, "train")
        want = ref.opt_shardings(ref_spec, opt)
        got = port.opt_shardings(spec, opt)
        assert got.keys() == want.keys()
        assert got["step"].spec == tuple(want["step"]) == ()
        for name in got:
            if name == "step":
                continue
            flat = {k: v for k, v in _flat(got[name]).items()}
            for key, sh in flat.items():
                pkey = key.rsplit("/", 1)[0] if opt == "adafactor" else key
                leaf = leaves[pkey]
                ref_node, stacked = _ref_leaf(cfg, want[name], pkey)
                integer = leaf.dtype is not None \
                    and not leaf.dtype.is_floating_point
                if opt == "adamw":
                    exp = () if integer else _drop(ref_node, stacked)
                    assert sh.spec == exp, (shape, key)
                    continue
                sub = key.rsplit("/", 1)[1]
                if integer or len(leaf.shape) < 2:
                    assert sub == "v" and sh.spec == (), key
                    if integer and len(leaf.shape) >= 2:
                        assert set(ref_node) == {"vr", "vc"}
                    elif stacked:
                        assert set(ref_node) == {"vr", "vc"}
                    continue
                assert sh.spec == _drop(ref_node[sub], stacked), (shape, key)


@pytest.mark.parametrize("shape,axes", MESHES)
def test_batch_logits_and_replicated_match_the_reference(shape, axes):
    port, ref = _parts(shape, axes, "train")
    for b in (1, 2, 4, 6, 8, 16):
        batch = {"tokens": np.zeros((b, 5), np.int32),
                 "frames": np.zeros((b, 5, 3), np.float32),
                 "n": np.zeros((b,), np.int32)}
        want = ref.batch_shardings(batch)
        got = port.batch_shardings(batch)
        for k in batch:
            assert got[k].spec == tuple(want[k]), (b, k)
            _check_placements(port.mesh, got[k].spec, batch[k].ndim)
        assert port.logits_sharding(b).spec == tuple(ref.logits_sharding(b))
    assert port.replicated().spec == tuple(ref.replicated()) == ()


CACHE_SHAPES = {"k": (8, 16, 4, 8), "v": (8, 16, 2, 8), "ck": (4, 12, 4, 8),
                "cv": (2, 16, 8, 6), "k_scale": (8, 16, 4, 1),
                "ckv": (8, 16, 32), "krope": (2, 32, 8),
                "ssm": (8, 4, 16, 8), "conv": (8, 3, 32), "h": (8, 64),
                "index": (8,), "block_table": (8, 4), "other": (8, 3)}


@pytest.mark.parametrize("kind", KINDS)
def test_cache_shardings_match_the_reference(kind):
    for shape, axes in MESHES:
        port, ref = _parts(shape, axes, kind)
        for name, s in CACHE_SHAPES.items():
            flat = np.zeros(s, np.float32)
            got = port._cache_leaf_spec(name, flat, False)
            assert got == tuple(ref._cache_leaf_spec(name, flat, False))
            stacked = np.zeros((3,) + s, np.float32)
            assert port._cache_leaf_spec(name, stacked, True) == tuple(
                ref._cache_leaf_spec(name, stacked, True)) == (None,) + got
            _check_placements(port.mesh, got, len(s))
        for arch in ("granite-3-2b", "minicpm3-4b", "mamba2-780m",
                     "seamless-m4t-medium"):
            model = LanguageModel(get_smoke(arch), device="cpu")
            caches = model.init_cache(8, 16, enc_len=12 if
                                      model.cfg.enc_dec else 0)
            tree = port.cache_shardings(caches)
            for key, sh in _flat(tree).items():
                leaf = _flat(caches)[key]
                name = key.rsplit("/", 1)[1]
                assert sh.spec == tuple(ref._cache_leaf_spec(
                    name, leaf, False)), (arch, key)


# --------------------------------------------------------------- shardlib


def test_shardlib_is_the_reference_s_on_plain_tensors():
    """``constrain`` never changes a value: the identity on a plain tensor
    (the reference's hint outside a mesh is a no-op too); ``repeat``
    repeats k/v as ``jnp.repeat``; an unknown mode raises in both."""
    cfg = dataclasses.replace(get_smoke("granite-3-2b"), act_shard=True,
                              mesh_batch_axes=("data",))
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 5, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 5, 2, 8)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    assert shardlib.constrain(cfg, tq, "batch", None, "model", None) is tq
    assert shardlib.batch_axes(cfg) == ref_shardlib.batch_axes(cfg) \
        == ("data",)
    for mode in ("none", "heads", "seq", "repeat"):
        c = dataclasses.replace(cfg, attn_shard_mode=mode)
        got = shardlib.shard_attn_qkv(c, tq, tk, tv)
        want = (q, k, v) if mode != "repeat" else \
            (q, np.asarray(jnp.repeat(k, 2, axis=2)),
             np.asarray(jnp.repeat(v, 2, axis=2)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    bad = dataclasses.replace(cfg, attn_shard_mode="rows")
    with pytest.raises(ValueError, match="unknown attn_shard_mode"):
        shardlib.shard_attn_qkv(bad, tq, tk, tv)
    with pytest.raises(ValueError, match="unknown attn_shard_mode"):
        ref_shardlib.shard_attn_qkv(bad, jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v))


@pytest.mark.parametrize("mode", ["heads", "repeat", "seq"])
def test_act_shard_leaves_the_loss_as_it_is(mode):
    """The model under ``act_shard`` (every strategy) on plain tensors:
    the same loss as without it."""
    cfg = sharded_cfg()
    model = LanguageModel(cfg, device="cpu")
    hinted = LanguageModel(dataclasses.replace(
        cfg, act_shard=True, attn_shard_mode=mode), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _make_batch(cfg, 0).items()}
    torch.testing.assert_close(hinted.loss(batch)[0], model.loss(batch)[0],
                               rtol=1e-6, atol=1e-6)


def _make_batch(cfg, step):
    from repro_torch.train.data import DataConfig, make_batch
    return make_batch(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                 global_batch=BATCH, seed=0), step)


def test_token_totals_split_a_masked_loss_by_tokens():
    """Parts of a batch whose labels are partly masked: their losses
    under the whole batch's ``token_totals`` sum to the whole loss (a
    mean of the parts' means would not)."""
    cfg = sharded_cfg()
    model = LanguageModel(cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _make_batch(cfg, 1).items()}
    batch["labels"][0, :10] = -1
    batch["labels"][5, 3:] = -1
    whole, _ = model.loss(batch)
    totals = model.token_totals(batch)
    assert totals == {"ce": float((batch["labels"] >= 0).sum())}
    parts = [model.loss({k: v[i:i + 4] for k, v in batch.items()},
                        token_totals=totals)[0] for i in (0, 4)]
    torch.testing.assert_close(sum(parts), whole, rtol=1e-6, atol=1e-6)
    means = [model.loss({k: v[i:i + 4] for k, v in batch.items()})[0]
             for i in (0, 4)]
    assert abs(float(sum(means) / 2 - whole)) > 1e-3


# ---------------------------------------------------- spawned (2, 2) ranks


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Four gloo ranks on a (2, 2) mesh (``_torch_dist.train_ranks``) and
    the port's single-device trainer on the same configs, here."""
    tmp = tmp_path_factory.mktemp("sharded_train")
    ranks = run_ranks(tmp, 4, train_ranks, str(tmp / "ckpt"), (2, 2),
                      ("data", "model"))
    single = {}
    for opt in ("adamw", "adafactor"):
        tr = Trainer(sharded_cfg(), train_config(opt), device="cpu")
        state = tr.init_state(seq_len=SEQ, global_batch=BATCH)
        state, _ = tr.run(state)
        single[opt] = (tr.history, {k: t.detach().numpy()
                                    for k, t in state[0].items()}, state)
    return ranks, single, tmp


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_sharded_steps_match_one_device(trained, opt):
    ranks, single, _ = trained
    history, params, _ = single[opt]
    for res in ranks:
        got = res[opt]["history"]
        assert [h["step"] for h in got] == [0, 1, 2]
        for g, w in zip(got, history, strict=True):
            for k in ("loss", "ce", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5,
                                           err_msg=k)
    whole = ranks[0][opt]["whole"]
    for k, a in params.items():
        np.testing.assert_allclose(whole[f"params/{k}"], a, rtol=1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_each_rank_holds_its_slices(trained, opt):
    """Every parameter and moment is a DTensor whose local shape is the
    whole shape cut by its placements' shard counts; the ranks' slices of
    the embedding table tile it."""
    ranks, single, _ = trained
    whole = ranks[0][opt]["whole"]
    sharded = 0
    for res in ranks:
        for key, (local, placements) in res[opt]["local"].items():
            shape = whole[key].shape
            cut = list(shape)
            for mesh_dim, pl in enumerate(placements):
                if pl.startswith("S("):
                    d = int(pl[2:-1])
                    cut[d] //= 2
            assert tuple(cut) == local, key
            sharded += local != shape
    assert sharded > 0
    n_params = sum(1 for k in whole if k.startswith("params/"))
    assert sum(1 for k in ranks[0][opt]["local"]
               if k.startswith("params/")) == n_params


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_sharded_steps_of_the_other_families_match_one_device(trained, arch):
    """MLA, the recurrent families, the encoder-decoder and the vision
    frontend (frames and patches split with the rows): two AdamW steps
    on the (2, 2) mesh within 1e-5 of one device."""
    ranks, _, _ = trained
    tr = family_trainer(arch, "cpu")
    state, _ = tr.run(tr.init_state(seq_len=SEQ, global_batch=BATCH))
    for res in ranks:
        for g, w in zip(res["families"][arch]["history"], tr.history,
                        strict=True):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5,
                                           err_msg=k)
    whole = ranks[0]["families"][arch]["params"]
    assert len(whole) == len(state[0])
    for k, t in state[0].items():
        np.testing.assert_allclose(whole[f"params/{k}"], t.detach().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_fault_drill_restarts_on_the_mesh(trained, tmp_path):
    """The restart loop on the mesh: a fault at step 3 restores the step 2
    checkpoint (every rank, after the barrier) and replays, as on one
    device."""
    ranks, _, _ = trained
    want = fault_drill(sharded_cfg(), str(tmp_path / "drill"), "cpu")
    assert [s for s, _ in want] == [0, 1, 2, 3, 4]
    for res in ranks:
        assert [s for s, _ in res["drill"]] == [0, 1, 2, 3, 4]
        np.testing.assert_allclose([x for _, x in res["drill"]],
                                   [x for _, x in want], rtol=1e-5,
                                   atol=1e-5)


def test_launcher_mesh_ends_in_its_done_line(trained):
    """``--mesh 2x2`` with the RgCSR FFN, and with a MoE ``--arch``."""
    ranks, _, _ = trained
    last = ranks[0]["launcher"].strip().splitlines()[-1]
    assert last.startswith("done: 3 steps, final loss ")
    assert all(not r["launcher"] for r in ranks[1:])
    last = ranks[0]["launcher_moe"].strip().splitlines()[-1]
    assert last.startswith("done: 2 steps, final loss ")
    assert all(not r["launcher_moe"] for r in ranks[1:])


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_sharded_moe_steps_match_one_device(trained, case):
    """granite-moe-1b-a400m (AdamW) and deepseek-v3-671b (Adafactor), and
    granite-moe under remat "dots": three steps on the (2, 2) mesh, each
    rank routing its rows with the whole microbatch's capacity, positions
    and aux terms, within 1e-5 of one device — losses, the summed
    load-balance term, ``grad_norm``, parameters, and on the first batch
    the final model's expert fractions and load-balance and z-loss
    terms."""
    ranks, _, _ = trained
    tr = moe_trainer(case, "cpu")
    state, _ = tr.run(tr.init_state(seq_len=SEQ, global_batch=BATCH))
    routing = routing_stats(tr, tr._batch(0))
    assert routing["expert_fraction"].shape[1] == tr.model_cfg.moe.n_experts
    for res in ranks:
        got = res["moe"][case]
        assert [h["step"] for h in got["history"]] == [0, 1, 2]
        for g, w in zip(got["history"], tr.history, strict=True):
            for k in ("loss", "ce", "load_balance", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                           atol=1e-5, err_msg=k)
        for k, want in routing.items():
            np.testing.assert_allclose(got["routing"][k], want, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    whole = ranks[0]["moe"][case]["whole"]
    assert sum(k.startswith("params/") for k in whole) == len(state[0])
    for k, t in state[0].items():
        np.testing.assert_allclose(whole[f"params/{k}"], t.detach().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_tuple_axes_place_rows(trained):
    ranks, _, _ = trained
    for res in ranks:
        i, j = res["coord"]
        # ("data", "model") on one dim: data major, model minor
        assert res["tuple_rows"] == list(range(4 * (2 * i + j),
                                               4 * (2 * i + j) + 4))


# ------------------------------------------------------- elastic restores


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_ckpt")
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    ref_checkpoint.save(str(d), 1, {"w": w})
    return d, w


@pytest.mark.parametrize("world,shape,axes", [
    (4, (1, 4), ("data", "model")), (2, (2,), ("model",))])
def test_checkpoints_restore_bitwise_on_another_mesh(trained, ref_ckpt,
                                                     tmp_path, world, shape,
                                                     axes):
    """The reference's ``save`` of one (8, 8) array and the (2, 2)
    trainer's last AdamW checkpoint, restored onto another mesh: every
    value bitwise, each rank holding its new slice."""
    ranks, _, tmp = trained
    d, w = ref_ckpt
    got = run_ranks(tmp_path, world, restore_ranks, str(d),
                    str(tmp / "ckpt"), shape, axes)
    saved = ranks[0]["adamw"]["whole"]
    for rank, res in enumerate(got):
        np.testing.assert_array_equal(res["w"], w)
        np.testing.assert_array_equal(res["w2"], w)
        assert res["step"] == 1
        cols = 8 // world
        np.testing.assert_array_equal(
            res["w_local"], w[:, rank * cols:(rank + 1) * cols])
        assert res["next_step"] == 3
        for key, (local, placements) in res["local"].items():
            pieces = np.prod([shape[i] for i, p in enumerate(placements)
                              if p.startswith("S(")])
            assert np.prod(local) * pieces == np.prod(saved[key].shape), key
    restored = got[0]["whole"]
    assert restored.keys() == saved.keys()
    for key, a in saved.items():
        np.testing.assert_array_equal(restored[key], a, err_msg=key)
    # deepseek-v3's expert leaves and Adafactor's factored statistics
    saved = ranks[0]["moe"]["deepseek-v3-671b"]["whole"]
    restored = got[0]["moe"]["whole"]
    assert restored.keys() == saved.keys()
    assert any("experts" in k for k in saved)
    for key, a in saved.items():
        np.testing.assert_array_equal(restored[key], a, err_msg=key)
    for res in got:
        assert res["moe"]["next_step"] == 3
        for key, (local, placements) in res["moe"]["local"].items():
            pieces = np.prod([shape[i] for i, p in enumerate(placements)
                              if p.startswith("S(")])
            assert np.prod(local) * pieces == np.prod(saved[key].shape), key
