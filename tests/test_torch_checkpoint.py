"""The port's step checkpoints (``train/checkpoint.py``): the reference's
cases of ``test_train.py``, and checkpoints written by either package read
by the other — a smoke granite-3-2b parameter tree saved by the reference
and restored into a port model gives the reference's logits, and a port
tree saved by the port comes back equal through the reference; the same
for the MoE, MLA and MTP families' trees."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import model_inputs
from _torch_serving import pair
from repro.models import LanguageModel as RefModel
from repro.train import checkpoint as ref_checkpoint
from repro_torch.models import LanguageModel, params_from_numpy
from repro_torch.train import checkpoint
from repro_torch.train.checkpoint import (CheckpointManager, latest_step,
                                          restore, save)

torch.set_num_threads(1)


# ------------------------------------------------- test_train.py's cases


@pytest.mark.parametrize("leaf", [np.asarray, torch.from_numpy])
def test_checkpoint_roundtrip_and_latest(tmp_path, leaf):
    tree = {"a": leaf(np.arange(6, dtype=np.float32).reshape(2, 3)),
            "b": {"c": leaf(np.asarray(7, np.int32))}}
    d = str(tmp_path)
    save(d, 5, tree)
    save(d, 9, {"a": tree["a"] + 1, "b": {"c": tree["b"]["c"] + 1}})
    assert latest_step(d) == 9
    restored, manifest = restore(d, tree)
    assert isinstance(restored["a"], np.ndarray)
    np.testing.assert_array_equal(restored["a"], np.asarray(tree["a"]) + 1)
    np.testing.assert_array_equal(restored["b"]["c"], 8)
    assert manifest["keys"] == ["a", "b/c"]
    restored5, _ = restore(d, tree, step=5)
    np.testing.assert_array_equal(restored5["a"], np.asarray(tree["a"]))


def test_checkpoint_structure_mismatch_detected(tmp_path):
    save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError):
        restore(str(tmp_path), {"b": torch.zeros(3)})


def test_checkpoint_manager_retention_and_async(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2, async_write=True)
    for s in (1, 2, 3, 4):
        x = torch.full((4,), float(s))
        mgr.save(s, {"x": x})
        x.fill_(-1.0)                  # after the hand-off: not written
    mgr.wait()
    steps = sorted(int(p.split("_")[1]) for p in os.listdir(d)
                   if p.startswith("step_"))
    assert steps == [3, 4]
    np.testing.assert_array_equal(restore(d, {"x": 0})[0]["x"],
                                  np.full(4, 4.0, np.float32))


def test_sharded_restore_and_bfloat16_are_refused(tmp_path):
    """A shardings tree that does not mirror the checkpoint's is refused
    (sharded restores themselves: ``test_torch_sharded_train.py``)."""
    save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shardings tree mismatch"):
        checkpoint.restore_sharded(str(tmp_path), {"a": 0}, shardings={})
    with pytest.raises(ValueError, match="shardings tree mismatch"):
        CheckpointManager(str(tmp_path)).restore_latest(
            {"a": 0}, shardings={"a": None})
    with pytest.raises(TypeError, match="bfloat16"):
        save(str(tmp_path), 2, {"a": torch.zeros(3, dtype=torch.bfloat16)})


# ---------------------------------------------------- across the packages


def test_a_reference_checkpoint_serves_in_the_port(tmp_path):
    """The reference saves smoke granite-3-2b's parameters (its layout:
    body layers stacked); the port restores them as numpy, carries them
    into a model with ``params_from_numpy``, and its logits are the
    reference's."""
    ref_cfg, ref_params, cfg, tree = pair()
    d = str(tmp_path)
    ref_checkpoint.save(d, 3, ref_params, extra={"arch": cfg.name})
    host = jax.device_get(ref_params)
    restored, manifest = restore(d, host)
    assert manifest["step"] == 3 and manifest["extra"] == {"arch": cfg.name}
    flat = jax.tree_util.tree_leaves(host)
    assert len(manifest["keys"]) == len(flat)
    for got, want in zip(jax.tree_util.tree_leaves(restored), flat):
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
    model = LanguageModel(cfg, params_from_numpy(cfg, restored,
                                                 device="cpu"))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)).astype(
        np.int32)
    with torch.inference_mode():
        got = model({"tokens": torch.from_numpy(toks)})[0]
    want = RefModel(ref_cfg).forward(ref_params,
                                     {"tokens": jnp.asarray(toks)})[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port saves its own parameter tree (one subtree per layer, the
    RgCSR FFN's slot arrays among the leaves); the reference restores
    equal arrays under the same keys."""
    _, _, _, tree = pair(sparse=True)
    d = str(tmp_path)
    save(d, 7, tree)
    like = jax.tree_util.tree_map(lambda t: t.numpy(), tree)
    restored, manifest = ref_checkpoint.restore(d, like)
    keys, leaves = checkpoint._flatten_with_keys(tree)
    assert manifest["keys"] == keys
    assert "layers/1/ffn/w_out/values2d" in keys
    got = jax.tree_util.tree_leaves(restored)
    assert len(got) == len(leaves)
    for g, t in zip(got, leaves):
        assert g.dtype == t.numpy().dtype
        np.testing.assert_array_equal(g, t.numpy())
    again, _ = restore(d, tree)
    assert again.keys() == tree.keys()
    assert len(again["layers"]) == len(tree["layers"])


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "minicpm3-4b",
                                  "deepseek-v3-671b", "mamba2-780m",
                                  "recurrentgemma-9b", "seamless-m4t-medium",
                                  "pixtral-12b"])
def test_family_checkpoints_cross_both_ways(tmp_path, arch):
    """The reference's tree (stacked experts, the router's bias, MLA's
    projections, the MTP subtree, the ``mixer`` and ``rec`` subtrees of
    the recurrent layers, the stacked encoder, ``enc_norm`` and
    ``frontend_proj``) saved by the reference serves in the
    port with its logits; the port's tensors in the reference's layout
    (``reference_layout``) saved by the port restore in the reference
    equal to its own tree."""
    from repro_torch.models.model import reference_layout
    ref_cfg, ref_params, cfg, _ = pair(arch=arch)
    host = jax.device_get(ref_params)
    ref_checkpoint.save(str(tmp_path / "ref"), 1, ref_params)
    restored, _ = restore(str(tmp_path / "ref"), host)
    model = LanguageModel(cfg, params_from_numpy(cfg, restored,
                                                 device="cpu"))
    batch = model_inputs(cfg, 1, s=10)
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})[0]
    want = RefModel(ref_cfg).forward(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    tree = reference_layout(cfg, {k: t.numpy()
                                  for k, t in model.tensors().items()})
    save(str(tmp_path / "port"), 2, tree)
    back, manifest = ref_checkpoint.restore(str(tmp_path / "port"), host)
    assert manifest["keys"] == checkpoint._flatten_with_keys(host)[0]
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(host)):
        np.testing.assert_array_equal(g, w)
