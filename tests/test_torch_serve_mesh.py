"""Serving on a mesh: the port's prefill and decode steps tensor-parallel
on a ``DeviceMesh`` (``launch.steps.make_prefill_step`` /
``make_decode_step`` with ``partitioner=``) against its one-device
steps.

One spawn of four gloo ranks (``tests/_torch_dist.py``, ``serve_ranks``)
runs every ``SERVE_CASES`` case on its (2, 2) or (1, 4) mesh: the mesh
prefill and ``SERVE_STEPS`` decode steps fed the one-device greedy
tokens, and the same decode steps from the one-device prefill's caches
cut by ``Partitioner.local_caches``. Bars, in fp32: each rank's rows of
the logits within 1e-5 of the one-device rows, relative to ``1 +
max|logit|``; the greedy tokens equal; each rank's cache slices within
1e-5 of the one-device caches' slices, and gathered whole again
(``Partitioner.whole_caches``) within 1e-5 of the one-device caches. The
cases cover the attention modes (``heads``; ``repeat`` and ``seq`` with
the cache cut over head-dim), MLA with its latent cut over ``R``, the
``ssm`` and ``rec`` states, whole-mesh MoE (einsum and scatter
dispatch), ``long_decode``'s cache cut over the sequence at batch 1, and
the RgCSR FFN's lanes through K2's plain version on each rank's lane
plan (one plan a layer, held against the segment-sum lanes and the whole
layer). The refusals are the ranks' too. In process: the port's
one-device steps against ``repro.launch.steps``'.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import SERVE_CASES, run_ranks, serve_ranks

from repro.configs import get_smoke as ref_get_smoke
from repro.launch import steps as ref_steps
from repro.models import LanguageModel as RefModel
from repro_torch.configs import get_smoke
from repro_torch.launch import steps
from repro_torch.models import LanguageModel, params_from_numpy

torch.set_num_threads(1)

TOL = 1e-5
# the attention mode each case resolves (mamba2's smoke config has one
# attention head: seq, which no layer of it reads)
MODES = {"granite-3-2b/1x4": "repeat", "granite-3-2b/seq": "seq",
         "minicpm3-4b/6heads": "seq", "recurrentgemma-9b": "repeat",
         "mamba2-780m": "seq", "seamless-m4t-medium/1x4": "repeat"}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("serve"), 4, serve_ranks)


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_mesh_steps_match_one_device(case, ranks):
    arch, sparse, _, _, _ = SERVE_CASES[case]
    for r, out in enumerate(ranks):
        res = out[case]
        assert res["mode"] == MODES.get(case, "heads"), (r, res["mode"])
        # the prefill, the decode steps from it, the decode steps from the
        # one-device prefill's caches cut into slices
        assert len(res["logits"]) == 1 + 2 * 3
        assert max(res["logits"]) <= TOL, (r, res["logits"])
        assert all(res["tokens"])
        assert max(res["caches"]) <= TOL, (r, res["caches"])
        assert res["whole"][0] and res["whole"][1] <= TOL, res["whole"]
        if sparse:
            # one K2 lane plan a layer, kept across the prefill and steps
            assert res["lane_plans"] and set(res["lane_plans"]) == {1}
            assert res["lanes"]["kernel"] <= TOL
            assert res["lanes"]["ref"] <= TOL
        if arch in ("deepseek-v3-671b", "granite-moe-1b-a400m"):
            assert "('mesh_experts', (0, 1))" in res["units"]


def test_the_refusals(ranks):
    for out in ranks:
        msg = out["raises"]
        assert "do not divide over a model axis of 4" in msg["mode"]
        assert "not a multiple of K2's 32-lane segment" in msg["lanes"]
        assert "paged caches serve on one device" in msg["paged"]
        assert "act_shard" in msg["act_shard"]


def test_one_device_steps_are_the_reference_s():
    """The port's one-device ``make_prefill_step`` / ``make_decode_step``
    against ``repro.launch.steps``' on the same smoke inputs and
    parameters: a prefill and three greedy steps, fp32."""
    cfg_r = dataclasses.replace(ref_get_smoke("granite-3-2b"),
                                dtype="float32", kv_cache_dtype="float32")
    cfg = dataclasses.replace(get_smoke("granite-3-2b"), dtype="float32",
                              kv_cache_dtype="float32")
    ref_model = RefModel(cfg_r)
    params = ref_model.init(jax.random.PRNGKey(0))
    model = LanguageModel(cfg, params_from_numpy(
        cfg, jax.device_get(params), device="cpu"))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 8)).astype(
        np.int32)
    ref_prefill = jax.jit(ref_steps.make_prefill_step(ref_model, 16))
    ref_decode = jax.jit(ref_steps.make_decode_step(ref_model))
    want, caches_r = ref_prefill(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, caches = steps.make_prefill_step(model, 16)(
            {"tokens": torch.from_numpy(toks)})
        decode = steps.make_decode_step(model)
        for _ in range(4):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)
            tok = np.array(jnp.argmax(want[:, -1], -1), np.int32)[:, None]
            assert np.array_equal(got[:, -1].argmax(-1).numpy(), tok[:, 0])
            want, caches_r = ref_decode(params, caches_r, jnp.asarray(tok))
            got, caches = decode(caches, torch.from_numpy(tok))
