"""The port's LM stack and ``Engine.generate`` against the reference's, on
smoke configs (granite-3-2b and the other GQA families; granite-moe's MoE,
minicpm3's MLA with the RgCSR FFN, deepseek-v3's MLA + MoE + MTP;
mamba2's SSD stack and recurrentgemma's RG-LRU + local attention with the
RgCSR FFN), with
the reference's parameters carried across through ``params_from_numpy``.

Bars: fp32 logits within rtol = atol = 1e-4; bf16 logits within 3e-2 of
the largest reference logit (the frameworks round bf16 at other places);
greedy tokens identical at fp32.  The RgCSR FFN runs the reference's
Pallas path in interpret mode and the port's K2 plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.models import LanguageModel as RefModel
from repro.models import attention as ref_attention
from repro.serve import Engine as RefEngine, ServeConfig as RefServeConfig
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import SparsityConfig
from repro_torch.models import (LanguageModel, attention, model_spec,
                                params_from_numpy)
from repro_torch.models.spec import count_params
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)

SPARSE = SparsityConfig(enabled=True, density=0.25, group_size=128,
                        impl="kernel")
_MODELS = {}


def _pair(arch="granite-3-2b", *, sparse=False, **overrides):
    """(reference cfg, reference params, port cfg, port model), built once
    per configuration."""
    key = (arch, sparse, tuple(sorted(overrides.items())))
    if key not in _MODELS:
        if sparse:
            overrides["sparsity"] = SPARSE
        ref_cfg = dataclasses.replace(ref_get_smoke(arch), **overrides)
        cfg = dataclasses.replace(get_smoke(arch), **overrides)
        ref_params = RefModel(ref_cfg).init(jax.random.PRNGKey(0))
        model = LanguageModel(cfg, params_from_numpy(
            cfg, jax.device_get(ref_params), device="cpu"))
        _MODELS[key] = (ref_cfg, ref_params, cfg, model)
    return _MODELS[key]


def _tokens(cfg, seed, b=2, s=8):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=3e-2 * np.abs(want).max())


def _ref_forward(ref_cfg, ref_params, toks):
    ref_model = RefModel(ref_cfg)
    return jax.jit(lambda p, b: ref_model.forward(p, b)[0])(
        ref_params, {"tokens": jnp.asarray(toks)})


def _prefill_and_decode(ref_cfg, ref_params, model, toks, s_max, *,
                        shape_kind="prefill", decode_kind="decode",
                        steps=8):
    """Prefill, then ``steps`` greedy decode steps fed the reference's
    tokens; yields (port logits, reference logits) per call."""
    ref_model = RefModel(ref_cfg)
    decode = jax.jit(lambda p, c, t: ref_model.decode_step(
        p, c, t, shape_kind=decode_kind))
    want, caches_r = jax.jit(lambda p, b: ref_model.prefill(
        p, b, s_max, shape_kind=shape_kind))(ref_params,
                                             {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, caches = model.prefill({"tokens": torch.from_numpy(toks)},
                                    s_max, shape_kind=shape_kind)
        yield got, want
        for _ in range(steps):
            tok = np.array(jnp.argmax(want[:, -1].astype(jnp.float32), -1),
                           np.int32)[:, None]
            want, caches_r = decode(ref_params, caches_r, jnp.asarray(tok))
            got, caches = model.decode_step(caches, torch.from_numpy(tok),
                                            shape_kind=decode_kind)
            yield got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "rgcsr"])
def test_forward_prefill_and_decode_match(sparse, dtype):
    ref_cfg, ref_params, cfg, model = _pair(sparse=sparse, dtype=dtype)
    toks = _tokens(cfg, 1)
    want = _ref_forward(ref_cfg, ref_params, toks)
    with torch.inference_mode():
        got, h, _ = model({"tokens": torch.from_numpy(toks)})
    assert got.dtype == getattr(torch, dtype) and h.shape == (2, 8, 64)
    _close(got, want, dtype)
    calls = list(_prefill_and_decode(ref_cfg, ref_params, model, toks, 32))
    assert len(calls) == 9
    for got, want in calls:
        _close(got, want, dtype)


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "qwen1.5-32b"])
def test_other_gqa_families_match(arch):
    """Squared-ReLU plain FFN with an untied head (Nemotron-4) and qkv
    biases (Qwen1.5); a vocab short of its padding (logits past it are
    masked to -1e30)."""
    ref_cfg, ref_params, cfg, model = _pair(arch, dtype="float32", vocab=500)
    assert cfg.padded_vocab == 512
    toks = _tokens(cfg, 2)
    for got, want in _prefill_and_decode(ref_cfg, ref_params, model, toks,
                                         16, steps=2):
        _close(got, want, "float32")
        assert (got[..., cfg.vocab:] == -1e30).all()


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "rgcsr"])
def test_generate_is_token_identical(sparse):
    ref_cfg, ref_params, cfg, model = _pair(sparse=sparse, dtype="float32")
    toks = _tokens(cfg, 3)
    ref = RefEngine(ref_cfg, RefServeConfig(max_seq=32))
    ref.params = ref_params
    want = np.asarray(ref.generate(toks, max_new_tokens=12))
    tree = params_from_numpy(cfg, jax.device_get(ref_params), device="cpu")
    got = Engine(cfg, ServeConfig(max_seq=32), params=tree,
                 device="cpu").generate(toks, max_new_tokens=12)
    assert got.shape == (2, 12) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # with EOS.  The reference's generate() fails ("output array is
    # read-only") once a decode step runs with eos_id set, so its EOS rule
    # is applied here to its own stream: a row ends at its first EOS and
    # is filled with EOS; rows do not interact.
    for eos in (int(want[0, 0]), int(want[1, 3])):
        hit = np.cumsum(want == eos, axis=1) > 0
        got_eos = Engine(cfg, ServeConfig(max_seq=32, eos_id=eos),
                         params=tree, device="cpu").generate(
                             toks, max_new_tokens=12)
        np.testing.assert_array_equal(got_eos, np.where(hit, eos, want))
    # every row sampling EOS at prefill ends generation there, where the
    # reference's own generate() runs
    same = np.repeat(toks[:1], 2, axis=0)
    eos = int(want[0, 0])
    ref = RefEngine(ref_cfg, RefServeConfig(max_seq=32, eos_id=eos))
    ref.params = ref_params
    got_eos = Engine(cfg, ServeConfig(max_seq=32, eos_id=eos), params=tree,
                     device="cpu").generate(same, max_new_tokens=12)
    np.testing.assert_array_equal(
        got_eos, np.asarray(ref.generate(same, max_new_tokens=12)))
    assert (got_eos == eos).all()


def test_generate_refuses_a_cache_too_short():
    _, _, cfg, _ = _pair(dtype="float32")
    engine = Engine(cfg, ServeConfig(max_seq=16), device="cpu")
    engine.generate(_tokens(cfg, 4, s=8), max_new_tokens=9)    # fills it
    with pytest.raises(ValueError, match="max_seq"):
        engine.generate(_tokens(cfg, 4, s=8), max_new_tokens=10)


def test_int8_kv_cache_matches():
    ref_cfg, ref_params, cfg, model = _pair(dtype="float32",
                                            kv_cache_dtype="int8")
    for got, want in _prefill_and_decode(ref_cfg, ref_params, model,
                                         _tokens(cfg, 5), 32, steps=4):
        _close(got, want, "float32")


def test_windowed_ring_cache_matches():
    """``long_decode`` caps full attention at ``fallback_window`` (64 in
    the smoke config): a 70-token prompt rolls into the ring, and decode
    steps read it through the ring mask."""
    ref_cfg, ref_params, cfg, model = _pair(dtype="float32")
    assert cfg.fallback_window == 64
    toks = _tokens(cfg, 6, b=2, s=70)
    for got, want in _prefill_and_decode(
            ref_cfg, ref_params, model, toks, 96, shape_kind="long_decode",
            decode_kind="long_decode", steps=4):
        _close(got, want, "float32")


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "rgcsr"])
def test_flash_path_matches(monkeypatch, sparse):
    """The chunked online-softmax path, taken on both sides with the kv
    threshold lowered: prefill over a 48-slot cache, and a full forward
    of 24 tokens."""
    for mod in (ref_attention, attention):
        monkeypatch.setattr(mod, "_FLASH_KV_THRESHOLD", 16)
    ref_cfg, ref_params, cfg, model = _pair(sparse=sparse, dtype="float32")
    toks = _tokens(cfg, 7, s=24)
    want = _ref_forward(ref_cfg, ref_params, toks)
    with torch.inference_mode():
        got, _, _ = model({"tokens": torch.from_numpy(toks)})
    _close(got, want, "float32")
    for got, want in _prefill_and_decode(ref_cfg, ref_params, model, toks,
                                         48, steps=2):
        _close(got, want, "float32")


def test_param_count_and_layout_match_the_reference():
    for sparse in (False, True):
        ref_cfg, ref_params, cfg, model = _pair(sparse=sparse,
                                                dtype="float32")
        assert model.n_params() == RefModel(ref_cfg).n_params()
        n = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(ref_params))
        assert n == model.n_params()
        assert len(model.layers) == cfg.n_layers
        # layer i holds the reference's stacked slice i
        ref_q = np.asarray(ref_params["stack"]["body"]["0_attn"]["attn"]["q"]
                           ["kernel"])
        for i, block in enumerate(model.layers):
            np.testing.assert_array_equal(block.attn.q.kernel.numpy(),
                                          ref_q[i])


# ---------------------------------------- MoE, MLA and MTP (deepseek-v3)

# (arch, RgCSR FFN): minicpm3-4b and recurrentgemma-9b are dense-FFN
# families, so they carry the RgCSR FFN; the reference sparsifies no MoE
# FFN, and mamba2 has no FFN
FAMILIES = [("granite-moe-1b-a400m", False), ("minicpm3-4b", True),
            ("deepseek-v3-671b", False), ("mamba2-780m", False),
            ("recurrentgemma-9b", True)]
FAMILY_IDS = ["granite-moe", "minicpm3-rgcsr", "deepseek-v3", "mamba2",
              "recurrentgemma-rgcsr"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,sparse", FAMILIES, ids=FAMILY_IDS)
def test_moe_and_mla_families_match(arch, sparse, dtype):
    """forward (its MoE aux sums too), prefill and decode steps: MoE
    dropless at inference, MLA over dense caches, the recurrent states
    handed from prefill to decode."""
    ref_cfg, ref_params, cfg, model = _pair(arch, sparse=sparse, dtype=dtype)
    toks = _tokens(cfg, 11)
    ref_logits, _, ref_aux = jax.jit(lambda p, b: RefModel(ref_cfg).forward(
        p, b))(ref_params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, _, aux = model({"tokens": torch.from_numpy(toks)})
    _close(got, ref_logits, dtype)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(aux[k].item(), float(ref_aux[k]),
                                   rtol=1e-4 if dtype == "float32" else 3e-2)
    assert (aux["load_balance"].item() > 0) == bool(cfg.moe.n_experts)
    for got, want in _prefill_and_decode(ref_cfg, ref_params, model, toks,
                                         24, steps=4):
        _close(got, want, dtype)


@pytest.mark.parametrize("arch,sparse", FAMILIES, ids=FAMILY_IDS)
def test_families_generate_token_identical(arch, sparse):
    ref_cfg, ref_params, cfg, _ = _pair(arch, sparse=sparse, dtype="float32")
    toks = _tokens(cfg, 12)
    ref = RefEngine(ref_cfg, RefServeConfig(max_seq=32))
    ref.params = ref_params
    want = np.asarray(ref.generate(toks, max_new_tokens=10))
    tree = params_from_numpy(cfg, jax.device_get(ref_params), device="cpu")
    got = Engine(cfg, ServeConfig(max_seq=32), params=tree,
                 device="cpu").generate(toks, max_new_tokens=10)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "minicpm3-4b",
                                  "deepseek-v3-671b", "mamba2-780m",
                                  "recurrentgemma-9b"])
def test_family_param_counts_match_the_reference(arch):
    """Smoke: the tree, every layer's place and the active count; full
    size: the spec's counts, with no allocation."""
    ref_cfg, ref_params, cfg, model = _pair(arch, dtype="float32")
    ref_model = RefModel(ref_cfg)
    assert model.n_params() == ref_model.n_params()
    assert model.n_active_params() == ref_model.n_active_params()
    assert len(model.layers) == cfg.n_layers
    assert (model.mtp is not None) == bool(cfg.mtp_depth)
    assert count_params(model_spec(get_config(arch))) == \
        RefModel(ref_get_config(arch)).n_params()
    if cfg.moe.n_experts:
        body = ref_params["stack"]["body"]["0_moe"]["ffn"]
        n_pre = len(cfg.prefix_pattern)
        for r in range(cfg.pattern_repeats):
            ffn = model.layers[n_pre + r].ffn
            np.testing.assert_array_equal(ffn.experts.w_in.numpy(),
                                          np.asarray(body["experts"]["w_in"]
                                                     [r]))
            assert hasattr(ffn.router, "bias") == cfg.moe.aux_free_bias


def test_sampling_draws_from_the_top_k():
    """Sampled streams cannot match across frameworks (the generators
    differ): hold the port to the distribution's support instead."""
    _, _, cfg, _ = _pair(dtype="float32")
    from repro_torch.serve.device_loop import sample_tokens
    logits = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (4, 1, cfg.vocab)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    top = torch.topk(logits[:, -1], 5).indices
    for _ in range(20):
        tok = sample_tokens(logits, gen, 1.5, 5)
        assert tok.dtype == torch.int32
        assert (tok[:, None].long() == top).any(-1).all()
    assert torch.equal(sample_tokens(logits, None, 0.0, 0),
                       logits[:, -1].argmax(-1).int())


def test_layer_functions_match_the_reference():
    """The primitives the blocks use, and those no ported block uses yet
    (layernorm, the masks, gelu and squared ReLU, the shared-expert FFN),
    on the same inputs."""
    from repro.models import ffn as ref_ffn
    from repro.models import layers as ref_layers
    from repro_torch.models import ffn, layers

    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 5)).astype(np.int32)
    scale, bias = (rng.standard_normal(16).astype(np.float32)
                   for _ in range(2))
    t = torch.from_numpy
    pairs = [
        (layers.rmsnorm(t(scale), t(x)),
         ref_layers.rmsnorm({"scale": scale}, x)),
        (layers.layernorm(t(scale), t(bias), t(x)),
         ref_layers.layernorm({"scale": scale, "bias": bias}, x)),
        (layers.rope(t(x), t(pos), 500.0), ref_layers.rope(x, pos, 500.0)),
        (layers.rope_positions(2, 5, 3), ref_layers.rope_positions(2, 5, 3)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    for q_len, kv_len, off in ((4, 9, 5), (1, 7, 6)):
        np.testing.assert_array_equal(
            layers.make_causal_mask(q_len, kv_len, off).numpy(),
            np.asarray(ref_layers.make_causal_mask(q_len, kv_len, off)))
        np.testing.assert_array_equal(
            layers.make_window_mask(q_len, kv_len, 3, off).numpy(),
            np.asarray(ref_layers.make_window_mask(q_len, kv_len, 3, off)))
    h = x.reshape(40, 16)
    for name in ("silu", "gelu", "relu2"):
        np.testing.assert_allclose(
            ffn._activation(name)(t(h)).numpy(),
            np.asarray(ref_ffn._activation(name)(jnp.asarray(h))),
            rtol=1e-5, atol=1e-6)
    w = {name: {"kernel": rng.standard_normal(shape).astype(np.float32)}
         for name, shape in (("w_in", (16, 24)), ("w_gate", (16, 24)),
                             ("w_out", (24, 16)))}
    cfg = get_smoke("granite-3-2b")
    layer = ffn.FFN({k: {"kernel": t(v["kernel"])} for k, v in w.items()},
                    cfg)
    np.testing.assert_allclose(
        ffn.gated_ffn_apply(layer, cfg, t(h)).numpy(),
        np.asarray(ref_ffn.gated_ffn_apply(w, cfg, jnp.asarray(h))),
        rtol=1e-4, atol=1e-4)
