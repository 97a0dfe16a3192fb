"""The encoder-decoder family (seamless-m4t-medium: frames through the
encoder, cross-attention in every decoder layer) and the vision frontend
(pixtral-12b: projected patches before the text) against the reference,
on their smoke configs, with the reference's parameters carried across
through ``params_from_numpy``.

Bars: fp32 logits within 1e-4 · (1 + max|logit|); bf16 logits within
3e-2 · max|logit| (the frameworks round bf16 at other places); greedy
tokens identical at fp32; one train step's losses and parameters within
1e-5.  The RgCSR FFN (every ``w_out``, the encoder's too) runs the
reference's Pallas path in interpret mode and the port's K2 plain
version; training runs the segment sum on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import model_inputs
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.configs.base import SparsityConfig as RefSparsityConfig
from repro.launch import steps as ref_steps
from repro.models import LanguageModel as RefModel
from repro.models import attention as ref_attention
from repro.serve import Engine as RefEngine, ServeConfig as RefServeConfig
from repro.serve import paging as ref_paging
from repro.train import data as ref_data
from repro.train import optimizer as ref_opt
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import SparsityConfig
from repro_torch.launch import steps
from repro_torch.models import (LanguageModel, attention, model_spec,
                                params_from_numpy)
from repro_torch.models import transformer as tfm
from repro_torch.models.model import port_layout, reference_layout
from repro_torch.models.spec import count_params
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.serve import paging
from repro_torch.train import data, optimizer

torch.set_num_threads(1)

ARCHS = ["seamless-m4t-medium", "pixtral-12b"]
ARCH_IDS = ["seamless", "pixtral"]
SPARSITY = dict(enabled=True, density=0.25, group_size=128)
_MODELS = {}


def _pair(arch, *, sparse=False, dtype="float32", impl="kernel"):
    """(reference cfg, reference params, port cfg, port model), built once
    per configuration; fp32 keeps its caches in fp32 too."""
    key = (arch, sparse, dtype, impl)
    if key not in _MODELS:
        over = dict(dtype=dtype, kv_cache_dtype=dtype)
        ref_cfg = dataclasses.replace(ref_get_smoke(arch), **over)
        cfg = dataclasses.replace(get_smoke(arch), **over)
        if sparse:
            ref_cfg = dataclasses.replace(ref_cfg, sparsity=RefSparsityConfig(
                impl=impl, **SPARSITY))
            cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
                impl=impl, **SPARSITY))
        ref_params = RefModel(ref_cfg).init(jax.random.PRNGKey(0))
        model = LanguageModel(cfg, params_from_numpy(
            cfg, jax.device_get(ref_params), device="cpu"))
        _MODELS[key] = (ref_cfg, ref_params, cfg, model)
    return _MODELS[key]


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    peak = np.abs(want).max()
    tol = 1e-4 * (1 + peak) if dtype == "float32" else 3e-2 * peak
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _both(batch):
    """``batch`` (numpy) as the reference's and the port's inputs."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _decode_tokens(want):
    return np.array(jnp.argmax(want[:, -1].astype(jnp.float32), -1),
                    np.int32)[:, None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "rgcsr"])
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_forward_and_loss_match(arch, sparse, dtype):
    """Logits over the whole sequence (the patches' positions first for
    pixtral), the loss (no label on a patch) and its metrics."""
    ref_cfg, ref_params, cfg, model = _pair(arch, sparse=sparse, dtype=dtype)
    batch = model_inputs(cfg, 1, s=10)
    batch["labels"] = model_inputs(cfg, 2, s=10)["tokens"]
    batch["labels"][0, :2] = -1
    ref_b, port_b = _both(batch)
    ref_model = RefModel(ref_cfg)
    want = jax.jit(lambda p, b: ref_model.forward(p, b)[0])(ref_params, ref_b)
    want_loss, want_m = jax.jit(ref_model.loss)(ref_params, ref_b)
    with torch.inference_mode():
        got, h, _ = model(port_b)
        loss, metrics = model.loss(port_b)
    n = 10 + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    assert got.dtype == getattr(torch, dtype) and h.shape == (2, n,
                                                              cfg.d_model)
    _close(got, want, dtype)
    assert set(metrics) == set(want_m) == {"ce", "loss"}
    rtol = 1e-5 if dtype == "float32" else 3e-2
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(want_m[k]), rtol=rtol,
                                   err_msg=k)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "rgcsr"])
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_prefill_and_three_decode_steps_match(arch, sparse, dtype):
    """Prefill (the encoder, each decoder layer's cross keys and values;
    the patches in the cache's first positions) and three decode steps
    fed the reference's greedy tokens."""
    ref_cfg, ref_params, cfg, model = _pair(arch, sparse=sparse, dtype=dtype)
    ref_b, port_b = _both(model_inputs(cfg, 3))
    ref_model = RefModel(ref_cfg)
    want, caches_r = jax.jit(lambda p, b: ref_model.prefill(p, b, 32))(
        ref_params, ref_b)
    decode = jax.jit(ref_model.decode_step)
    with torch.inference_mode():
        got, caches = model.prefill(port_b, 32)
        _close(got, want, dtype)
        if cfg.enc_dec:
            assert all(sorted(c) == ["ck", "cv", "self"] for c in caches)
            assert caches[0]["ck"].dtype == getattr(torch, dtype)
            assert caches[0]["ck"].shape == (2, 12, cfg.n_kv_heads,
                                             cfg.head_dim)
        for _ in range(3):
            tok = _decode_tokens(want)
            want, caches_r = decode(ref_params, caches_r, jnp.asarray(tok))
            got, caches = model.decode_step(caches, torch.from_numpy(tok))
            _close(got, want, dtype)
    index = caches[0]["self"]["index"] if cfg.enc_dec else caches[0]["index"]
    n = 8 + (cfg.frontend_tokens if cfg.frontend == "vision" else 0) + 3
    assert index.tolist() == [n, n]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "rgcsr"])
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_engine_prefill_and_decode_are_token_identical(arch, sparse):
    """The reference's serving path for these families
    (``test_serve.py::test_encdec_generate``): ``Engine._prefill`` with
    the whole batch, then ``_sample`` and ``_decode`` per token."""
    ref_cfg, ref_params, cfg, model = _pair(arch, sparse=sparse)
    batch = model_inputs(cfg, 5, s=6)
    ref_b, port_b = _both(batch)
    ref = RefEngine(ref_cfg, RefServeConfig(max_seq=64))
    ref.params = ref_params
    logits, caches = ref._prefill(ref.params, ref_b)
    tok = ref._sample(logits)[:, None]
    want = [np.asarray(tok)]
    for _ in range(5):
        logits, caches = ref._decode(ref.params, caches, tok)
        tok = ref._sample(logits)[:, None]
        want.append(np.asarray(tok))
    eng = Engine(cfg, ServeConfig(max_seq=64), params=model)
    with torch.inference_mode():
        logits, caches = eng._prefill(port_b)
        tok = eng._sample(logits)[:, None]
        got = [tok.numpy()]
        for _ in range(5):
            logits, caches = eng._decode(caches, tok)
            tok = eng._sample(logits)[:, None]
            got.append(tok.numpy())
    assert np.isfinite(logits.float().numpy()).all()
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "rgcsr"])
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_one_train_step_matches(arch, sparse):
    """One AdamW step (no weight decay: the reference decays its stacked
    norm scales, encoder's included, the port none) on ``make_batch``'s
    frames or patches: metrics and every parameter within 1e-5; the
    RgCSR FFN trains through the segment sum on both sides.  Adam's eps
    is 1e-6 on both sides, as in ``test_torch_train.py``'s MoE case: a
    first step moves a weight by lr·g/(|g| + eps), and a few gradients of
    the key projections (self- and cross-attention's ``k``, with the
    RgCSR FFN) are small enough that the packages' fp32 gradients, equal
    to rounding, would move them by different fractions of lr at
    eps = 1e-8."""
    ref_cfg, ref_params, cfg, _ = _pair(arch, sparse=sparse, impl="ref")
    host = jax.device_get(ref_params)
    okw = dict(lr=3e-3, warmup_steps=2, decay_steps=10, weight_decay=0.0,
               eps=1e-6)
    batch = data.make_batch(data.DataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=4, seed=1,
        family=cfg.family, d_frontend=cfg.d_frontend,
        frontend_tokens=cfg.frontend_tokens), 0)
    ref_batch = ref_data.make_batch(ref_data.DataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=4, seed=1,
        family=cfg.family, d_frontend=cfg.d_frontend,
        frontend_tokens=cfg.frontend_tokens), 0)
    assert batch.keys() == ref_batch.keys()
    ref_fn, ref_init = ref_steps.make_train_step(
        RefModel(ref_cfg), ref_opt.OptimizerConfig(**okw), 1)
    new_ref, _, want = jax.jit(ref_fn)(ref_params, ref_init(ref_params),
                                       ref_batch)
    model = LanguageModel(cfg, params_from_numpy(cfg, host, device="cpu"))
    model.requires_grad_(True)
    step_fn, init = steps.make_train_step(
        model, optimizer.OptimizerConfig(**okw), 1)
    params = model.tensors()
    params, _, got = step_fn(params, init(params), batch)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    want_p = port_layout(cfg, jax.device_get(new_ref))
    assert want_p.keys() == params.keys()
    for k, t in params.items():
        np.testing.assert_allclose(t.detach().numpy(), want_p[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_chunked_attention_path_matches(monkeypatch, arch):
    """The chunked online-softmax path, taken on both sides with the kv
    threshold lowered to 16: the encoder's full mask over 24 frames and
    the decoder's cross-attention to them (forward and prefill), and
    pixtral's causal prefill over 8 patches + 20 tokens; then decode
    steps, which attend directly."""
    for mod in (ref_attention, attention):
        monkeypatch.setattr(mod, "_FLASH_KV_THRESHOLD", 16)
    ref_cfg, ref_params, cfg, model = _pair(arch, sparse=True)
    ref_b, port_b = _both(model_inputs(cfg, 7, s=20, enc_len=24))
    ref_model = RefModel(ref_cfg)
    want = ref_model.forward(ref_params, ref_b)[0]
    with torch.inference_mode():
        got = model(port_b)[0]
    _close(got, want, "float32")
    want, caches_r = ref_model.prefill(ref_params, ref_b, 40)
    with torch.inference_mode():
        got, caches = model.prefill(port_b, 40)
        _close(got, want, "float32")
        for _ in range(2):
            tok = _decode_tokens(want)
            want, caches_r = ref_model.decode_step(ref_params, caches_r,
                                                   jnp.asarray(tok))
            got, caches = model.decode_step(caches, torch.from_numpy(tok))
            _close(got, want, "float32")


def test_commit_prefill_of_a_nested_cache_matches():
    """A batch-1 prefill committed into slot 1 of three: the decoder's
    self cache spliced at the slot, its cross keys and values copied
    there, every other slot untouched — the reference's
    ``commit_prefill`` on the same live caches."""
    arch = "seamless-m4t-medium"
    ref_cfg, ref_params, cfg, model = _pair(arch)
    ref_model = RefModel(ref_cfg)
    rng = np.random.default_rng(9)
    live_r = ref_model.init_cache(3, 24, enc_len=12)
    live_r = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype))
        if a.dtype == jnp.float32 else a, live_r)
    live = model.init_cache(3, 24, enc_len=12)
    body = live_r["body"]["0_dec_attn"]
    for i, cache in enumerate(live):
        for key in ("ck", "cv"):
            cache[key].copy_(torch.from_numpy(np.array(body[key][i])))
        for key in ("k", "v"):
            cache["self"][key].copy_(torch.from_numpy(np.array(
                body["self"][key][i])))
    ref_b, port_b = _both(model_inputs(cfg, 11, b=1, s=7))
    _, one_r = ref_model.prefill(ref_params, ref_b, 24)
    with torch.inference_mode():
        _, one = model.prefill(port_b, 24)
    want = ref_paging.commit_prefill(live_r, one_r, 1, 7)
    paging.commit_prefill(live, one, 1, 7)
    body = want["body"]["0_dec_attn"]
    for i, cache in enumerate(live):
        for key in ("ck", "cv"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       np.asarray(body[key][i]), rtol=1e-5,
                                       atol=1e-5)
        for key in ("k", "v", "index"):
            np.testing.assert_allclose(cache["self"][key].numpy(),
                                       np.asarray(body["self"][key][i]),
                                       rtol=1e-5, atol=1e-5)
    assert live[0]["self"]["index"].tolist() == [0, 7, 0]


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_params_and_layouts_match_the_reference(arch):
    """Counts (smoke: the trees; full size: the specs, with and without the
    RgCSR FFN, with no allocation), each encoder layer's place, and the
    reference's tree through ``port_layout`` and ``reference_layout`` and
    back, leaf for leaf."""
    ref_cfg, ref_params, cfg, model = _pair(arch, sparse=True)
    host = jax.device_get(ref_params)
    assert model.n_params() == RefModel(ref_cfg).n_params() == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(host))
    for sparsity in (None, True):
        full, ref_full = get_config(arch), ref_get_config(arch)
        if sparsity:
            full = dataclasses.replace(full, sparsity=SparsityConfig(
                impl="kernel", **SPARSITY))
            ref_full = dataclasses.replace(ref_full, sparsity=(
                RefSparsityConfig(impl="kernel", **SPARSITY)))
        assert count_params(model_spec(full)) == \
            RefModel(ref_full).n_params()
    assert len(model.layers) == cfg.n_layers
    if cfg.enc_dec:
        assert len(model.encoder) == cfg.n_enc_layers
        ref_q = host["encoder"]["body"]["0_enc_attn"]["attn"]["q"]["kernel"]
        for i, block in enumerate(model.encoder):
            assert block.kind == "enc_attn"
            np.testing.assert_array_equal(block.attn.q.kernel.numpy(),
                                          ref_q[i])
    flat = port_layout(cfg, host)
    assert flat.keys() == model.tensors().keys()
    for k, t in model.tensors().items():
        np.testing.assert_array_equal(t.numpy(), flat[k], err_msg=k)
    back = reference_layout(cfg, flat)
    got = {jax.tree_util.keystr(p): a for p, a in
           jax.tree_util.tree_flatten_with_path(back)[0]}
    want = {jax.tree_util.keystr(p): a for p, a in
            jax.tree_util.tree_flatten_with_path(host)[0]}
    assert got.keys() == want.keys()
    for p, a in got.items():
        np.testing.assert_array_equal(a, want[p], err_msg=p)


def test_a_decoder_layer_without_encoder_output_raises():
    """Where the reference cross-attends a ``dec_attn`` layer to its own
    input (``kv_x`` falls back to ``x``), the port refuses."""
    _, _, cfg, model = _pair("seamless-m4t-medium")
    block = model.layers[0]
    x = torch.zeros((1, 3, cfg.d_model))
    pos = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="enc_out"):
        tfm.block_apply(block, cfg, "dec_attn", x, pos)
    cache = tfm.init_block_cache(cfg, "dec_attn", 1, 8, device="cpu")
    with pytest.raises(ValueError, match="enc_out"):
        tfm.block_apply(block, cfg, "dec_attn", x, pos, mode="prefill",
                        cache=cache)
    with pytest.raises(ValueError, match="kv_x"):
        attention.gqa_apply(block.cross, cfg, x, pos, mode="cross")
    with pytest.raises(ValueError, match="kv_x"):
        attention.gqa_apply(block.attn, cfg, x, pos, mode="full", kv_x=x)
    with pytest.raises(ValueError, match="enc_out"):
        tfm.stack_apply(model.layers, cfg, x, pos)


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_token_only_serving_refuses_these_configs(arch):
    """``serve``, ``start_session`` and ``generate`` take tokens alone —
    the reference's fail on the missing frames or patches — so the port
    names the cause."""
    _, _, cfg, model = _pair(arch)
    eng = Engine(cfg, ServeConfig(max_seq=32, n_slots=2), params=model)
    need = "frames" if cfg.enc_dec else "patch_embeds"
    req = Request(tokens=np.arange(4, dtype=np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match=need):
        eng.serve([req])
    with pytest.raises(ValueError, match=need):
        eng.start_session()
    with pytest.raises(ValueError, match=need):
        eng.generate(np.zeros((1, 4), np.int32), 2)
    assert eng._runner is None            # no serving state was built
