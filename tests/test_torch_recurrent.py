"""The port's recurrent mixers (``repro_torch.models.recurrent``) against
``repro.models.recurrent``: the causal conv and its step, the segment sum,
the chunked SSD (lengths a chunk multiple and not), Mamba-2's full
sequence with its end state and its decode step, the log-depth RG-LRU
scan against ``lax.associative_scan``, RG-LRU's full sequence and decode
step — fp32, the same numpy inputs, parameters drawn by the reference's
spec and carried across, within 1e-5.

Then the one place the port departs from the reference on purpose: a
prompt shorter than the conv tail (1 or 2 tokens) hands on a right-
aligned, zero-filled tail, so the port's prefill + decode equals the
reference's full forward there, where the reference's own prefill hands
on a short tail that its decode step cannot take.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models import LanguageModel as RefModel
from repro.models import recurrent as ref_rec
from repro.models.spec import init_from_spec as ref_init_from_spec
from repro_torch.configs import get_smoke
from repro_torch.models import LanguageModel, params_from_numpy
from repro_torch.models import recurrent as rec

torch.set_num_threads(1)

FP32 = dict(dtype="float32", kv_cache_dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch):
    return (dataclasses.replace(ref_get_smoke(arch), **FP32),
            dataclasses.replace(get_smoke(arch), **FP32))


def _t(tree):
    """A numpy/jax tree as torch tensors (writable copies)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _layer(kind, seed=0):
    """(reference cfg, reference params, port cfg, port module) of one
    mixer at the smoke width, the reference's draw."""
    arch = "mamba2-780m" if kind == "ssm" else "recurrentgemma-9b"
    ref_cfg, cfg = _cfgs(arch)
    spec = ref_rec.mamba2_spec(ref_cfg) if kind == "ssm" \
        else ref_rec.rglru_spec(ref_cfg)
    params = jax.device_get(ref_init_from_spec(jax.random.PRNGKey(seed),
                                               spec))
    if kind == "ssm":      # nonzero biases and skips: every term counts
        rng = np.random.default_rng(seed + 1)
        for name in ("dt_bias", "d_skip"):
            params[name] = _normal(rng, *params[name].shape, scale=0.5)
        params["conv"]["b"] = _normal(rng, *params["conv"]["b"].shape,
                                      scale=0.1)
    module = rec.Mamba2(_t(params)) if kind == "ssm" \
        else rec.RGLRU(_t(params))
    return ref_cfg, params, cfg, module


# ------------------------------------------------------------ the conv


def test_causal_conv_and_its_step_match():
    rng = np.random.default_rng(0)
    w, b = _normal(rng, 4, 24), _normal(rng, 24)
    x = _normal(rng, 2, 9, 24)
    _close(rec._causal_conv(_t(w), _t(b), _t(x)),
           ref_rec._causal_conv({"w": w, "b": b}, x))
    state, xt = _normal(rng, 2, 3, 24), _normal(rng, 2, 24)
    got = rec._conv_step(_t(w), _t(b), _t(state), _t(xt))
    want = ref_rec._conv_step({"w": w, "b": b}, state, xt)
    for g, v in zip(got, want):
        _close(g, v)
    # the step over a zero state equals the full conv, token by token
    st = torch.zeros(2, 3, 24)
    full = rec._causal_conv(_t(w), _t(b), _t(x))
    for i in range(x.shape[1]):
        y, st = rec._conv_step(_t(w), _t(b), st, _t(x[:, i]))
        torch.testing.assert_close(y, full[:, i], **TOL)


# ----------------------------------------------------------- Mamba-2 / SSD


def test_segsum_matches():
    x = _normal(np.random.default_rng(1), 2, 3, 7)
    got, want = rec._segsum(_t(x)), np.asarray(ref_rec._segsum(x))
    assert np.array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], **TOL)


@pytest.mark.parametrize("seq", [32, 37, 5], ids=["multiple", "ragged",
                                                   "short"])
def test_ssd_chunked_matches(seq):
    """Chunk 16 over 32 tokens (two whole chunks), 37 (the last chunk
    padded with dt = 0) and 5 (one padded chunk); 2 groups of heads."""
    rng = np.random.default_rng(seq)
    x = _normal(rng, 2, seq, 4, 8)
    dt = np.abs(_normal(rng, 2, seq, 4)) * 0.5
    a = -np.exp(_normal(rng, 4, scale=0.5))
    b, c = _normal(rng, 2, seq, 2, 6), _normal(rng, 2, seq, 2, 6)
    got = rec._ssd_chunked(*map(_t, (x, dt, a, b, c)), 16)
    want = ref_rec._ssd_chunked(x, dt, a, b, c, 16)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("seq", [16, 21])
def test_mamba2_apply_and_decode_match(seq):
    """The full sequence with its end state, then three decode steps from
    that state — both against the reference's."""
    ref_cfg, params, cfg, layer = _layer("ssm")
    rng = np.random.default_rng(seq)
    x = _normal(rng, 2, seq, cfg.d_model)
    with torch.no_grad():
        got, state = rec.mamba2_apply(layer, cfg, _t(x), return_state=True)
        want, ref_state = ref_rec.mamba2_apply(params, ref_cfg, x,
                                               return_state=True)
        _close(got, want)
        assert state["conv"].shape == (2, cfg.ssm.d_conv - 1,
                                       rec._mamba_dims(cfg)[2])
        for k in ("conv", "ssm"):
            _close(state[k], ref_state[k])
        for i in range(3):
            xt = _normal(rng, 2, cfg.d_model)
            got, state = rec.mamba2_decode(layer, cfg, state, _t(xt))
            want, ref_state = ref_rec.mamba2_decode(params, ref_cfg,
                                                    ref_state, xt)
            _close(got, want)
            for k in ("conv", "ssm"):
                _close(state[k], ref_state[k])
    fresh = rec.init_mamba2_state(cfg, 3, device="cpu")
    ref_fresh = ref_rec.init_mamba2_state(ref_cfg, 3)
    for k in ("conv", "ssm"):
        assert fresh[k].shape == ref_fresh[k].shape and not fresh[k].any()


# ------------------------------------------------------------------ RG-LRU


@pytest.mark.parametrize("seq", [1, 5, 16, 37])
def test_rglru_scan_matches_associative_scan(seq):
    """The log-depth scan against ``lax.associative_scan`` (another order
    of the products) and against the plain loop, with and without an
    initial state."""
    rng = np.random.default_rng(seq)
    a = rng.uniform(0.5, 0.999, (2, seq, 8)).astype(np.float32)
    b, h0 = _normal(rng, 2, seq, 8), _normal(rng, 2, 8)
    for init in (None, h0):
        got = rec._rglru_scan(_t(a), _t(b),
                              None if init is None else _t(init))
        _close(got, ref_rec._rglru_scan(
            jnp.asarray(a), jnp.asarray(b),
            None if init is None else jnp.asarray(init)))
        h = np.zeros((2, 8), np.float32) if init is None else init
        for t in range(seq):
            h = a[:, t] * h + b[:, t]
            np.testing.assert_allclose(got[:, t].numpy(), h, **TOL)


@pytest.mark.parametrize("seq", [7, 40])
def test_rglru_apply_and_decode_match(seq):
    ref_cfg, params, cfg, layer = _layer("rec")
    rng = np.random.default_rng(seq + 100)
    x = _normal(rng, 2, seq, cfg.d_model)
    with torch.no_grad():
        got, state = rec.rglru_apply(layer, cfg, _t(x), return_state=True)
        want, ref_state = ref_rec.rglru_apply(params, ref_cfg, x,
                                              return_state=True)
        _close(got, want)
        for k in ("conv", "h"):
            _close(state[k], ref_state[k])
        for i in range(3):
            xt = _normal(rng, 2, cfg.d_model)
            got, state = rec.rglru_decode(layer, cfg, state, _t(xt))
            want, ref_state = ref_rec.rglru_decode(params, ref_cfg,
                                                   ref_state, xt)
            _close(got, want)
            for k in ("conv", "h"):
                _close(state[k], ref_state[k])
    assert not any(t.any() for t in
                   rec.init_rglru_state(cfg, 2, device="cpu").values())


@pytest.mark.parametrize("kind", ["ssm", "rec"])
def test_a_short_prompts_tail_is_right_aligned_with_zeros(kind):
    """Prompts of 1 and 2 tokens: the reference hands on the prompt's raw
    rows alone; the port the same rows at the end of a 3-row tail with
    zeros before them — and then its decode step equals the full-sequence
    mixer over prompt + token."""
    ref_cfg, params, cfg, layer = _layer(kind)
    apply, ref_apply, decode = (
        (rec.mamba2_apply, ref_rec.mamba2_apply, rec.mamba2_decode)
        if kind == "ssm" else
        (rec.rglru_apply, ref_rec.rglru_apply, rec.rglru_decode))
    rng = np.random.default_rng(7)
    for n in (1, 2):
        x = _normal(rng, 2, n + 1, cfg.d_model)
        with torch.no_grad():
            _, state = apply(layer, cfg, _t(x[:, :n]), return_state=True)
            _, ref_state = ref_apply(params, ref_cfg, x[:, :n],
                                     return_state=True)
            assert ref_state["conv"].shape[1] == n
            assert state["conv"].shape[1] == 3
            assert not state["conv"][:, :3 - n].any()
            _close(state["conv"][:, 3 - n:], ref_state["conv"])
            y, _ = decode(layer, cfg, state, _t(x[:, n]))
            _close(y, ref_apply(params, ref_cfg, x)[:, n])


# ------------------------------------------------------- the model level

ARCHS = ["mamba2-780m", "recurrentgemma-9b"]
_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        ref_cfg, cfg = _cfgs(arch)
        ref_params = RefModel(ref_cfg).init(jax.random.PRNGKey(0))
        _MODELS[arch] = (ref_cfg, ref_params, LanguageModel(
            cfg, params_from_numpy(cfg, jax.device_get(ref_params),
                                   device="cpu")))
    return _MODELS[arch]


def _ref_logits(ref_cfg, ref_params, toks):
    return np.asarray(RefModel(ref_cfg).forward(
        ref_params, {"tokens": jnp.asarray(toks)})[0])


def _prefill_then_decode(model, toks, n_prompt, s_max):
    """The port's logits for positions n_prompt-1 .. L-1 of ``toks``: a
    prefill of the first ``n_prompt`` tokens, then one decode step per
    further token."""
    with torch.inference_mode():
        logits, caches = model.prefill(
            {"tokens": torch.from_numpy(toks[:, :n_prompt])}, s_max)
        out = [logits[:, -1]]
        for i in range(n_prompt, toks.shape[1]):
            logits, caches = model.decode_step(
                caches, torch.from_numpy(toks[:, i:i + 1]))
            out.append(logits[:, -1])
    return torch.stack(out, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_short_prompt_conv_tail_is_right_aligned(arch):
    """Prompts of 1 and 2 tokens, then 6 decode steps: the port's logits
    equal the reference's full ``forward`` over prompt + tokens (1e-4),
    and its own full forward (1e-5).  The reference's ``prefill`` →
    ``decode_step`` fails here: its conv tail is as short as the
    prompt."""
    ref_cfg, ref_params, model = _model(arch)
    toks = np.random.default_rng(3).integers(
        0, model.cfg.vocab, (2, 8)).astype(np.int32)
    want = _ref_logits(ref_cfg, ref_params, toks)
    with torch.inference_mode():
        full = model({"tokens": torch.from_numpy(toks)})[0]
    for n in (1, 2):
        got = _prefill_then_decode(model, toks, n, 16)
        np.testing.assert_allclose(got.numpy(), want[:, n - 1:], rtol=1e-4,
                                   atol=1e-4)
        torch.testing.assert_close(got, full[:, n - 1:], **TOL)
    with pytest.raises(Exception):
        rm = RefModel(ref_cfg)
        _, caches = rm.prefill(ref_params, {"tokens": jnp.asarray(
            toks[:, :2])}, 16)
        rm.decode_step(ref_params, caches, jnp.asarray(toks[:, 2:3]))


@pytest.mark.parametrize("n_prompt", [16, 21, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_a_full_forward(arch, n_prompt):
    """A prefill whose SSD chunks are whole (16 = one chunk of the smoke
    config) or not (21, 3), then decode steps to 40 tokens — past the
    smoke RecurrentGemma's 32-token window, so the ring wraps: the same
    logits as one full forward over the 40 tokens, within 1e-5."""
    _, _, model = _model(arch)
    toks = np.random.default_rng(n_prompt).integers(
        0, model.cfg.vocab, (2, 40)).astype(np.int32)
    with torch.inference_mode():
        full = model({"tokens": torch.from_numpy(toks)})[0]
    got = _prefill_then_decode(model, toks, n_prompt, 48)
    torch.testing.assert_close(got, full[:, n_prompt - 1:], **TOL)
