"""The port's multi-head latent attention (``attention.mla_apply`` and the
MLA caches) against the reference's, on minicpm3-4b's smoke config, with
the reference's parameters carried across: the no-cache branch, dense
prefill + decode, the windowed ring at ``s == 1``, and paged decode —
layer by layer, then the whole model's paged decode against the
reference's paged decode and against the port's own dense-layout decode.

Bars: float32 within rtol = atol = 1e-4 of the reference (caches too),
paged against the port's dense decode within 1e-5, bf16 within 3e-2 of
the largest reference value.  The reference's own paged-vs-dense MLA test
(``test_paging.py::test_paged_matches_dense_mla[13]``) fails at rtol =
atol = 1e-3 on bf16 logits by one bf16 step; the bf16 bar here covers
that rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving import pair
from repro.configs import get_smoke as ref_get_smoke
from repro.models import LanguageModel as RefModel
from repro.models import attention as ref_attention
from repro.models.spec import init_from_spec as ref_init
from repro.serve import paging as ref_paging
from repro_torch.configs import get_smoke
from repro_torch.models import LanguageModel, attention, params_from_numpy
from repro_torch.serve import paging

torch.set_num_threads(1)

ARCH = "minicpm3-4b"
S_MAX = 32
PS = 4


def _layer(dtype="float32", seed=0, **over):
    ref_cfg = dataclasses.replace(ref_get_smoke(ARCH), dtype=dtype, **over)
    cfg = dataclasses.replace(get_smoke(ARCH), dtype=dtype, **over)
    params = jax.tree_util.tree_map(np.array, jax.device_get(ref_init(
        jax.random.PRNGKey(seed), ref_attention.mla_spec(ref_cfg))))
    layer = attention.MLA(jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a.copy()), params))
    return ref_cfg, params, cfg, layer


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, dtype="float32", tol=1e-4):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=3e-2 * np.abs(want).max())


def _same_cache(cache, ref_cache, dtype="float32"):
    for key, t in cache.items():
        if key in ("index", "block_table"):
            np.testing.assert_array_equal(t.numpy(), np.asarray(
                ref_cache[key]))
        else:
            _close(t, ref_cache[key], dtype)


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora", [32, 0], ids=["q_lora", "q_proj"])
def test_no_cache_matches(dtype, q_lora):
    mla = dataclasses.replace(get_smoke(ARCH).mla, q_lora_rank=q_lora)
    ref_cfg, params, cfg, layer = _layer(dtype, mla=mla)
    assert hasattr(layer, "q_proj") == (q_lora == 0)
    x = _x(1, 2, 12, 64)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    want, _ = ref_attention.mla_apply(params, ref_cfg,
                                      jnp.asarray(x, ref_cfg.dtype),
                                      jnp.asarray(pos))
    with torch.inference_mode():
        got, cache = attention.mla_apply(layer, cfg, _t(x, dtype),
                                         torch.from_numpy(pos))
    assert cache is None and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def _prefill_decode(window, prompt, steps, dtype="float32", s_max=S_MAX):
    """Prefill ``prompt`` tokens into a fresh dense cache (a ring of
    ``window`` slots when given), then ``steps`` one-token calls, in both
    packages; yields (port y, reference y, port cache, reference cache)."""
    ref_cfg, params, cfg, layer = _layer(dtype, seed=2)
    x = _x(3, 2, prompt + steps, 64)
    ref_cache = ref_attention.init_mla_cache(ref_cfg, 2, s_max, window)
    cache = attention.init_mla_cache(cfg, 2, s_max, window, device="cpu")
    for key, t in cache.items():
        assert tuple(t.shape) == ref_cache[key].shape
    spans = [(0, prompt)] + [(prompt + i, prompt + i + 1)
                             for i in range(steps)]
    for lo, hi in spans:
        pos = np.tile(np.arange(lo, hi, dtype=np.int32), (2, 1))
        want, ref_cache = ref_attention.mla_apply(
            params, ref_cfg, jnp.asarray(x[:, lo:hi], ref_cfg.dtype),
            jnp.asarray(pos), cache=ref_cache, window=window)
        with torch.inference_mode():
            got, cache = attention.mla_apply(
                layer, cfg, _t(x[:, lo:hi], dtype), torch.from_numpy(pos),
                cache=cache, window=window)
        yield got, want, cache, ref_cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_prefill_and_decode_match(dtype):
    for got, want, cache, ref_cache in _prefill_decode(None, 9, 4, dtype):
        _close(got, want, dtype)
        _same_cache(cache, ref_cache, dtype)
    assert cache["index"].tolist() == [13, 13]


@pytest.mark.parametrize("prompt,steps", [(12, 8), (20, 2)],
                         ids=["wraps", "prompt-past-ring"])
def test_windowed_ring_matches(prompt, steps):
    """A 16-slot ring: a 12-token prompt, then decode steps that wrap the
    ring (position p at slot p % 16, read through the ring mask); and a
    20-token prompt, whose positions past the ring the reference's scatter
    drops, and so does the port."""
    for got, want, cache, ref_cache in _prefill_decode(16, prompt, steps):
        _close(got, want)
        _same_cache(cache, ref_cache)
    assert cache["ckv"].shape[1] == 16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_step_matches(dtype):
    """One decode step over page pools of random contents, a shuffled
    block table, and slot 2's index past its table's end (the lookup
    clamps, as JAX's gather)."""
    ref_cfg, params, cfg, layer = _layer(dtype, seed=4)
    geom = attention.PageGeometry(n_pages=13, page_size=PS, pages_per_slot=4)
    ref_cache = ref_attention.init_mla_paged_cache(ref_cfg, 3, geom)
    rng = np.random.default_rng(5)
    ref_cache = dict(ref_cache, **{
        key: jnp.asarray(rng.standard_normal(ref_cache[key].shape),
                         ref_cfg.dtype) for key in ("ckv", "krope")})
    ref_cache["block_table"] = jnp.asarray(
        1 + rng.permutation(12).reshape(3, 4), jnp.int32)
    ref_cache["index"] = jnp.asarray([5, 11, 16], jnp.int32)
    cache = attention.init_mla_paged_cache(cfg, 3, geom, device="cpu")
    for key, t in cache.items():
        t.copy_(torch.from_numpy(np.array(ref_cache[key], np.float32)
                                 if key in ("ckv", "krope")
                                 else np.array(ref_cache[key])))
    x = _x(6, 3, 1, 64)
    pos = np.array(ref_cache["index"])[:, None]
    want, ref_new = ref_attention.mla_apply(
        params, ref_cfg, jnp.asarray(x, ref_cfg.dtype), jnp.asarray(pos),
        cache=ref_cache)
    with torch.inference_mode():
        got, new = attention.mla_apply(layer, cfg, _t(x, dtype),
                                       torch.from_numpy(pos), cache=cache)
    assert new["ckv"] is cache["ckv"]                # written in place
    _close(got, want, dtype)
    _same_cache(new, ref_new, dtype)


# ------------------------------------------------ the model, paged decode


_JITS = {}


def _models(dtype):
    ref_cfg, ref_params, cfg, tree = pair(arch=ARCH)
    if dtype != "float32":
        ref_cfg = dataclasses.replace(ref_cfg, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if dtype not in _JITS:
        ref_model = RefModel(ref_cfg)
        _JITS[dtype] = (ref_model, jax.jit(
            lambda p, b: ref_model.prefill(p, b, S_MAX)),
            jax.jit(ref_model.decode_step))
    return _JITS[dtype], ref_params, LanguageModel(cfg, tree)


def _paged_vs_dense(prompt_len, dtype, n_steps=4, slot=1):
    """Prefill once, commit into slot ``slot`` of a 2-slot paged cache in
    both packages, then decode the reference's greedy stream through the
    reference's paged cache, the port's paged cache and the port's dense
    batch-1 cache; yields the three logits of the slot per step."""
    (ref_model, prefill, decode), ref_params, model = _models(dtype)
    prompt = np.random.default_rng(prompt_len).integers(
        0, 512, (1, prompt_len)).astype(np.int32)
    geom = paging.geometry(S_MAX, PS, n_slots=2)
    alloc = paging.PageAllocator(geom, n_slots=2)
    assert alloc.admit(slot, prompt_len, alloc.pages_for(prompt_len
                                                         + n_steps))
    logits, ref_dense = prefill(ref_params, {"tokens": jnp.asarray(prompt)})
    ref_caches = ref_paging.commit_prefill(
        ref_model.init_cache(2, S_MAX, paging=geom), ref_dense, slot,
        prompt_len, alloc.table, PS)
    caches = model.init_cache(2, S_MAX, paging=geom)
    assert set(caches[0]) == {"ckv", "krope", "block_table", "index"}
    with torch.inference_mode():
        _, dense = model.prefill({"tokens": torch.from_numpy(prompt)}, S_MAX)
        paging.commit_prefill(caches, dense, slot, prompt_len, alloc.table,
                              PS)
    tok, pos = int(jnp.argmax(logits[0, -1].astype(jnp.float32))), prompt_len
    for _ in range(n_steps):
        if alloc.ensure(slot, pos + 1):
            ref_caches = ref_paging.sync_block_tables(ref_caches,
                                                      alloc.table)
            paging.sync_block_tables(caches, alloc.table)
        both = np.zeros((2, 1), np.int32)
        both[slot, 0] = tok
        want, ref_caches = decode(ref_params, ref_caches, jnp.asarray(both))
        with torch.inference_mode():
            got, _ = model.decode_step(caches, torch.from_numpy(both))
            one, dense = model.decode_step(
                dense, torch.full((1, 1), tok, dtype=torch.int32))
            for c in caches:
                c["index"] += 1          # the serving loop's advance
        yield want[slot], got[slot], one[0]
        tok = int(jnp.argmax(want[slot, -1].astype(jnp.float32)))
        pos += 1


@pytest.mark.parametrize("prompt_len", [PS * 3, PS * 3 + 1, PS * 3 - 1])
def test_paged_decode_matches_dense_and_the_reference(prompt_len):
    for want, got, one in _paged_vs_dense(prompt_len, "float32"):
        _close(got, one, tol=1e-5)
        _close(got, want)


def test_paged_decode_bf16_within_the_bf16_bar():
    for want, got, _ in _paged_vs_dense(PS * 3 + 1, "bfloat16"):
        _close(got, want, "bfloat16")


def test_page_fingerprints_cover_the_latent_pools():
    """The reference's crc of MLA pages (it chains ``ckv`` then
    ``krope``) from the same bytes, and the NaN scan over both pools."""
    (ref_model, prefill, _), ref_params, model = _models("float32")
    geom = paging.geometry(S_MAX, PS, n_slots=2)
    alloc = paging.PageAllocator(geom, n_slots=2)
    ref_caches = ref_model.init_cache(2, S_MAX, paging=geom)
    for slot, n in ((0, 9), (1, 6)):
        prompt = np.random.default_rng(n).integers(0, 512, (1, n)).astype(
            np.int32)
        _, one = prefill(ref_params, {"tokens": jnp.asarray(prompt)})
        alloc.admit(slot, n, 4)
        ref_caches = ref_paging.commit_prefill(ref_caches, one, slot, n,
                                               alloc.table, PS)
    caches = model.init_cache(2, S_MAX, paging=geom)
    body = ref_caches["body"]["0_attn"]
    for i, cache in enumerate(caches):
        for key, t in cache.items():
            t.copy_(torch.from_numpy(np.array(body[key][i])))
    committed = {p: 4 for p in alloc.slot_pages[0][:2]}
    committed.update({alloc.slot_pages[0][2]: 1, alloc.slot_pages[1][1]: 2})
    order = paging.crc_order(model.cfg)
    assert paging.page_fingerprints(caches, committed, order) == \
        ref_paging.page_fingerprints(ref_caches, committed)
    page = alloc.slot_pages[1][0]
    paging.corrupt_page(caches, page, nan=True)
    ref_caches = ref_paging.corrupt_page(ref_caches, page, nan=True)
    assert paging.page_fingerprints(caches, committed, order) == \
        ref_paging.page_fingerprints(ref_caches, committed)
    assert paging.pages_nonfinite(caches, alloc.slot_pages[1]) == {page}


def test_mla_caches_take_the_compute_dtype():
    """MLA caches are stored in ``cfg.dtype`` (the int8 KV path is
    GQA-only, as in the reference), dense and paged."""
    cfg = dataclasses.replace(get_smoke(ARCH), kv_cache_dtype="int8")
    model = LanguageModel(cfg, params_from_numpy(
        cfg, jax.device_get(pair(arch=ARCH)[1]), device="cpu"))
    geom = paging.geometry(S_MAX, PS, n_slots=2)
    for caches in (model.init_cache(2, S_MAX),
                   model.init_cache(2, S_MAX, paging=geom)):
        assert {c["ckv"].dtype for c in caches} == {torch.bfloat16}
        assert {c["krope"].dtype for c in caches} == {torch.bfloat16}
