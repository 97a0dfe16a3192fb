"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
``repro.models.moe``, on the smoke configs of granite-moe-1b-a400m
(softmax routing, no shared expert) and deepseek-v3-671b (sigmoid routing
with the aux-free bias, one shared expert), with the reference's layer
parameters carried across.

Bars: routing indices and capacities exactly equal; combine weights, aux
terms and the layer's output within rtol = atol = 1e-5 in float32 (the
same arithmetic in another framework), bf16 outputs within 3e-2 of the
largest.  Capacity drops in train mode are the same routed copies: a copy
dropped on one side only would leave its token an expert's output short.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import row_shards
from repro.configs import get_smoke as ref_get_smoke
from repro.models import ffn as ref_ffn
from repro.models import moe as ref_moe
from repro.models.spec import init_from_spec as ref_init
from repro_torch.configs import get_smoke
from repro_torch.models import ffn, moe
from repro_torch.models.layers import ParamModule

torch.set_num_threads(1)

ARCHS = ["granite-moe-1b-a400m", "deepseek-v3-671b"]


def _layer(arch, seed=0, bias=False, **over):
    """(reference cfg, reference params, port cfg, port MoE) of one MoE
    layer; ``bias``: a random nonzero router bias on both sides."""
    ref_cfg = dataclasses.replace(ref_get_smoke(arch), dtype="float32",
                                  **over)
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32", **over)
    ref_params = jax.device_get(ref_init(jax.random.PRNGKey(seed),
                                         ref_moe.moe_spec(ref_cfg)))
    ref_params = jax.tree_util.tree_map(np.array, ref_params)
    if bias:
        ref_params["router"]["bias"] = np.random.default_rng(seed).uniform(
            -0.3, 0.3, cfg.moe.n_experts).astype(np.float32)
    tree = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()),
                                  ref_params)
    return ref_cfg, ref_params, cfg, moe.MoE(tree, cfg)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch,bias", [("granite-moe-1b-a400m", False),
                                       ("deepseek-v3-671b", False),
                                       ("deepseek-v3-671b", True)])
def test_routing_matches(arch, bias):
    ref_cfg, ref_params, cfg, layer = _layer(arch, 1, bias=bias)
    x = _x(2, 40, cfg.d_model)
    want_idx, want_w, want_aux = ref_moe._routing(ref_params, ref_cfg,
                                                  jnp.asarray(x))
    idx, w, aux = moe._routing(layer, cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    _close(w.numpy(), want_w)
    assert set(aux) == set(want_aux)
    for k in aux:
        _close(aux[k].numpy(), want_aux[k])
    if bias:
        # the bias moves the selection, never the weights: the weights are
        # the unbiased scores at the selected experts, normalised
        scores = torch.sigmoid(torch.from_numpy(x) @ layer.router.kernel)
        sel = torch.gather(scores, -1, idx)
        _close(w.numpy(), (sel / (sel.sum(-1, keepdim=True) + 1e-9)).numpy())
        unbiased = moe._top_k(scores, cfg.moe.top_k)
        assert not torch.equal(unbiased, idx)


def test_top_k_breaks_ties_toward_the_lower_index():
    """Experts with equal router columns score equally: ``lax.top_k``
    takes the lower index first, and so does the port."""
    ref_cfg, ref_params, cfg, layer = _layer("granite-moe-1b-a400m", 3)
    kernel = ref_params["router"]["kernel"]
    kernel[:, 1::2] = kernel[:, 0::2]           # experts 2i and 2i+1 tie
    with torch.no_grad():
        layer.router.kernel.copy_(torch.from_numpy(kernel))
    x = _x(4, 16, cfg.d_model)
    want_idx, _, _ = ref_moe._routing(ref_params, ref_cfg, jnp.asarray(x))
    idx, _, _ = moe._routing(layer, cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    # every selected pair comes whole, the even expert first
    assert (idx[:, 0::2] % 2 == 0).all() and (idx[:, 1::2] ==
                                              idx[:, 0::2] + 1).all()


def test_capacity_matches():
    for arch in ARCHS:
        ref_cfg, cfg = ref_get_smoke(arch), get_smoke(arch)
        for full in (ref_cfg, cfg):
            assert full.moe.n_experts == 4
        for n in (1, 7, 8, 9, 31, 64, 100, 513):
            for dropless in (False, True):
                got = moe._capacity(cfg, n, dropless)
                assert got == ref_moe._capacity(ref_cfg, n, dropless)
                assert got >= 8 and got % 8 == 0


def _apply_both(arch, x, dropless, **over):
    ref_cfg, ref_params, cfg, layer = _layer(arch, 5, **over)
    want, want_aux = ref_moe.moe_apply(ref_params, ref_cfg, jnp.asarray(x),
                                       dropless=dropless)
    got, aux = moe.moe_apply(layer, cfg, torch.from_numpy(x),
                             dropless=dropless)
    return (ref_cfg, ref_params, cfg, layer), (want, want_aux), (got, aux)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("dropless", [False, True],
                         ids=["train", "dropless"])
def test_moe_apply_matches(arch, dispatch, dropless):
    """Train mode with 64 tokens on 4 experts at capacity factor 0.5:
    capacity 16 of the ~32 copies each expert gets, so copies are dropped
    (checked below); dropless mode drops none."""
    x = _x(6, 2, 32, 64)
    (ref_cfg, ref_params, cfg, layer), (want, want_aux), (got, aux) = \
        _apply_both(arch, x, dropless, moe=dataclasses.replace(
            get_smoke(arch).moe, dispatch=dispatch, capacity_factor=0.5))
    _close(got.numpy(), want)
    for k in want_aux:
        _close(aux[k].numpy(), want_aux[k])
    idx, _, _ = moe._routing(layer, cfg, torch.from_numpy(x.reshape(64, 64)))
    per_expert = np.bincount(idx.numpy().ravel(), minlength=4)
    cap = moe._capacity(cfg, 64, dropless)
    assert (per_expert.max() > cap) == (not dropless)


@pytest.mark.parametrize("arch", ARCHS)
def test_einsum_and_scatter_agree(arch):
    x = torch.from_numpy(_x(7, 2, 24, 64))
    outs = []
    for dispatch in ("einsum", "scatter"):
        _, _, cfg, layer = _layer(arch, 8, moe=dataclasses.replace(
            get_smoke(arch).moe, dispatch=dispatch))
        for dropless in (False, True):
            outs.append(moe.moe_apply(layer, cfg, x, dropless=dropless)[0])
    _close(outs[0].numpy(), outs[2].numpy())
    _close(outs[1].numpy(), outs[3].numpy())


def test_the_dropless_budget_reroutes_to_scatter(monkeypatch):
    """Past ``_DROPLESS_EINSUM_BUDGET`` elements of (T, E, cap) a dropless
    einsum call runs the scatter dispatch, in both packages, at the same
    sizes: 16 tokens (16·4·16 = 1024 elements) stay on einsum under a
    budget of 1024, 17 (17·4·24) go to scatter."""
    calls = {"ref": [], "port": []}
    for side, mod in (("ref", ref_moe), ("port", moe)):
        monkeypatch.setattr(mod, "_DROPLESS_EINSUM_BUDGET", 1024)
        real = mod._dispatch_scatter

        def spy(*a, side=side, real=real, **kw):
            calls[side].append(a[2].shape[0])
            return real(*a, **kw)

        monkeypatch.setattr(mod, "_dispatch_scatter", spy)
    for t in (16, 17):
        x = _x(9, 1, t, 64)
        _, (want, _), (got, _) = _apply_both("granite-moe-1b-a400m", x,
                                             dropless=True)
        _close(got.numpy(), want)
    assert calls["port"] == calls["ref"] == [17]


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_layer_within_the_bf16_bar(arch):
    x = _x(10, 2, 16, 64)
    ref_cfg, ref_params, _, _ = _layer(arch, 11)
    ref_cfg = dataclasses.replace(ref_cfg, dtype="bfloat16")
    cfg = dataclasses.replace(get_smoke(arch), dtype="bfloat16")
    layer = _layer(arch, 11)[3]
    want, _ = ref_moe.moe_apply(ref_params, ref_cfg,
                                jnp.asarray(x, jnp.bfloat16), dropless=True)
    got, _ = moe.moe_apply(layer, cfg, torch.from_numpy(x).bfloat16(),
                           dropless=True)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=3e-2 * np.abs(want).max())


def test_stacked_expert_ffn_matches():
    cfg = get_smoke("granite-moe-1b-a400m")
    rng = np.random.default_rng(12)
    w = {"w_in": rng.standard_normal((4, 64, 32)).astype(np.float32),
         "w_gate": rng.standard_normal((4, 64, 32)).astype(np.float32),
         "w_out": rng.standard_normal((4, 32, 64)).astype(np.float32)}
    x = _x(13, 4, 8, 64)
    want = ref_ffn.ffn_apply_stacked(w, cfg, jnp.asarray(x))
    got = ffn.ffn_apply_stacked(
        ParamModule({k: torch.from_numpy(v) for k, v in w.items()}), cfg,
        torch.from_numpy(x))
    _close(got.numpy(), want, 1e-4)


def test_the_router_bias_takes_no_gradient():
    """Routing reads the bias detached (the reference's stop_gradient):
    the loss reaches the kernel and the experts, never the bias."""
    _, _, cfg, layer = _layer("deepseek-v3-671b", 14, bias=True)
    layer.requires_grad_(True)
    y, aux = moe.moe_apply(layer, cfg, torch.from_numpy(_x(15, 1, 8, 64)))
    (y.square().sum() + aux["load_balance"]).backward()
    assert layer.router.bias.grad is None
    assert layer.router.kernel.grad.abs().sum() > 0
    assert layer.experts.w_in.grad.abs().sum() > 0


# ------------------------------------------------- rows split across ranks
# (each shard's counts gathered by ``_torch_parity.row_shards``, in
# process, as the all-gather gives them on a mesh)


@pytest.mark.parametrize("arch,bias", [("granite-moe-1b-a400m", False),
                                       ("deepseek-v3-671b", True)])
@pytest.mark.parametrize("n", [2, 4])
def test_split_routing_shares_sum_to_the_reference(arch, bias, n):
    """Each shard routes its rows as the whole batch does; its load-balance
    and z-loss shares sum to the reference's terms, and every shard sees
    the whole batch's ``expert_fraction``."""
    ref_cfg, ref_params, cfg, layer = _layer(arch, 16, bias=bias)
    x = _x(17, 48, cfg.d_model)
    want_idx, want_w, want_aux = ref_moe._routing(ref_params, ref_cfg,
                                                  jnp.asarray(x))
    parts, shards = row_shards(layer, cfg, torch.from_numpy(x), n)
    got = [moe._routing_shard(layer, cfg, p, s)
           for p, s in zip(parts, shards)]
    np.testing.assert_array_equal(torch.cat([g[0] for g in got]).numpy(),
                                  np.asarray(want_idx))
    _close(torch.cat([g[1] for g in got]).numpy(), want_w)
    for k in ("load_balance", "router_z"):
        _close(sum(g[2][k] for g in got).numpy(), want_aux[k])
    for g in got:
        assert set(g[2]) == set(want_aux)
        _close(g[2]["expert_fraction"].numpy(), want_aux["expert_fraction"])
    # offsets: the copies of the shards before, per expert
    seen = torch.zeros(cfg.moe.n_experts, dtype=torch.int32)
    for (idx, _, _, offset), p in zip(got, parts):
        assert offset.dtype == torch.int32 and torch.equal(offset, seen)
        seen = seen + moe._one_hot(idx, cfg.moe.n_experts,
                                   torch.int32).sum((0, 1), dtype=torch.int32)


@pytest.mark.parametrize("cf", [0.5, 1.25], ids=["drops", "cf1.25"])
@pytest.mark.parametrize("n", [2, 4])
def test_split_positions_keep_the_whole_batch_s_copies(cf, n):
    """A copy is kept iff its global position (the shard's offset plus its
    local one) is under the whole batch's capacity: the shards' kept
    copies and positions are the unsplit ones, row for row."""
    arch = "granite-moe-1b-a400m"
    _, _, cfg, layer = _layer(arch, 18, moe=dataclasses.replace(
        get_smoke(arch).moe, capacity_factor=cf))
    x = torch.from_numpy(_x(19, 64, cfg.d_model))
    idx, _, _ = moe._routing(layer, cfg, x)
    cap = moe._capacity(cfg, 64)
    want_pos, want_keep = moe._positions(cfg, idx, cap)
    parts, shards = row_shards(layer, cfg, x, n)
    pos, keep = [], []
    for p, s in zip(parts, shards):
        i, _, _, offset = moe._routing_shard(layer, cfg, p, s)
        lp, k = moe._positions(cfg, i, cap, offset)
        pos.append(lp + offset)
        keep.append(k)
        # the positions the shard keeps fit its compacted buffer
        assert not k.any() or int(lp[k].max()) < moe._buffer_rows(
            cfg, p.shape[0], cap, offset)
    keep = torch.cat(keep)
    assert torch.equal(keep, want_keep)
    assert torch.equal(torch.cat(pos)[keep], want_pos[want_keep])
    assert (int(want_keep.sum()) < idx.numel()) == (cf < 1)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("dropless", [False, True],
                         ids=["train", "dropless"])
@pytest.mark.parametrize("n", [2, 4])
def test_split_moe_apply_matches_the_reference(arch, dispatch, dropless, n):
    """``moe_apply`` of each shard's rows inside ``row_shard``: the rows'
    outputs are the reference's over the whole batch (copies dropped in
    train mode at capacity factor 0.5, none dropless), the aux shares sum
    to its terms, ``expert_fraction`` is its own."""
    x = _x(20, 4, 16, 64)
    over = dict(moe=dataclasses.replace(get_smoke(arch).moe,
                                        dispatch=dispatch,
                                        capacity_factor=0.5))
    ref_cfg, ref_params, cfg, layer = _layer(arch, 21, **over)
    want, want_aux = ref_moe.moe_apply(ref_params, ref_cfg, jnp.asarray(x),
                                       dropless=dropless)
    xt = torch.from_numpy(x)
    _, shards = row_shards(layer, cfg, xt.reshape(64, 64), n)
    ys, auxes = [], []
    for rows, s in zip(xt.chunk(n), shards):
        with moe.row_shard(s):
            y, aux = moe.moe_apply(layer, cfg, rows, dropless=dropless)
        ys.append(y)
        auxes.append(aux)
    assert moe._ROW_SHARD is None
    _close(torch.cat(ys).numpy(), want)
    for k in ("load_balance", "router_z"):
        _close(sum(a[k] for a in auxes).numpy(), want_aux[k])
    for a in auxes:
        _close(a["expert_fraction"].numpy(), want_aux["expert_fraction"])
