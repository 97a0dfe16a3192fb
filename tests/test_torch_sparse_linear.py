"""SparseLinear (RgCSR weights, K2's plain version on the CPU) against the
reference's ``impl="ref"`` oracle and ``impl="kernel"`` Pallas path (in
interpret mode, as ``tests/test_sparse_linear.py`` runs it), on the same
parameters carried across as numpy arrays.

Tolerances: fp32 within rtol = atol = 1e-4 (the reference's own bar for
kernel against oracle); bf16 within 3e-2 of the largest reference value
(the frameworks round bf16 sums at other places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same_fields, host, numpy_fields

from repro.configs import get_smoke as ref_get_smoke
from repro.kernels import ops as ref_ops
from repro.models import ffn as ref_ffn
from repro.models.spec import init_from_spec as ref_init_from_spec
from repro.serve import Engine as RefEngine, ServeConfig as RefServeConfig
from repro_torch.configs import get_smoke
from repro_torch.configs.base import SparsityConfig
from repro_torch.kernels import ops, plan_from_params, warm_plans_from_params
from repro_torch.models import ffn
from repro_torch.models import LanguageModel
from repro_torch.models.spec import count_params, init_from_spec
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
SHAPES = [(64, 140), (96, 200), (128, 64)]


def _cfgs(impl, density=0.25):
    sp = dict(enabled=True, density=density, group_size=128, impl=impl)
    ref = dataclasses.replace(ref_get_smoke("granite-3-2b"),
                              sparsity=SparsityConfig(**sp))
    return ref, dataclasses.replace(get_smoke("granite-3-2b"),
                                    sparsity=SparsityConfig(**sp))


def _ref_params(cfg, d_in, d_out):
    """The reference's layer: values from its spec, structure from
    ``sparse_linear_init_mask`` (as ``tests/test_sparse_linear.py``)."""
    params = ref_init_from_spec(KEY, ref_ffn.sparse_linear_spec(cfg, d_in,
                                                                d_out))
    (params["columns2d"], params["chunk_group"],
     params["chunk_first"]) = ref_ffn.sparse_linear_init_mask(KEY, cfg, d_in,
                                                              d_out)
    return params


def _port_params(ref_params):
    return {k: torch.from_numpy(np.array(v)) for k, v in ref_params.items()}


def _x(seed, t, d_in):
    return np.random.default_rng(seed).standard_normal((t, d_in)).astype(
        np.float32)


@pytest.mark.parametrize("t", [1, 3, 17])
@pytest.mark.parametrize("d_in,d_out", SHAPES)
def test_apply_matches_both_reference_impls(d_in, d_out, t):
    ref_cfg, cfg = _cfgs("ref")
    ref_cfg_k, cfg_k = _cfgs("kernel")
    params = _ref_params(ref_cfg, d_in, d_out)
    x = _x(d_in + t, t, d_in)
    want = {impl: np.asarray(ref_ffn.sparse_linear_apply(
        params, c, jnp.asarray(x), d_out))
        for impl, c in (("ref", ref_cfg), ("kernel", ref_cfg_k))}
    p = _port_params(params)
    for c in (cfg, cfg_k):
        got = ffn.sparse_linear_apply(p, c, torch.from_numpy(x), d_out)
        assert got.shape == (t, d_out) and got.dtype == torch.float32
        for w in want.values():
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_apply_bf16_matches_the_reference(impl):
    ref_cfg, cfg = _cfgs(impl)
    d_in, d_out = 96, 200
    params = _ref_params(ref_cfg, d_in, d_out)
    x = _x(5, 2, 3 * d_in).reshape(2, 3, d_in)   # leading dims kept
    want = np.asarray(ref_ffn.sparse_linear_apply(
        params, ref_cfg, jnp.asarray(x, jnp.bfloat16), d_out).astype(
            jnp.float32))
    got = ffn.sparse_linear_apply(_port_params(params), cfg,
                                  torch.from_numpy(x).bfloat16(), d_out)
    assert got.shape == (2, 3, d_out) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=3e-2 * np.abs(want).max())


@pytest.mark.parametrize("d_in,d_out", SHAPES)
def test_plan_from_params_equals_the_reference(d_in, d_out):
    ref_cfg, _ = _cfgs("kernel")
    params = _ref_params(ref_cfg, d_in, d_out)
    ref_plan = ref_ops.plan_from_params(params, jnp.float32, d_out=d_out,
                                        d_in=d_in, group_size=128)
    plan = plan_from_params(_port_params(params), torch.float32, d_out=d_out,
                            d_in=d_in, group_size=128)
    assert_same_fields(ref_plan, plan)
    # the same arrays through the reference's own carrier give the same plan
    assert_same_fields(plan, ops.plan_from_numpy(numpy_fields(ref_plan),
                                                 device="cpu"))


def test_init_mask_draws_the_reference_columns():
    ref_cfg, cfg = _cfgs("kernel")
    d_in, d_out = 96, 200
    seed = int(jax.random.randint(KEY, (), 0, 2 ** 31 - 1))
    got = ffn.sparse_linear_init_mask(seed, cfg, d_in, d_out, device="cpu")
    want = ref_ffn.sparse_linear_init_mask(KEY, ref_cfg, d_in, d_out)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("d_in,d_out", SHAPES)
def test_spec_and_init_match_the_reference_structure(d_in, d_out):
    ref_cfg, cfg = _cfgs("kernel")
    spec = ffn.sparse_linear_spec(cfg, d_in, d_out)
    ref_spec = ref_ffn.sparse_linear_spec(ref_cfg, d_in, d_out)
    assert sorted(spec) == sorted(ref_spec)
    for name, p in spec.items():
        assert (p.shape, p.axes, p.scale) == (ref_spec[name].shape,
                                              ref_spec[name].axes,
                                              ref_spec[name].scale), name
    assert count_params(spec) == sum(int(np.prod(p.shape))
                                     for p in ref_spec.values())
    # the port's own draw: a valid layer (sorted distinct columns per lane,
    # the reference's step tables)
    gen = torch.Generator().manual_seed(7)
    params = init_from_spec(spec, gen, device="cpu")
    ref_params = jax.device_get(ref_init_from_spec(KEY, ref_spec))
    for name in ("chunk_group", "chunk_first"):
        np.testing.assert_array_equal(params[name].numpy(), ref_params[name])
    k = spec["values2d"].shape[0] // -(-d_out // 128)
    cols = params["columns2d"].reshape(-1, k, 128).transpose(1, 2)
    assert (cols.diff(dim=-1) > 0).all() and cols.min() >= 0 \
        and cols.max() < d_in


def _layer(params, cfg, d_in, d_out):
    return ffn.SparseLinear(_port_params(params), cfg, d_in=d_in,
                            d_out=d_out)


def test_layer_keeps_its_plan_until_the_values_change():
    ref_cfg, cfg = _cfgs("kernel")
    d_in, d_out = 96, 200
    layer = _layer(_ref_params(ref_cfg, d_in, d_out), cfg, d_in, d_out)
    x = torch.from_numpy(_x(1, 4, d_in))
    y = layer(x)
    assert layer.plan_builds == 1
    for _ in range(3):
        torch.testing.assert_close(layer(x), y, rtol=0, atol=0)
    assert layer.plan_builds == 1
    layer(x.bfloat16())                        # one plan per compute dtype
    layer(x.bfloat16())
    assert layer.plan_builds == 2
    with torch.no_grad():
        layer.values2d.mul_(2.0)               # written in place
    torch.testing.assert_close(layer(x), 2 * y)
    assert layer.plan_builds == 3
    layer.values2d = torch.nn.Parameter(-layer.values2d.detach(),
                                        requires_grad=False)   # replaced
    torch.testing.assert_close(layer(x), -2 * y)
    assert layer.plan_builds == 4
    layer(x)
    assert layer.plan_builds == 4


def test_layer_bf16_copy_is_made_once():
    ref_cfg, cfg = _cfgs("kernel")
    layer = _layer(_ref_params(ref_cfg, 64, 140), cfg, 64, 140)
    a = layer.cast("values2d", torch.bfloat16)
    assert layer.cast("values2d", torch.bfloat16) is a
    assert layer.cast("values2d", torch.float32) is layer.values2d
    torch.testing.assert_close(a, layer.values2d.bfloat16(), rtol=0, atol=0)


def test_zero_weight_at_column_zero_is_skipped_harmlessly():
    """K2 skips slots that look like padding (value 0 at column 0); a
    weight that is exactly 0 there contributes nothing either way."""
    ref_cfg, cfg = _cfgs("kernel")
    d_in, d_out = 64, 140
    params = _ref_params(ref_cfg, d_in, d_out)
    vals = np.array(params["values2d"])
    vals[np.asarray(params["columns2d"]) == 0] = 0.0
    params = dict(params, values2d=jnp.asarray(vals))
    x = _x(2, 5, d_in)
    want = np.asarray(ref_ffn.sparse_linear_apply(params, ref_cfg,
                                                  jnp.asarray(x), d_out))
    got = _layer(params, cfg, d_in, d_out)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_plans_warmed_one_per_layer_where_the_reference_warms_none():
    """The reference stacks its layers, so its warm-up skips them
    (``plans_warmed == 0``); the port holds one module per layer and warms
    each layer's plan at the compute dtype."""
    ref_cfg, cfg = _cfgs("kernel")
    ref_engine = RefEngine(ref_cfg, RefServeConfig(max_seq=16))
    assert ref_engine.plans_warmed == 0
    engine = Engine(cfg, ServeConfig(max_seq=16), device="cpu")
    assert engine.plans_warmed == cfg.n_layers == 2
    layers = [b.ffn.w_out for b in engine.model.layers]
    assert [lay.plan_builds for lay in layers] == [1, 1]
    engine.generate(np.zeros((1, 4), np.int32), max_new_tokens=3)
    assert [lay.plan_builds for lay in layers] == [1, 1]
    dense = Engine(dataclasses.replace(cfg, sparsity=SparsityConfig()),
                   ServeConfig(max_seq=16), device="cpu")
    assert dense.plans_warmed == 0
    model = LanguageModel(cfg, device="cpu")
    assert warm_plans_from_params(model, torch.float32) == 2
    assert host(model.layers[0].ffn.w_out.values2d).dtype == np.float32


def test_x_is_copied_once_into_the_kernels_layout():
    """``sparse_linear_apply`` hands K2 ``x.reshape(-1, d_in).T``; the one
    copy of X is ``ops._gatherable`` making it a contiguous (d_in, T)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    copies = []

    class CountCopies(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket in (torch.ops.aten.clone,
                                       torch.ops.aten.copy_,
                                       torch.ops.aten._to_copy) \
                    and args[0].is_floating_point() \
                    and args[0].numel() == x.numel():
                copies.append((func.overloadpacket.__name__,
                               tuple(out.shape), out.is_contiguous()))
            return out

    ref_cfg, cfg = _cfgs("kernel")
    d_in, d_out = 96, 200
    layer = _layer(_ref_params(ref_cfg, d_in, d_out), cfg, d_in, d_out)
    x = torch.from_numpy(_x(3, 6, d_in)).reshape(2, 3, d_in)
    layer(x)                                   # builds the plan
    with CountCopies():
        layer(x)
    assert copies == [("clone", (d_in, 6), True)]
