"""The frozen plain references against the port (and the sparse one
against a dense float64 product), at small sizes on the CPU."""
import numpy as np
import pytest
import torch

from conftest import FEM_SMALL, GQA_SMALL
from perfbench.reference import csr as ref_csr
from perfbench.reference import gqa_lm as ref_lm


def _fem(bench):
    cfg = {**bench.config("fem2d_2048"), **FEM_SMALL}
    return cfg, bench.maker(cfg).make_csr(cfg)


def test_maker_counts_match_the_configuration(bench):
    cfg, (values, columns, row_ptr, shape) = _fem(bench)
    assert shape == (4096, 4096) and len(values) == cfg["nnz"]
    dense = np.zeros(shape)
    rows = np.repeat(np.arange(shape[0]), np.diff(row_ptr))
    dense[rows, columns] = values
    assert np.array_equal(dense, dense.T)
    assert np.allclose(dense.sum(1)[[0, 65]], [2.0, 0.0])


@pytest.mark.parametrize("d", [1, 5])
def test_csr_reference_against_dense(bench, d):
    _, (values, columns, row_ptr, shape) = _fem(bench)
    rows = np.repeat(np.arange(shape[0]), np.diff(row_ptr))
    dense = np.zeros(shape)
    dense[rows, columns] = values
    x = np.random.default_rng(d).standard_normal(
        (shape[1],) if d == 1 else (shape[1], d))
    y, scale = ref_csr.product(torch.from_numpy(values),
                               torch.from_numpy(columns),
                               torch.from_numpy(row_ptr), torch.from_numpy(x))
    assert np.allclose(y.numpy(), dense @ x, rtol=1e-12, atol=1e-12)
    assert np.allclose(scale.numpy(), np.abs(dense) @ np.abs(x))


@pytest.mark.parametrize("d", [1, 64])
def test_port_product_within_float32_of_the_reference(bench, d):
    from repro_torch import core
    cfg, (values, columns, row_ptr, shape) = _fem(bench)
    a = core.from_csr(values, columns, row_ptr, shape, "rgcsr",
                      device="cpu")
    x = torch.randn((shape[1],) if d == 1 else (shape[1], d),
                    generator=torch.Generator().manual_seed(d))
    got = core.spmv(a, x, impl="kernel") if d == 1 else \
        core.spmm(a, x, impl="kernel")
    want, scale = ref_csr.product(*(torch.from_numpy(t) for t in
                                    (values, columns, row_ptr)), x)
    assert ref_csr.relative_error(got, want, scale) < 1e-6


def test_tf32_rounding():
    t = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1 + 2**-10])
    r = ref_csr.round_tf32(t)
    assert r.tolist() == [1.0, 1.0, 1.0 + 2**-9, 1.0 + 2**-10]


def _gqa(bench, dtype="float32"):
    cfg = {**bench.config("gqa-2b-rgcsr"), **GQA_SMALL}
    cfg["serving"] = {**cfg["serving"], "dtype": dtype,
                      "kv_cache_dtype": dtype}
    maker = bench.maker(cfg)
    return cfg, maker, maker.make_weights(cfg, 11, "cpu")


def test_gqa_reference_against_the_port_forward(bench):
    from repro_torch.models import LanguageModel
    cfg, maker, w = _gqa(bench)
    model = LanguageModel(maker.model_config(cfg), params=w, device="cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (1, 40),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model({"tokens": tokens})[0][0, :, :cfg["vocab_size"]]
    want = ref_lm.logits_at(w, cfg, [tokens[0]], [torch.arange(40)])[0]
    tol = 1e-4 * (1 + want.abs().max())
    assert (got - want).abs().max() <= tol


def test_gqa_reference_against_prefill_and_cached_decode(bench):
    from repro_torch.models import LanguageModel
    cfg, maker, w = _gqa(bench)
    model = LanguageModel(maker.model_config(cfg), params=w, device="cpu")
    seq = torch.randint(0, cfg["vocab_size"], (30,),
                        generator=torch.Generator().manual_seed(2))
    prompt = 20
    want = ref_lm.logits_at(w, cfg, [seq], [torch.arange(prompt - 1, 30)])[0]
    got = []
    with torch.no_grad():
        logits, caches = model.prefill({"tokens": seq[None, :prompt]}, 64)
        got.append(logits[0, -1, :cfg["vocab_size"]])
        for i in range(prompt, 30):
            logits, caches = model.decode_step(caches, seq[None, i:i + 1]
                                               .int())
            got.append(logits[0, -1, :cfg["vocab_size"]])
    got = torch.stack(got)
    assert (got - want).abs().max() <= 1e-4 * (1 + want.abs().max())


def test_dense_w_out_scatters_every_nonzero(bench):
    cfg, maker, w = _gqa(bench)
    lay = w["layers"][0]["ffn"]["w_out"]
    dense = ref_lm.dense_w_out(lay, cfg["hidden_size"],
                               cfg["intermediate_size"])
    k = lay["values2d"].shape[0]           # one group: k kept a row
    assert ((dense != 0).sum(1) == k).all()
    row = 5
    cols = lay["columns2d"][:, row].long()
    assert torch.equal(dense[row, cols], lay["values2d"][:, row].float())
