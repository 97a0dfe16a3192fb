"""The yardstick against counts made by hand."""
import pytest

from perfbench import counts


def test_product_counts_by_hand():
    # 3 x 4 matrix, 5 nonzeros, 2 vectors, float32:
    # values 5·4 + columns 5·4 + row pointers 4·4 + X 4·2·4 + Y 3·2·4
    assert counts.product_bytes(5, 3, 4, 2, "float32") == \
        20 + 20 + 16 + 32 + 24
    assert counts.product_flops(5, 2) == 20
    # bfloat16 values and vectors: 5·2 + 5·4 + 16 + 4·2·2 + 3·2·2
    assert counts.product_bytes(5, 3, 4, 2, "bfloat16") == \
        10 + 20 + 16 + 16 + 12


def test_bound_is_the_larger_term():
    nb, fl = 3.35e12, 67e12          # one second of each
    assert counts.bound_seconds(nb, fl / 2, "float32") == pytest.approx(1.0)
    assert counts.bound_seconds(nb / 2, fl, "float32") == pytest.approx(1.0)
    assert counts.bound_seconds(0, 989e12, "bfloat16") == pytest.approx(1.0)


def test_fem2d_bound():
    # 20,963,328 nonzeros, 4,194,304 rows: 8 bytes a nonzero, 4 a row
    # pointer (+1), x and y 4 bytes a row
    n, nnz = 4194304, 20963328
    want = nnz * 8 + (n + 1) * 4 + n * 4 + n * 4
    assert counts.product_bytes(nnz, n, n, 1, "float32") == want
    assert counts.product_bound_seconds(nnz, n, n, 1, "float32") == \
        pytest.approx(want / 3.35e12)


TINY = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1,
        "intermediate_size": 32, "vocab_size": 10, "num_hidden_layers": 3,
        "sparse_ffn": {"enabled": True, "density": 0.25, "group_size": 128}}


def test_model_counts_by_hand():
    # head_dim 4; per layer: q 8·8, k 8·4, v 8·4, o 8·8 = 192; w_in and
    # w_gate 8·32 each = 512; w_out 8 rows × 8 kept columns (0.25·32) = 64
    assert counts.sparse_nnz_per_row(0.25, 32) == 8
    assert counts.w_out_nnz(TINY) == 64
    assert counts.token_weight_flops(TINY) == 2 * 3 * (192 + 512 + 64)
    assert counts.head_flops(TINY) == 2 * 8 * 10
    # attention over 5 keys: 4 · layers · 5 · heads · head_dim
    assert counts.attention_flops(TINY, 5) == 4 * 3 * 5 * 2 * 4
    # a prefill of 3 tokens: contexts 1 + 2 + 3, the head once
    assert counts.prefill_flops(TINY, 3) == (
        3 * counts.token_weight_flops(TINY) + counts.head_flops(TINY)
        + 4 * 3 * 6 * 2 * 4)
    assert counts.decode_flops(TINY, 7) == (
        counts.token_weight_flops(TINY) + counts.head_flops(TINY)
        + 4 * 3 * 7 * 2 * 4)


def test_dense_ffn_counts_every_input():
    dense = {**TINY, "sparse_ffn": {"enabled": False}}
    assert counts.w_out_nnz(dense) == 8 * 32


def test_gqa_per_token():
    import json
    from pathlib import Path
    cfg = json.loads((Path(counts.__file__).parent / "configs"
                      / "gqa-2b-rgcsr.json").read_text())
    # per layer: q/o 2048², k/v 2048·512, w_in/w_gate 2048·8192, w_out
    # 2048 × 2048 kept
    per_layer = 2 * 2048 * 2048 + 2 * 2048 * 512 + 2 * 2048 * 8192 \
        + 2048 * 2048
    assert counts.token_weight_flops(cfg) == 2 * 40 * per_layer
    assert counts.w_out_nnz(cfg) == 2048 * 2048
