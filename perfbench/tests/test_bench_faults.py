"""The comparison that decides ``correct`` fails what it must: the control
(the reference in the program's place, a precision below the one the
configuration states) and the faults a cell can have, each planted under
a whole run of the harness (its look for a card skipped), at small sizes
on the CPU.  The program itself passes on the same runs."""
import time

import numpy as np
import pytest
import torch

from conftest import small
from perfbench import harness


def _run(bench, cell, seed=7, substitute=None, seconds=0.5):
    cfg, tr = small(cell)
    res, checks = harness.run_cell(bench, cell, seed, seconds, False, "cpu",
                                   time.perf_counter(), config_override=cfg,
                                   traffic_override=tr, substitute=substitute)
    return res


@pytest.mark.parametrize("cell", ["fem2d.spmv", "fem2d.spmm64",
                                  "gqa2b.chat"])
def test_program_passes(bench, cell):
    res = _run(bench, cell)
    assert res["correct"], res["checks"]


# ------------------------------------------------------- sparse products

def _program(st):
    from repro_torch import core
    a = st.matrix
    return (lambda x: core.spmv(a, x, impl="kernel")) if st.d == 1 else \
        (lambda x: core.spmm(a, x, impl="kernel"))


def unchanged(st):
    """A step that returns its state unchanged."""
    return lambda x: x.clone()


def altered(st):
    """One answer altered where it is produced."""
    prog = _program(st)

    def run(x):
        y = prog(x)
        y.view(-1)[y.numel() // 2] += 1.0
        return y
    return run


def half_batch(st):
    """Half of the vectors left out, each filled with the mean of the
    rest."""
    prog = _program(st)

    def run(x):
        h = x.shape[1] // 2
        y = prog(x[:, :h].contiguous())
        return torch.cat([y, y.mean(1, keepdim=True).expand(-1, x.shape[1]
                                                          - h)], 1)
    return run


@pytest.mark.parametrize("cell,fault", [
    ("fem2d.spmv", unchanged), ("fem2d.spmv", altered),
    ("fem2d.spmm64", unchanged), ("fem2d.spmm64", altered),
    ("fem2d.spmm64", half_batch)], ids=lambda v: getattr(v, "__name__", v))
def test_sparse_fault_is_not_correct(bench, cell, fault):
    res = _run(bench, cell, substitute=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["fem2d.spmv", "fem2d.spmm64"])
def test_sparse_control_is_not_correct(bench, cell):
    """The reference computed from TF32-rounded inputs in the program's
    place: the float32 configuration's next precision down."""
    runner = bench.runner(bench.traffic(bench.cell(cell)["traffic"]))
    res = _run(bench, cell, substitute=runner.control)
    assert not res["correct"], res["checks"]


# ------------------------------------------------------------- serving

def _fused(engine, edit):
    """Wrap the session's fused decode dispatch: ``edit(block, cur)``
    changes the token block it returns (``cur``: each slot's token before
    the chunk)."""
    orig = engine._fused_decode

    def run(caches, cur_tok, *args):
        cur = cur_tok[:, 0].cpu().numpy().copy()
        out = orig(caches, cur_tok, *args)
        edit(out[0], cur)
        return out
    engine._fused_decode = run


def stale_state(engine):
    """A decode step that returns its state unchanged: every step of a
    chunk yields the token the slot held before it."""
    _fused(engine, lambda block, cur: block.__setitem__(
        slice(None), cur[None, :]))


def altered_token(engine):
    """Each token altered where it is produced."""
    vocab = engine.model.cfg.vocab
    _fused(engine, lambda block, cur: block.__setitem__(
        slice(None), (block + 1) % vocab))


def half_slots(engine):
    """Half of the batch's slots left out: their tokens come back as 0."""
    def edit(block, cur):
        block[:, block.shape[1] // 2:] = 0
    _fused(engine, edit)


@pytest.mark.parametrize("fault", [stale_state, altered_token, half_slots],
                         ids=lambda f: f.__name__)
def test_serving_fault_is_not_correct(bench, fault):
    res = _run(bench, "gqa2b.chat", substitute=fault, seconds=1.0)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("seed", [1, 2])
def test_serving_control_reads_above_the_limit(bench, seed):
    """fp8 (e4m3, a scale a tensor) projections in the program's place, at
    the published widths with the depth cut to 2 layers: at each position
    of 4 × 128 tokens, the token the control puts first lies further below
    the float32 reference's best than the limit allows.  (The control need
    not decode: its reading is the gap of its first choice on the same
    tokens.)"""
    from perfbench.reference import gqa_lm as ref
    cfg = {**bench.config("gqa-2b-rgcsr"), "num_hidden_layers": 2}
    w = bench.maker(cfg).make_weights(cfg, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    seqs = [torch.randint(0, cfg["vocab_size"], (128,), generator=g)
            for _ in range(4)]
    pos = [torch.arange(128)] * 4
    want = ref.logits_at(w, cfg, seqs, pos)
    low = ref.logits_at(w, cfg, seqs, pos, quant="fp8")
    gap = max(float((a.max(-1).values
                     - a.gather(-1, b.argmax(-1)[:, None])[:, 0]).max())
              for a, b in zip(want, low))
    assert np.isfinite(gap) and gap > float(cfg["limits"]["logit_gap"])
