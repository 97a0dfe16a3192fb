"""The port's training path against ``repro.train`` / ``repro.launch.steps``.

The same numpy inputs (batches from ``make_batch``, gradients and trees
from a seed, parameters carried across with ``params_from_numpy``) go
through both packages: batches byte-equal, the optimizers within rtol
1e-5 / atol 1e-6, losses within 1e-5 (fp32), three train steps within
1e-4 (losses, grad norm) and 1e-5 (parameters), and a checkpoint that the
reference's ``Trainer`` wrote resumes in the port's.
"""
import dataclasses
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.configs.base import SparsityConfig as RefSparsityConfig
from repro.launch import steps as ref_steps
from repro.models import LanguageModel as RefModel
from repro.train import data as ref_data
from repro.train import optimizer as ref_opt
from repro.train.trainer import TrainConfig as RefTrainConfig
from repro.train.trainer import Trainer as RefTrainer
from repro_torch.configs import get_smoke
from repro_torch.configs.base import SparsityConfig
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.models import LanguageModel, ffn, params_from_numpy
from repro_torch.models.model import port_layout
from repro_torch.train import checkpoint, data, optimizer
from repro_torch.train.fault import FaultInjector
from repro_torch.train.trainer import TrainConfig, Trainer

torch.set_num_threads(1)

FP32 = dict(dtype="float32", kv_cache_dtype="float32")
SEQ, BATCH = 16, 4


# --------------------------------------------------------------------- data


@pytest.mark.parametrize("family", ["dense", "vlm", "audio"])
def test_make_batch_is_byte_equal(family):
    kw = dict(vocab=97, seq_len=24, global_batch=8, seed=3, family=family,
              d_frontend=12, frontend_tokens=5)
    for step, host, hosts in ((0, 0, 1), (7, 1, 2)):
        want = ref_data.make_batch(ref_data.DataConfig(**kw), step,
                                   host_id=host, n_hosts=hosts)
        got = data.make_batch(data.DataConfig(**kw), step, host_id=host,
                              n_hosts=hosts)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k
    it = data.SyntheticLM(data.DataConfig(**kw)).seek(4)
    np.testing.assert_array_equal(next(it)["tokens"], ref_data.make_batch(
        ref_data.DataConfig(**kw), 4)["tokens"])


# ---------------------------------------------------------------- optimizer


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"kernel": rng.standard_normal((6, 5)).astype(np.float32),
            "stack": rng.standard_normal((3, 4, 2)).astype(np.float32),
            "scale": (1 + 0.1 * rng.standard_normal(7)).astype(np.float32),
            "columns": rng.integers(0, 9, (4, 3)).astype(np.int32)}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6, err_msg=what)


def _leaves(state):
    """``{path: array}`` of a nested optimizer state (either package)."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            for sub, a in _leaves(v).items():
                out[f"{k}/{sub}"] = a
        else:
            out[k] = np.asarray(v.detach() if torch.is_tensor(v) else v)
    return out


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_reference(name):
    kw = dict(name=name, lr=0.05, warmup_steps=2, decay_steps=20,
              weight_decay=0.1)
    ref_init, ref_update = ref_opt.make_optimizer(ref_opt.OptimizerConfig(
        **kw))
    init, update = optimizer.make_optimizer(optimizer.OptimizerConfig(**kw))
    tree = _tree(0)
    ref_p = {k: jnp.asarray(v) for k, v in tree.items()}
    p = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    ref_s, s = ref_init(ref_p), init(p)
    for step in range(5):
        g = {k: v for k, v in _tree(10 + step).items()
             if v.dtype == np.float32}
        ref_g = dict({k: jnp.asarray(v) for k, v in g.items()},
                     columns=np.zeros((4, 3), jax.dtypes.float0))
        ref_p, ref_s = ref_update(ref_g, ref_s, ref_p)
        p, s = update({k: torch.from_numpy(v) for k, v in g.items()}, s, p)
    for k in tree:
        _close(p[k], ref_p[k], k)
    assert p["columns"].dtype == torch.int32
    np.testing.assert_array_equal(p["columns"], tree["columns"])
    want, got = _leaves(jax.device_get(ref_s)), _leaves(s)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == (
            np.int32 if k == "step" else np.float32), k
        _close(got[k], want[k], k)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedules_clipping_and_decay_mask_match_reference(schedule):
    kw = dict(lr=2e-3, warmup_steps=10, decay_steps=100, schedule=schedule)
    ref_fn = ref_opt._schedule(ref_opt.OptimizerConfig(**kw))
    fn = optimizer._schedule(optimizer.OptimizerConfig(**kw))
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        _close(fn(torch.tensor(step, dtype=torch.int32)),
               ref_fn(jnp.asarray(step, jnp.int32)), f"step {step}")
    tree = _tree(1)
    floats = {k: v for k, v in tree.items() if v.dtype == np.float32}
    for max_norm in (0.5, 100.0):
        ref_c, ref_n = ref_opt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in floats.items()}, max_norm)
        got_c, got_n = optimizer.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in tree.items()}, max_norm)
        _close(got_n, ref_n, "norm")
        for k in floats:
            _close(got_c[k], ref_c[k], k)
        assert got_c["columns"] is not None
    assert optimizer._decay_mask({k: torch.from_numpy(v) for k, v in
                                  tree.items()}) == \
        ref_opt._decay_mask({k: jnp.asarray(v) for k, v in tree.items()})


# --------------------------------------------------------------- the model

_PAIRS = {}


def _pair(sparse: bool, arch: str = "granite-3-2b"):
    """(reference cfg, reference params, port cfg, port tree): ``arch``'s
    smoke config in fp32, the FFN in RgCSR through the segment sum when
    ``sparse`` (the launchers' ``--sparse-ffn``)."""
    if (sparse, arch) not in _PAIRS:
        ref_cfg = dataclasses.replace(ref_get_smoke(arch), **FP32)
        cfg = dataclasses.replace(get_smoke(arch), **FP32)
        if sparse:
            sk = dict(enabled=True, density=0.25, group_size=128, impl="ref")
            ref_cfg = dataclasses.replace(
                ref_cfg, sparsity=RefSparsityConfig(**sk))
            cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(**sk))
        ref_params = RefModel(ref_cfg).init(jax.random.PRNGKey(0))
        _PAIRS[sparse, arch] = (ref_cfg, ref_params, cfg,
                                jax.device_get(ref_params))
    return _PAIRS[sparse, arch]


def _batch(cfg, step):
    """``make_batch``'s batch for ``cfg``'s family: frames (audio) or
    patch embeddings (vlm) beside the tokens."""
    return data.make_batch(data.DataConfig(
        vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH, seed=1,
        family=cfg.family, d_frontend=cfg.d_frontend,
        frontend_tokens=cfg.frontend_tokens), step)


def _port_model(cfg, host):
    model = LanguageModel(cfg, params_from_numpy(cfg, host, device="cpu"))
    return model.requires_grad_(True)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_loss_matches_reference(sparse):
    ref_cfg, ref_params, cfg, host = _pair(sparse)
    batch = _batch(cfg, 0)
    batch["labels"][0, :3] = -1                  # masked positions
    want, want_m = RefModel(ref_cfg).loss(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    got, got_m = _port_model(cfg, host).loss(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.requires_grad
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    assert set(got_m) == set(want_m) == {"ce", "loss"}


@pytest.mark.parametrize("arch,sparse", [("granite-moe-1b-a400m", False),
                                         ("minicpm3-4b", True),
                                         ("deepseek-v3-671b", False),
                                         ("mamba2-780m", False),
                                         ("recurrentgemma-9b", True),
                                         ("seamless-m4t-medium", True),
                                         ("pixtral-12b", True)],
                         ids=["granite-moe", "minicpm3-sparse",
                              "deepseek-v3", "mamba2",
                              "recurrentgemma-sparse", "seamless-sparse",
                              "pixtral-sparse"])
def test_family_loss_terms_match_reference(arch, sparse):
    """CE, the load-balance term (summed over the MoE layers, router-z in
    the total), the MTP loss and the total, within 1e-5 — capacity drops
    in train mode included (64 tokens on 4 experts); the encoder's frames
    and the vision patches (their positions unlabelled) in the batch."""
    ref_cfg, ref_params, cfg, host = _pair(sparse, arch)
    batch = _batch(cfg, 0)
    batch["labels"][1, :2] = -1
    want, want_m = RefModel(ref_cfg).loss(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model(cfg, host)
    with torch.no_grad():
        got, got_m = model.loss({k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                               atol=1e-5)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        _, _, aux = model({k: torch.from_numpy(v) for k, v in inputs.items()},
                          mode="train")
    _, _, ref_aux = RefModel(ref_cfg).forward(
        ref_params, {k: jnp.asarray(v) for k, v in inputs.items()},
        mode="train")
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(aux[k].item(), float(ref_aux[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-v3-671b"])
def test_one_adamw_step_of_the_moe_families_matches(arch):
    """No weight decay (see below): metrics within 1e-4, every parameter
    within 1e-5; the router's bias takes a zero gradient in both and
    stays zero.  Adam's eps is 1e-6 here on both sides: a first step
    moves each weight by lr·g/(|g| + eps), and a few of deepseek-v3's
    gradients are ~6e-9, where the packages' fp32 gradients, equal
    within 1e-9, would still move the weight by different fractions of
    lr at eps = 1e-8."""
    metrics, got, want, _ = _run_both(1, 1, arch=arch, sparse=False,
                                      weight_decay=0.0, eps=1e-6)
    _metrics_close(metrics)
    assert got.keys() == want.keys()
    for k, a in got.items():
        np.testing.assert_allclose(a, want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    biases = [k for k in got if k.endswith("router/bias")]
    assert len(biases) == (2 if arch == "deepseek-v3-671b" else 0)
    assert all(not got[k].any() for k in biases)


@pytest.mark.parametrize("arch,sparse", [("mamba2-780m", False),
                                         ("recurrentgemma-9b", True)],
                         ids=["mamba2", "recurrentgemma-sparse"])
def test_three_train_steps_of_the_recurrent_families_match(arch, sparse):
    """Three AdamW steps without weight decay through the SSD chunks and
    the log-depth scan (and the segment sum of recurrentgemma's RgCSR
    FFN): metrics within 1e-4, every parameter within 1e-5.  Adam's eps
    is 1e-5 on both sides: some of the RG-LRU gates' gradients are
    ~1e-7, where the packages' fp32 gradients (equal within ~6e-9, the
    other summation order of the scan) move a weight by lr·g/(|g| + eps),
    fractions of lr that differ by ~1e-5 at eps = 1e-8.  A gradient far
    below eps hardly moves its weight, so the next test holds the
    gradients themselves."""
    metrics, got, want, _ = _run_both(1, 3, arch=arch, sparse=sparse,
                                      weight_decay=0.0, eps=1e-5)
    _metrics_close(metrics)
    assert got.keys() == want.keys()
    for k, a in got.items():
        np.testing.assert_allclose(a, want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("arch,sparse", [("mamba2-780m", False),
                                         ("recurrentgemma-9b", True)],
                         ids=["mamba2", "recurrentgemma-sparse"])
def test_first_step_gradients_of_the_recurrent_families_match(arch, sparse):
    """The loss's gradient, leaf by leaf, against the reference's: within
    1e-4 of the leaf's largest |gradient| (and 1e-5 relative), so a wrong
    gradient on a leaf of small gradients (the RG-LRU gates, the SSD's
    ``a_log``) shows here even where Adam's eps hides it in a step."""
    ref_cfg, ref_params, cfg, host = _pair(sparse, arch)
    batch = _batch(cfg, 0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = jax.grad(lambda p: RefModel(ref_cfg).loss(p, jbatch)[0],
                     allow_int=True)(ref_params)
    grads = jax.tree_util.tree_map(      # integer leaves: float0 tangents
        lambda g, p: np.zeros(p.shape, p.dtype)
        if g.dtype == jax.dtypes.float0 else np.asarray(g),
        grads, ref_params)
    want = port_layout(cfg, grads)
    model = _port_model(cfg, host)
    loss, _ = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    leaves = {k: t for k, t in model.tensors().items() if t.requires_grad}
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert set(got) == {k for k, a in want.items() if a.dtype.kind == "f"}
    for k, g in got.items():
        scale = float(np.abs(want[k]).max())
        assert scale > 0, k
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-5,
                                   atol=1e-4 * scale, err_msg=k)


def test_weight_decay_skips_each_layers_recurrent_vectors():
    """One step with weight decay 0.1 on smoke recurrentgemma: the port
    decays no 1-D vector of a recurrent layer (``lam``, the conv's ``b``)
    nor a norm scale, and differs from the reference by exactly the
    reference's decay on those of the body layers, whose stacked (2-D)
    arrays its mask decays; the prefix layers' vectors are 1-D in both
    and stay undecayed, and every 2-D weight is decayed in both.  Adam's
    eps is 1e-5, as in the test above."""
    metrics, got, want, _ = _run_both(1, 1, arch="recurrentgemma-9b",
                                      sparse=False, weight_decay=0.1,
                                      eps=1e-5)
    _metrics_close(metrics)
    cfg = _pair(False, "recurrentgemma-9b")[2]
    ocfg = optimizer.OptimizerConfig(lr=3e-3, warmup_steps=2,
                                     decay_steps=10, eps=1e-5)
    shrink = 1 - 0.1 * float(optimizer._schedule(ocfg)(1))
    n_pre = len(cfg.prefix_pattern)
    decayed = {}
    for k, a in got.items():
        parts = k.split("/")
        if k.startswith("layers/") and a.ndim == 1 and \
                int(parts[1]) >= n_pre:
            if parts[-1] != "b":     # the conv bias is still ~1e-3
                assert not np.allclose(a, want[k], rtol=1e-5, atol=1e-5), k
            a = a * shrink                       # the reference's decay
            decayed[parts[-1]] = decayed.get(parts[-1], 0) + 1
        np.testing.assert_allclose(a, want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    n_rec = sum(k == "rec" for k in cfg.layer_pattern) * cfg.pattern_repeats
    n_body = cfg.n_layers - n_pre
    assert decayed == {"lam": n_rec, "b": n_rec, "scale": 2 * n_body}


def test_segment_sum_chunks_keep_the_forward_and_give_the_gradients(
        monkeypatch):
    """In chunks or whole, the same forward bits on the CPU; the backward
    matches autograd of the dense-equivalent product in float64."""
    _, _, cfg, host = _pair(True)
    w = {k: torch.from_numpy(np.array(v[0])) for k, v in
         host["stack"]["body"]["0_attn"]["ffn"]["w_out"].items()}
    d_in, d_out = cfg.d_ff, cfg.d_model
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 5, d_in)).astype(np.float32))
    whole = ffn.sparse_linear_apply(w, cfg, x, d_out)
    monkeypatch.setattr(ffn, "_GATHER_ELEMS", 128 * 5 * 3)   # 7+ chunks
    vals = w["values2d"].double().requires_grad_(True)
    xd = x.double().requires_grad_(True)
    got = ffn.sparse_linear_apply(dict(w, values2d=vals), cfg, xd, d_out)
    assert torch.equal(ffn.sparse_linear_apply(w, cfg, x, d_out), whole)
    dy = torch.from_numpy(np.random.default_rng(3).standard_normal(
        got.shape))
    gv, gx = torch.autograd.grad(got, (vals, xd), dy)
    # the dense equivalent: W[g·G + lane, columns[k, lane]] = values[k, lane]
    g = cfg.sparsity.group_size
    rows = (w["chunk_group"].long().repeat_interleave(8)[:, None] * g
            + torch.arange(g)).reshape(-1)
    vals2 = vals.detach().clone().requires_grad_(True)
    dense = torch.zeros((rows.max() + 1, d_in), dtype=torch.float64)
    dense = dense.index_put((rows, w["columns2d"].reshape(-1).long()),
                            vals2.reshape(-1), accumulate=True)
    x2 = x.double().requires_grad_(True)
    want = (x2 @ dense[:d_out].T)
    wv, wx = torch.autograd.grad(want, (vals2, x2), dy)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gv, wv, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gx, wx, rtol=1e-12, atol=1e-12)


def _run_both(micro: int, n_steps: int, arch="granite-3-2b", sparse=True,
              remat="none", **okw):
    """``n_steps`` train steps of both packages from the same parameters
    on the same batches (both under ``remat``): (per-step metrics pairs,
    the port's tensors, the reference's parameters in the port's layout,
    the port's state)."""
    ref_cfg, ref_params, cfg, host = _pair(sparse, arch)
    ref_cfg = dataclasses.replace(ref_cfg, remat=remat)
    cfg = dataclasses.replace(cfg, remat=remat)
    okw = dict(dict(lr=3e-3, warmup_steps=2, decay_steps=10), **okw)
    ref_fn, ref_init = ref_steps.make_train_step(
        RefModel(ref_cfg), ref_opt.OptimizerConfig(**okw), micro)
    ref_fn = jax.jit(ref_fn)
    model = _port_model(cfg, host)
    step_fn, init = steps.make_train_step(
        model, optimizer.OptimizerConfig(**okw), micro)
    params = model.tensors()
    ref_p, ref_s, state = ref_params, ref_init(ref_params), init(params)
    metrics = []
    for step in range(n_steps):
        batch = _batch(cfg, step)
        ref_p, ref_s, want = ref_fn(ref_p, ref_s, batch)
        params, state, got = step_fn(params, state, batch)
        metrics.append((got, want))
    got = {k: t.detach().numpy() for k, t in params.items()}
    return metrics, got, port_layout(cfg, jax.device_get(ref_p)), state


def _metrics_close(metrics):
    for got, want in metrics:
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)


def _loss_and_grads(cfg, host, batch):
    """The port's loss and every parameter's gradient, and the number of
    matrix products (``aten`` ``mm``/``bmm``/``addmm``/``baddbmm``) that
    the backward ran."""
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten
    dots = {aten.mm.default, aten.bmm.default, aten.addmm.default,
            aten.baddbmm.default}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += func in dots
            return func(*args, **(kwargs or {}))

    model = _port_model(cfg, host)
    loss, _ = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    with Count():
        loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in
                         model.named_parameters() if p.grad is not None}, \
        Count.n


@pytest.mark.parametrize("arch,sparse", [("granite-3-2b", True),
                                         ("granite-moe-1b-a400m", False)],
                         ids=["sparse", "moe"])
def test_remat_dots_gives_the_loss_and_gradients_of_none_and_full(arch,
                                                                  sparse):
    """``"dots"`` (selective checkpointing that keeps the matrix
    products' outputs): the loss and every gradient within 1e-6 of
    ``"none"`` and ``"full"``.  Its backward reruns no forward product:
    it runs as many as ``"none"``'s, where ``"full"`` reruns them all."""
    _, _, cfg, host = _pair(sparse, arch)
    batch = _batch(cfg, 0)
    runs = {remat: _loss_and_grads(dataclasses.replace(cfg, remat=remat),
                                   host, batch)
            for remat in ("none", "full", "dots")}
    loss, grads, n_dots = runs["dots"]
    for other in ("none", "full"):
        want_loss, want, _ = runs[other]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-6, atol=1e-6)
        assert grads.keys() == want.keys()
        for k, g in grads.items():
            np.testing.assert_allclose(g.numpy(), want[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    assert n_dots == runs["none"][2] < runs["full"][2]


@pytest.mark.parametrize("arch,sparse", [("granite-3-2b", True),
                                         ("granite-moe-1b-a400m", False)],
                         ids=["sparse", "moe"])
def test_three_train_steps_under_remat_dots_match_reference(arch, sparse):
    """Both packages under ``remat="dots"`` (the reference's
    ``jax.checkpoint`` with ``checkpoint_dots``): three AdamW steps
    without weight decay, metrics within 1e-4, every parameter within
    1e-5 (Adam's eps 1e-6, as the MoE step above)."""
    metrics, got, want, _ = _run_both(1, 3, arch=arch, sparse=sparse,
                                      remat="dots", weight_decay=0.0,
                                      eps=1e-6)
    _metrics_close(metrics)
    assert got.keys() == want.keys()
    for k, a in got.items():
        np.testing.assert_allclose(a, want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("micro", [1, 2])
def test_three_train_steps_match_reference(micro):
    """No weight decay: the two packages' decay masks differ on the body
    layers' norm scales (see the next test); everything else is held."""
    metrics, got, want, state = _run_both(micro, 3, weight_decay=0.0)
    _metrics_close(metrics)
    assert got.keys() == want.keys()
    for k, a in got.items():
        np.testing.assert_allclose(a, want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert int(state["step"]) == 3 and state["step"].dtype == torch.int32


def test_weight_decay_skips_each_layers_norm_scales():
    """One step with weight decay 0.1: every parameter within 1e-5 of the
    reference's but the body layers' norm scales, which the reference
    decays — its mask reads the stacked (2-D) array of the per-layer 1-D
    scales, where the port's reads each layer's own (1-D: no decay)."""
    metrics, got, want, _ = _run_both(1, 1, weight_decay=0.1)
    _metrics_close(metrics)
    ocfg = optimizer.OptimizerConfig(lr=3e-3, warmup_steps=2,
                                     decay_steps=10)
    shrink = 1 - 0.1 * float(optimizer._schedule(ocfg)(1))
    skipped = 0
    for k, a in got.items():
        if k.startswith("layers/") and a.ndim == 1 and a.dtype == np.float32:
            assert not np.allclose(a, want[k], rtol=1e-5, atol=1e-5), k
            a, skipped = a * shrink, skipped + 1  # the reference's decay
        np.testing.assert_allclose(a, want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert skipped == 2 * get_smoke("granite-3-2b").n_layers


# --------------------------------------------------------------- trainers


def test_a_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's Trainer saves at step 2; the port's restores it
    and takes step 3 with the reference's loss; the port's checkpoint
    restores in the reference."""
    _resume_a_reference_checkpoint(str(tmp_path), *_pair(True)[::2])


def test_a_reference_deepseek_v3_checkpoint_resumes_in_the_port(tmp_path):
    """The same with smoke deepseek-v3: the MTP subtree, the MoE layers'
    stacked experts and the router's bias (and their moments) cross into
    the port's layout and back."""
    ref_cfg, _, cfg, _ = _pair(False, "deepseek-v3-671b")
    tr = _resume_a_reference_checkpoint(str(tmp_path), ref_cfg, cfg)
    assert {"mtp", "load_balance", "ce"} <= set(tr.history[-1])
    tensors = tr.model.tensors()
    assert "mtp/block/attn/kv_down/kernel" in tensors
    assert not tensors["layers/1/ffn/router/bias"].any()


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_a_reference_recurrent_checkpoint_resumes_in_the_port(tmp_path,
                                                             arch):
    """The same with the recurrent families: the ``mixer`` and ``rec``
    subtrees (and their moments) cross into the port's layout and back."""
    ref_cfg, _, cfg, _ = _pair(False, arch)
    tr = _resume_a_reference_checkpoint(str(tmp_path), ref_cfg, cfg)
    key = "layers/0/mixer/a_log" if arch == "mamba2-780m" \
        else "layers/0/rec/lam"
    assert key in tr.model.tensors()


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "pixtral-12b"])
def test_a_reference_frontend_family_checkpoint_resumes_in_the_port(
        tmp_path, arch):
    """The same with the encoder-decoder family (the ``encoder`` stack,
    ``enc_norm``, ``frontend_proj``, each decoder layer's ``cross``) and
    the vision frontend, their batches from ``make_batch``."""
    ref_cfg, _, cfg, _ = _pair(False, arch)
    tr = _resume_a_reference_checkpoint(str(tmp_path), ref_cfg, cfg)
    tensors = tr.model.tensors()
    assert "frontend_proj/kernel" in tensors
    assert ("encoder/1/attn/q/kernel" in tensors
            and "layers/0/cross/k/kernel" in tensors) == cfg.enc_dec


def _resume_a_reference_checkpoint(d, ref_cfg, cfg):
    okw = dict(lr=3e-3, warmup_steps=2, decay_steps=10)
    ref_tr = RefTrainer(ref_cfg, RefTrainConfig(
        steps=3, ckpt_every=2, ckpt_dir=d, log_every=100,
        opt=ref_opt.OptimizerConfig(**okw)))
    ref_state, _ = ref_tr.run(ref_tr.init_state(seq_len=SEQ,
                                                global_batch=BATCH))
    assert checkpoint.latest_step(d) == 2
    tr = Trainer(cfg, TrainConfig(steps=1, ckpt_dir=d, log_every=100,
                                  opt=optimizer.OptimizerConfig(**okw)),
                 device="cpu")
    tr.init_state(seq_len=SEQ, global_batch=BATCH)
    state, nxt = tr.restore_latest()
    assert nxt == 3 and int(state[1]["step"]) == 3
    state, step = tr.run(state, start_step=nxt, n_steps=1)
    assert step == 4 and checkpoint.latest_step(d) == 3
    ref_tr.run(ref_state, start_step=3, n_steps=1)
    np.testing.assert_allclose(tr.history[-1]["loss"],
                               ref_tr.history[-1]["loss"], rtol=1e-4,
                               atol=1e-4)
    like = {"params": ref_tr.model.abstract_params()}
    like["opt_state"] = jax.eval_shape(ref_tr.opt_init, like["params"])
    restored, manifest = checkpoint.restore(d, jax.tree_util.tree_map(
        lambda _: 0, like))
    assert manifest["step"] == 3
    jax.tree_util.tree_map(
        lambda a, s: np.testing.assert_equal(np.shape(a), s.shape),
        restored, like)
    return tr


def test_trainer_loss_decreases_and_survives_fault(tmp_path):
    """``test_train.py``'s fault drill on the port (dense smoke
    granite-3-2b, bf16): the loss falls, the fault at step 13 restores
    step 8's checkpoint, and the replayed steps see the same data."""
    cfg = get_smoke("granite-3-2b")
    tc = TrainConfig(steps=24, log_every=100, ckpt_every=8,
                     ckpt_dir=str(tmp_path),
                     opt=optimizer.OptimizerConfig(lr=3e-3, warmup_steps=4,
                                                   decay_steps=100),
                     microbatches=2)
    tr = Trainer(cfg, tc, fault_injector=FaultInjector(fail_at_steps=[13]),
                 device="cpu")
    state = tr.init_state(seq_len=32, global_batch=8)
    state, step = tr.run(state)
    assert step == 24
    losses = [h["loss"] for h in tr.history]
    assert losses[-1] < losses[0] - 0.3
    by_step, replayed = {}, 0
    for h in tr.history:
        if h["step"] in by_step:
            replayed += 1
            assert abs(by_step[h["step"]] - h["loss"]) < 5e-2
        by_step[h["step"]] = h["loss"]
    assert replayed == 4                         # steps 9..12 again
    # the final checkpoint restores bitwise into a new trainer
    tr2 = Trainer(cfg, tc, device="cpu")
    tr2.init_state(seq_len=32, global_batch=8)
    (params2, opt2), nxt = tr2.restore_latest()
    assert nxt == 24
    for k, t in state[0].items():
        assert torch.equal(params2[k], t), k
    for k, t in state[1]["m"].items():
        assert torch.equal(opt2["m"][k], t), k


def test_a_fault_just_after_a_checkpoint_restores_it(tmp_path,
                                                    monkeypatch):
    """The restart waits for the asynchronous write that the step before
    the fault handed off (a slow disk here), so it restores step 2's
    checkpoint instead of starting again from the seed."""
    write = checkpoint._write

    def slow(*args, **kw):
        time.sleep(0.5)
        return write(*args, **kw)
    monkeypatch.setattr(checkpoint, "_write", slow)
    tc = TrainConfig(steps=5, log_every=100, ckpt_every=2,
                     ckpt_dir=str(tmp_path),
                     opt=optimizer.OptimizerConfig(warmup_steps=2,
                                                   decay_steps=10))
    tr = Trainer(get_smoke("granite-3-2b"), tc,
                 fault_injector=FaultInjector(fail_at_steps=[3]),
                 device="cpu")
    _, step = tr.run(tr.init_state(seq_len=16, global_batch=4))
    assert step == 5
    assert [h["step"] for h in tr.history] == [0, 1, 2, 3, 4]


def test_trainer_refuses_a_mesh_and_remat_dots_is_named():
    """A mesh without its partitioner, and ``--mesh`` without a process
    group, are refused with what is missing; ``remat="dots"`` trains (its
    numbers: the tests above) and an unknown remat is refused by name."""
    cfg = get_smoke("granite-3-2b")
    with pytest.raises(ValueError, match="partitioner="):
        Trainer(cfg, TrainConfig(), mesh=object(), device="cpu")
    with pytest.raises(RuntimeError, match="needs a process group"):
        launch_train.main(["--smoke", "--device", "cpu", "--mesh", "2x2"])
    model = LanguageModel(dataclasses.replace(cfg, remat="dots"),
                          device="cpu").requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 0).items()}
    loss, _ = model.loss(batch)
    loss.backward()
    assert math.isfinite(loss.item())
    model = LanguageModel(dataclasses.replace(cfg, remat="most"),
                          device="cpu").requires_grad_(True)
    with pytest.raises(ValueError, match="unknown remat 'most'"):
        model.loss(batch)


def test_remat_full_gives_the_same_gradients():
    _, _, cfg, host = _pair(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 0).items()}
    grads = []
    for remat in ("none", "full"):
        model = _port_model(dataclasses.replace(cfg, remat=remat), host)
        model.loss(batch)[0].backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=1e-6, atol=1e-7)


def test_launcher_smoke_sparse_ffn_on_the_cpu(capsys):
    tr, (params, _) = launch_train.main([
        "--smoke", "--sparse-ffn", "--device", "cpu", "--steps", "3",
        "--seq", "16", "--batch", "4"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == f"done: 3 steps, final loss {tr.history[-1]['loss']:.4f}"
    assert all(math.isfinite(h["loss"]) for h in tr.history)
    w_out = tr.model.layers[0].ffn.w_out
    assert w_out.values2d.requires_grad and w_out.plan_builds == 0
    assert params["layers/0/ffn/w_out/values2d"] is w_out.values2d
