"""Spawned gloo ranks for the port's row-sharded tests.

Jax-free (the ranks import this module, never the reference): the test
file computes the reference's results in its own process and the ranks
return theirs as numpy.  :func:`run_ranks` spawns ``world`` processes
(``torch.multiprocessing``, start method ``spawn``) that join one gloo
group through a ``FileStore`` under the test's ``tmp_path``;
:func:`one_rank` makes the test's own process a world of one.
"""
import contextlib
import dataclasses
import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_smoke
from repro_torch.core.formats import ShardedRgCSR
from repro_torch.core.spmv import spmm, spmv
from repro_torch.kernels import (autotune, launch_counts, ops,
                                 reset_launch_counts)
from repro_torch.launch.mesh import make_mesh

TIMEOUT = datetime.timedelta(seconds=120)
D_SPMM = 9


def _init(rank, world, store_path):
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=TIMEOUT)


def _entry(rank, world, store_path, out_dir, fn, args):
    torch.set_num_threads(1)
    _init(rank, world, store_path)
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(tmp_path, world, fn, *args):
    """``fn(rank, world, *args)`` on ``world`` spawned gloo ranks; their
    results in rank order.  A rank that raises fails the call (and
    ``torch.multiprocessing`` ends the others)."""
    mp.spawn(_entry, args=(world, str(tmp_path / "store"), str(tmp_path),
                           fn, args), nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@contextlib.contextmanager
def one_rank(tmp_path):
    """This process as rank 0 of a gloo world of one."""
    _init(0, 1, str(tmp_path / "store1"))
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ the sweep


def orderings(world):
    """(label, spmv keywords) of the sweep at ``world`` shards: block,
    adaptive, adaptive with spill, and per-shard configs that differ."""
    per_shard = [(1, "adaptive", 8), (4, "block", 0), (2, "block", 0),
                 (2, "adaptive", 0)][:world]
    return (("block", {}),
            ("adaptive", {"ordering": "adaptive"}),
            ("spill8", {"ordering": "adaptive", "spill_threshold": 8}),
            ("per_shard", {"shard_configs": per_shard}))


def _check_exchange(plan, shard, x_full, x_local, group):
    """The exchange delivers, from each src, exactly this shard's remote
    columns that src owns, and as many as the plan counted."""
    view = plan.local(shard)
    work, recv = ops._exchange(view, x_local, group)
    work.wait()
    ec = plan.edge_counts
    remote = plan.remote_cols[shard, : plan.shard_remote_cols[shard]]
    owner = remote // plan.cols_per_shard
    got = 0
    for src in range(plan.n_shards):
        n = int(ec[src, shard])
        np.testing.assert_array_equal(
            recv[src, :n].cpu().float().numpy(),
            x_full[torch.from_numpy(remote[owner == src]).long()]
            .cpu().float().numpy())
        got += n
    assert got == view.recv_cols == int(ec[:, shard].sum()) \
        == plan.shard_remote_cols[shard]
    return got


def sweep(rank, world, cases, device="cpu"):
    """Every case ``(name, csr, x, X, dtype)`` (values, x and X in
    ``dtype``, a ``torch`` attribute name) in both x modes and every
    ordering of :func:`orderings`, SpMV and SpMM (d = 9), through
    ``core.spmv`` / ``spmm`` on a ``("model",)`` mesh of ``world`` ranks,
    on ``device`` (ranks on ``"cuda"`` share card 0).  Returns the gathered
    results (as float32 numpy) and their dtypes, the rank's received entry
    counts and its K1/K2 launches."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    mesh = make_mesh((world,), ("model",), device_type=dev.type)
    shard, group = ops.mesh_shard(mesh, "model")
    out, dtypes, received = {}, {}, {}
    reset_launch_counts()
    for name, (values, columns, row_ptr, shape), x, xm, dtype in cases:
        dt = getattr(torch, dtype)
        sm = ShardedRgCSR.from_csr(values, columns, row_ptr, shape, world,
                                   device=dev)
        sm = dataclasses.replace(sm, shards=tuple(
            dataclasses.replace(s, values=s.values.to(dt))
            for s in sm.shards))
        xt = torch.from_numpy(x).to(dev, dt)
        xmt = torch.from_numpy(xm).to(dev, dt)
        for x_mode in ("replicated", "split"):
            for label, kw in orderings(world):
                plan = ops.get_sharded_plan(sm, x_mode=x_mode, **kw)
                xs, xms = xt, xmt
                if x_mode == "split":
                    xs, xms = (ops.split_x(plan, t, shard) for t in (xt, xmt))
                    if plan.has_exchange:
                        received[name, label] = _check_exchange(
                            plan, shard, xt, xs, group)
                y = spmv(sm, xs, mesh=mesh, x_mode=x_mode, **kw)
                ym = spmm(sm, xms, mesh=mesh, mesh_axis="model",
                          x_mode=x_mode, **kw)
                lo, hi = sm.shard_rows(shard)
                assert y.shape == (max(hi - lo, 0),)
                assert ym.shape == (max(hi - lo, 0), D_SPMM)
                for kind, got in (("spmv", y), ("spmm", ym)):
                    full = ops.gather_sharded_rows(plan, got, mesh=mesh,
                                                   axis="model")
                    out[name, x_mode, label, kind] = \
                        full.cpu().float().numpy()
                    dtypes[name, x_mode, label, kind] = str(full.dtype)
    return {"results": out, "dtypes": dtypes, "received": received,
            "shard": shard, "launches": launch_counts()}


# ------------------------------------------------------------ warm-up


def warm(rank, world, mats):
    """``Engine.warm_spmv_plans(mesh=)`` on a ``("model",)`` mesh of all
    ranks, then again on a ``("data", "model")`` mesh of (2, world/2),
    under the reference's deterministic cost model."""
    from _torch_parity import autotune_cost
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.sharding import Partitioner
    autotune.time_us = lambda run, plan, cfg, **kw: (run(plan, cfg),
                                                     autotune_cost(plan))[1]
    eng = Engine(get_smoke("granite-3-2b"), ServeConfig(max_seq=32),
                 device="cpu")
    mesh = make_mesh((world,), ("model",), device_type="cpu")
    winners = eng.warm_spmv_plans(mats, repeats=1, mesh=mesh, x_mode="split")
    mesh2 = make_mesh((2, world // 2), ("data", "model"), device_type="cpu")
    part = Partitioner(mesh2, "decode")
    eng.warm_spmv_plans(mats[:1], repeats=1, mesh=mesh2, x_mode="split")
    plans = [p for _, p in eng._warm_sharded.values()]
    return {"winners": [tuple(vars(c).values()) for c in winners],
            "stats": eng.sharded_spmv_shard_stats,
            "cache": eng.plan_cache_stats(),
            "fingerprints": [p.fingerprint() for p in plans],
            "n_shards": [p.n_shards for p in plans],
            "axis": (part.spmv_shard_axis(), part.spmv_shard_count())}


# ------------------------------------------------------- sharded training


def sharded_cfg(arch="granite-3-2b", sparse=True):
    """``arch``'s smoke config in fp32, with the launchers' RgCSR FFN
    (``--sparse-ffn``, the segment sum) when ``sparse``."""
    from repro_torch.configs.base import SparsityConfig
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32",
                              kv_cache_dtype="float32")
    if sparse:
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
            enabled=True, density=0.25, group_size=128, impl="ref"))
    return cfg


def train_config(opt, steps=3, micro=2, eps=1e-8, **kw):
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import TrainConfig
    return TrainConfig(steps=steps, microbatches=micro, log_every=100,
                       seed=0, opt=OptimizerConfig(
                           name=opt, lr=3e-3, warmup_steps=2,
                           decay_steps=10, eps=eps), **kw)


SEQ, BATCH = 16, 8
# the other families whose loss couples no examples, with the RgCSR FFN
# where they have an FFN; Adam's eps 1e-5 for the recurrent ones, whose
# RG-LRU gates take ~1e-7 gradients (tests/test_torch_train.py)
FAMILIES = {"minicpm3-4b": (True, 1e-8), "mamba2-780m": (False, 1e-5),
            "recurrentgemma-9b": (True, 1e-5),
            "seamless-m4t-medium": (True, 1e-8), "pixtral-12b": (True, 1e-8)}


# the MoE configs on a mesh (capacities, positions and aux terms over the
# whole batch) with the optimizer of their reference cells; and one
# remat="dots" case, whose backward runs the MoE layers' collectives again
MOE_CASES = {"granite-moe-1b-a400m": ("adamw", "none"),
             "deepseek-v3-671b": ("adafactor", "none"),
             "granite-moe-1b-a400m/dots": ("adamw", "dots")}


def moe_trainer(case, device, ckpt_dir=None, **mesh_kw):
    """Three steps (``micro=2``) of a ``MOE_CASES`` case; with
    ``ckpt_dir`` a checkpoint at step 2 and after the last."""
    from repro_torch.train.trainer import Trainer
    opt, remat = MOE_CASES[case]
    cfg = dataclasses.replace(sharded_cfg(case.split("/")[0], False),
                              remat=remat)
    extra = dict(ckpt_dir=ckpt_dir, ckpt_every=2) if ckpt_dir else {}
    return Trainer(cfg, train_config(opt, **extra), device=device,
                   **mesh_kw)


def routing_stats(tr, batch, part=None):
    """``launch.steps.routing_stats`` of the trainer's model on ``batch``
    (on ``part``'s mesh when given), as numpy."""
    from repro_torch.launch.steps import routing_stats as stats
    aux = stats(tr.model, batch, part)
    return {k: aux[k].cpu().numpy()
            for k in ("expert_fraction", "load_balance", "router_z")}


def family_trainer(arch, device, **mesh_kw):
    """Two AdamW steps of ``arch``'s smoke config (``FAMILIES``)."""
    from repro_torch.train.trainer import Trainer
    sparse, eps = FAMILIES[arch]
    return Trainer(sharded_cfg(arch, sparse),
                   train_config("adamw", steps=2, micro=1, eps=eps),
                   device=device, **mesh_kw)


def _state_view(state):
    """``(whole tensors as numpy, {key: (local shape, placements)})`` of
    a trainer's ``(params, opt_state)`` (collective: every rank calls)."""
    from repro_torch.sharding import layout

    def walk(tree, prefix, whole, local):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/", whole, local)
                continue
            whole[prefix + k] = layout.gather(v).detach().cpu().numpy()
            if layout.is_dtensor(v):
                local[prefix + k] = (tuple(v.to_local().shape),
                                     tuple(str(p) for p in v.placements))
    whole, local = {}, {}
    walk({"params": state[0], "opt_state": state[1]}, "", whole, local)
    return whole, local


def train_ranks(rank, world, ckpt_dir, mesh_shape, axes, arch="granite-3-2b",
                device="cpu"):
    """Sharded training on a mesh of ``mesh_shape`` over ``axes``:
    AdamW (checkpoints under ``ckpt_dir``: steps 2 and the last) and
    Adafactor, three steps with ``micro=2`` each of ``arch``'s smoke
    config with the RgCSR FFN; each rank's history, whole final state
    (rank 0) and local shapes.  Then the launcher's ``--mesh`` (also with
    granite-moe's ``--arch``), a tuple
    axis's rows, the fault drill, two steps of each of ``FAMILIES`` and
    three of each of ``MOE_CASES`` (with the final model's routing
    statistics on the first batch; deepseek-v3's checkpoints under
    ``ckpt_dir + "_moe"``)."""
    import io
    import contextlib as cl
    from repro_torch.launch import train as launch_train
    from repro_torch.sharding import NamedSharding, Partitioner
    from repro_torch.train.trainer import Trainer
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    mesh = make_mesh(mesh_shape, axes, device_type=dev.type)
    part = Partitioner(mesh, "train")
    out = {"coord": list(mesh.get_coordinate())}
    for opt in ("adamw", "adafactor"):
        extra = dict(ckpt_dir=ckpt_dir, ckpt_every=2) if opt == "adamw" \
            else {}
        tr = Trainer(sharded_cfg(arch), train_config(opt, **extra),
                     mesh=mesh, partitioner=part, device=device)
        state = tr.init_state(seq_len=SEQ, global_batch=BATCH)
        state, _ = tr.run(state)
        whole, local = _state_view(state)
        out[opt] = {"history": tr.history, "local": local,
                    "whole": whole if rank == 0 else None}
    out["drill"] = fault_drill(sharded_cfg(arch), ckpt_dir + "_drill",
                               device, mesh=mesh, partitioner=part)
    out["families"] = {}
    for fam in FAMILIES:
        tr = family_trainer(fam, device, mesh=mesh, partitioner=part)
        state, _ = tr.run(tr.init_state(seq_len=SEQ, global_batch=BATCH))
        whole, _ = _state_view(state)
        out["families"][fam] = {"history": tr.history, "params": {
            k: v for k, v in whole.items() if k.startswith("params/")}
            if rank == 0 else None}
    out["moe"] = {}
    for case in MOE_CASES:
        moe_dir = ckpt_dir + "_moe" if case == "deepseek-v3-671b" else None
        tr = moe_trainer(case, device, moe_dir, mesh=mesh, partitioner=part)
        state, _ = tr.run(tr.init_state(seq_len=SEQ, global_batch=BATCH))
        whole, _ = _state_view(state)
        out["moe"][case] = {
            "history": tr.history,
            "routing": routing_stats(tr, tr._batch(0), part),
            "whole": whole if rank == 0 else None}
    buf = io.StringIO()
    with cl.redirect_stdout(buf):
        launch_train.main(["--smoke", "--sparse-ffn", "--device", device,
                           "--mesh", "x".join(map(str, mesh_shape)),
                           "--steps", "3", "--seq", "16", "--batch", "8",
                           "--micro", "2"])
    out["launcher"] = buf.getvalue()
    buf = io.StringIO()
    with cl.redirect_stdout(buf):
        launch_train.main(["--arch", "granite-moe-1b-a400m", "--smoke",
                           "--device", device, "--mesh",
                           "x".join(map(str, mesh_shape)), "--steps", "2",
                           "--seq", "16", "--batch", "8", "--micro", "2"])
    out["launcher_moe"] = buf.getvalue()
    rows = NamedSharding(mesh, (tuple(axes),)).distribute(
        torch.arange(16, dtype=torch.float32))
    out["tuple_rows"] = rows.to_local().tolist()
    return out


def fault_drill(cfg, ckpt_dir, device, **mesh_kw):
    """Five AdamW steps with a checkpoint every two and a fault at step 3:
    the restart loop restores step 2 and replays.  ``(step, loss)`` of
    every step run."""
    from repro_torch.train.fault import FaultInjector
    from repro_torch.train.trainer import Trainer
    tr = Trainer(cfg, train_config("adamw", steps=5, ckpt_dir=ckpt_dir,
                                   ckpt_every=2),
                 fault_injector=FaultInjector([3]), device=device, **mesh_kw)
    state = tr.init_state(seq_len=SEQ, global_batch=BATCH)
    tr.run(state)
    return [(h["step"], h["loss"]) for h in tr.history]


def restore_ranks(rank, world, ref_dir, port_dir, mesh_shape, axes):
    """Restores on a mesh of ``mesh_shape``: the reference's one-array
    checkpoint under ``ref_dir`` through ``restore_sharded`` and
    ``CheckpointManager.restore_latest(shardings=)``, and the port
    trainer's checkpoints under ``port_dir`` (granite-3-2b, AdamW) and
    ``port_dir + "_moe"`` (deepseek-v3, Adafactor) through a ``Trainer``
    on this mesh (their whole params and moments, and local shapes)."""
    from repro_torch.sharding import NamedSharding, Partitioner, layout
    from repro_torch.train.checkpoint import (CheckpointManager,
                                              restore_sharded)
    from repro_torch.train.trainer import Trainer
    mesh = make_mesh(mesh_shape, axes, device_type="cpu")
    spec = tuple(a if a in axes else None for a in ("data", "model"))
    sh = {"w": NamedSharding(mesh, spec)}
    like = {"w": np.zeros((8, 8), np.float32)}
    got, manifest = restore_sharded(ref_dir, like, sh)
    got2, _ = CheckpointManager(ref_dir).restore_latest(like, shardings=sh)
    out = {"w": layout.gather(got["w"]).numpy(),
           "w_local": got["w"].to_local().numpy(),
           "w2": layout.gather(got2["w"]).numpy(),
           "placements": [str(p) for p in got["w"].placements],
           "step": manifest["step"]}
    part = Partitioner(mesh, "train")
    tr = Trainer(sharded_cfg(), train_config("adamw", ckpt_dir=port_dir),
                 mesh=mesh, partitioner=part, device="cpu")
    tr.init_state(seq_len=SEQ, global_batch=BATCH)
    state, nxt = tr.restore_latest()
    whole, local = _state_view(state)
    out.update(next_step=nxt, whole=whole if rank == 0 else None,
               local=local)
    tr = moe_trainer("deepseek-v3-671b", "cpu", port_dir + "_moe",
                     mesh=mesh, partitioner=part)
    tr.init_state(seq_len=SEQ, global_batch=BATCH)
    state, nxt = tr.restore_latest()
    whole, local = _state_view(state)
    out["moe"] = {"next_step": nxt, "whole": whole if rank == 0 else None,
                  "local": local}
    return out


# ------------------------------------------------- tensor-parallel training


# mamba2's SSD heads in the TP cases: d_inner 128 in heads of 16
MAMBA2_SSM = dataclasses.replace(get_smoke("mamba2-780m").ssm, head_dim=16)
# case → (arch, RgCSR FFN, mesh shape, optimizer, config overrides): every
# case trains with act_shard on, each rank computing its model slice; the
# attention mode each resolves is "heads" or TP_MODES's.  Adam's eps is
# TP_EPS: at 1e-8 an element whose first gradient sits at that scale takes
# a first update of ~lr whose size follows the rounding of its sum (dense
# granite's layers/0/attn/q/kernel[21, 13] takes -1.2e-8 against a median
# |g| of 4.4e-3; minicpm3's q_down 4.0e-8), and the tensor-parallel sums
# round otherwise than one device's (as FAMILIES' RG-LRU gates)
TP_CASES = {
    "granite-3-2b": ("granite-3-2b", False, (2, 2), "adamw", {}),
    "granite-3-2b/rgcsr": ("granite-3-2b", True, (2, 2), "adamw", {}),
    "granite-3-2b/full": ("granite-3-2b", True, (2, 2), "adamw",
                          {"remat": "full"}),
    "granite-3-2b/1x4": ("granite-3-2b", True, (1, 4), "adamw", {}),
    "granite-3-2b/6heads": ("granite-3-2b", True, (1, 4), "adamw",
                            {"n_heads": 6}),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", False, (2, 2), "adamw",
                             {}),
    "granite-moe-1b-a400m/dots": ("granite-moe-1b-a400m", False, (2, 2),
                                  "adamw", {"remat": "dots"}),
    "nemotron-4-15b": ("nemotron-4-15b", False, (2, 2), "adamw", {}),
    "minicpm3-4b": ("minicpm3-4b", True, (2, 2), "adamw", {}),
    "minicpm3-4b/6heads": ("minicpm3-4b", True, (1, 4), "adamw",
                           {"n_heads": 6}),
    "seamless-m4t-medium": ("seamless-m4t-medium", True, (2, 2), "adamw",
                            {}),
    "seamless-m4t-medium/6heads": ("seamless-m4t-medium", True, (1, 4),
                                   "adamw", {"n_heads": 6}),
    "deepseek-v3-671b": ("deepseek-v3-671b", False, (2, 2), "adafactor",
                         {}),
    # 8 SSD heads of 16 (d_inner 128): four a rank on (2, 2); on (1, 4)
    # two a rank, and chunks of 8 so that SEQ spans two of them (the state
    # that crosses a chunk boundary is the rank's heads' alone)
    "mamba2-780m": ("mamba2-780m", False, (2, 2), "adamw",
                    {"ssm": MAMBA2_SSM}),
    "mamba2-780m/1x4": ("mamba2-780m", False, (1, 4), "adamw",
                        {"ssm": dataclasses.replace(MAMBA2_SSM, chunk=8)}),
    "recurrentgemma-9b": ("recurrentgemma-9b", True, (2, 2), "adamw", {}),
}
# (mamba2's smoke config has one attention head: "seq", which no layer of
# it reads)
TP_MODES = {"granite-3-2b/1x4": "repeat", "granite-3-2b/6heads": "seq",
            "minicpm3-4b/6heads": "seq", "seamless-m4t-medium/6heads": "seq",
            "recurrentgemma-9b": "repeat", "mamba2-780m": "seq",
            "mamba2-780m/1x4": "seq"}
# the cases whose parameter gathers the spy holds to the placements
TP_SPIED = ("granite-3-2b", "granite-3-2b/rgcsr", "granite-3-2b/1x4",
            "granite-moe-1b-a400m", "mamba2-780m", "mamba2-780m/1x4",
            "recurrentgemma-9b")
# each recurrent mixer split against itself whole (launch.steps.mixer_gaps)
# on layer 0: (TP_CASES case, mesh shape)
MIXER_CASES = (("mamba2-780m", (2, 2)), ("mamba2-780m/1x4", (1, 4)),
               ("recurrentgemma-9b", (2, 2)), ("recurrentgemma-9b", (1, 4)))
TP_EPS = 1e-5
TP_STEPS, TP_MICRO = 3, 2


def tp_trainer(case, device, **mesh_kw):
    """``TP_STEPS`` steps (``micro=TP_MICRO``) of a ``TP_CASES`` case."""
    from repro_torch.train.trainer import Trainer
    arch, sparse, _, opt, over = TP_CASES[case]
    cfg = dataclasses.replace(sharded_cfg(arch, sparse), act_shard=True,
                              **over)
    return Trainer(cfg, train_config(opt, steps=TP_STEPS, micro=TP_MICRO,
                                     eps=TP_EPS), device=device, **mesh_kw)


class GatherSpy:
    """Counts, while installed, the elements of every floating parameter
    that the tensor-parallel step gathers (``launch.steps._Binding``) and
    the all-gathers it issues for them on the ``model`` group."""

    def __init__(self, model_group):
        from repro_torch.launch import steps
        from repro_torch.sharding import layout
        self.steps, self.layout, self.group = steps, layout, model_group
        self.elements = 0
        self.on_model = []
        self._inside = False

    def __enter__(self):
        binding, dist_mod = self.steps._Binding, self.layout.dist
        self._saved = (binding.gather, dist_mod)
        spy = self
        gather = binding.gather

        def counted(b, name):
            spy._inside = True
            try:
                out = gather(b, name)
            finally:
                spy._inside = False
            if out.is_floating_point():
                spy.elements += out.numel()
            return out

        class Dist:
            def __getattr__(self, name):
                fn = getattr(dist_mod, name)
                if name != "all_gather_into_tensor":
                    return fn

                def all_gather(out, t, group=None, **kw):
                    if spy._inside and group is spy.group:
                        spy.on_model.append(t.numel())
                    return fn(out, t, group=group, **kw)
                return all_gather
        binding.gather = counted
        self.layout.dist = Dist()
        return self

    def __exit__(self, *exc):
        self.steps._Binding.gather, self.layout.dist = self._saved


def region_checks(mesh, mesh_dim):
    """Each of ``layout``'s region operators over ``mesh_dim``, forward and
    backward, on inputs and upstream gradients that name the rank ``r``:
    x = arange(6).reshape(2, 3) + 10 r, upstream 1 + r (or, for the
    gathers, arange over the output + 100 r; for the reduce-scatter x =
    arange(4 n).reshape(2, 2 n) + 10 r, upstream arange(4) + 100 r)."""
    from repro_torch.sharding import layout
    r, n = mesh.get_coordinate()[mesh_dim], mesh.size(mesh_dim)
    out = {}

    def run(name, fn, x, up):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        y.backward(up(y))
        out[name] = (y.detach().numpy(), x.grad.numpy())
    base = torch.arange(6.0).reshape(2, 3) + 10 * r
    run("copy_in", lambda x: layout.copy_in(x, mesh, mesh_dim), base,
        lambda y: torch.full_like(y, 1.0 + r))
    run("reduce_out", lambda x: layout.reduce_out(x, mesh, mesh_dim), base,
        lambda y: torch.full_like(y, 1.0 + r))
    for grad in ("slice", "sum"):
        run(f"gather_{grad}", lambda x, g=grad: layout.gather_dim(
            x, 1, mesh, mesh_dim, grad=g), base,
            lambda y: torch.arange(float(y.numel())).reshape(y.shape)
            + 100 * r)
    run("split", lambda x: layout.split_dim(x, 1, mesh, mesh_dim),
        torch.arange(4.0 * n).reshape(2, 2 * n),
        lambda y: torch.full_like(y, 1.0 + r))
    run("reduce_scatter", lambda x: layout.reduce_scatter_dim(
        x, 1, mesh, mesh_dim), torch.arange(4.0 * n).reshape(2, 2 * n)
        + 10 * r, lambda y: torch.arange(4.0).reshape(2, 2) + 100 * r)
    out["max"] = layout.all_reduce_max(base, mesh, mesh_dim).numpy()
    return {"rank": r, "n": n, "ops": out}


def tp_ranks(rank, world, device="cpu", cases=None):
    """Every ``TP_CASES`` case (of ``cases`` when given) on its mesh of
    the ``world`` ranks: each rank's history, resolved attention mode, unit
    modes, a MoE model's final routing statistics on the first batch
    (tensor-parallel) and (rank 0) whole final parameters; for
    ``TP_SPIED`` the spy's counts beside the placements' prediction,
    micro × Σ numel / (the leaf's model shards) a step."""
    from repro_torch.launch.steps import _tensor_parallel
    from repro_torch.sharding import Partitioner
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    meshes = {}
    mesh = make_mesh((2, world // 2), ("data", "model"), device_type=dev.type)
    out = {"regions": region_checks(mesh, 1)}
    for case, (_, _, shape, _, _) in TP_CASES.items():
        if cases is not None and case not in cases:
            continue
        if shape not in meshes:
            mesh = make_mesh(shape, ("data", "model"), device_type=dev.type)
            meshes[shape] = (mesh, Partitioner(mesh, "train"))
        mesh, part = meshes[shape]
        tr = tp_trainer(case, device, mesh=mesh, partitioner=part)
        state = tr.init_state(seq_len=SEQ, global_batch=BATCH)
        binding = _tensor_parallel(tr.model, part)
        res = {"mode": tr.model_cfg.attn_shard_mode,
               "units": sorted(set(binding.modes.values()))}
        if case in TP_SPIED:
            view = binding.view
            res["predicted"] = TP_STEPS * TP_MICRO * sum(
                t.numel() // (view.size if view.cuts[k] is not None else 1)
                for k, t in tr.model.tensors().items()
                if t.is_floating_point())
            with GatherSpy(view.group) as spy:
                state, _ = tr.run(state)
            res.update(gathered=spy.elements, on_model=spy.on_model)
        else:
            state, _ = tr.run(state)
        if tr.model_cfg.moe.n_experts:
            res["routing"] = routing_stats(tr, tr._batch(0), part)
        whole, _ = _state_view(state)
        res["history"] = tr.history
        res["params"] = {k: v for k, v in whole.items()
                         if k.startswith("params/")} if rank == 0 else None
        out[case] = res
    out["mixers"] = mixer_checks(meshes, device)
    return out


def mixer_checks(meshes, device="cpu"):
    """Each ``MIXER_CASES`` mixer split against itself whole on its mesh
    (``meshes``: shape → (mesh, partitioner)): ``launch.steps.mixer_gaps``
    of layer 0 on an input and upstream gradient drawn from seed 0, the
    same on every rank."""
    from repro_torch.launch.steps import mixer_gaps
    from repro_torch.sharding import Partitioner
    out = {}
    for case, shape in MIXER_CASES:
        if shape not in meshes:
            mesh = make_mesh(shape, ("data", "model"),
                             device_type=torch.device(device).type)
            meshes[shape] = (mesh, Partitioner(mesh, "train"))
        mesh, part = meshes[shape]
        tr = tp_trainer(case, device, mesh=mesh, partitioner=part)
        tr.init_state(seq_len=SEQ, global_batch=BATCH)
        gen = torch.Generator().manual_seed(0)
        d = tr.model_cfg.d_model
        x, up = (torch.randn(2, SEQ, d, generator=gen).to(device)
                 for _ in range(2))
        out[case, shape] = mixer_gaps(tr.model, part, "layers/0", x, up)
    return out


# --------------------------------------------------------------- dry run

# the dry run's (2, 2) check: case → (arch, RgCSR FFN); micro=2, AdamW
# (the recurrent ones are chip_smoke.py phase 16 (h)'s two models)
DRYRUN_CASES = {"granite-3-2b": ("granite-3-2b", True),
                "granite-moe-1b-a400m": ("granite-moe-1b-a400m", False),
                "mamba2-780m": ("mamba2-780m", False),
                "recurrentgemma-9b": ("recurrentgemma-9b", True)}
DRYRUN_MICRO = 2


def dryrun_cfg(case):
    """A ``DRYRUN_CASES`` case's smoke config, tensor-parallel."""
    arch, sparse = DRYRUN_CASES[case]
    return dataclasses.replace(sharded_cfg(arch, sparse), act_shard=True)


def collective_summary(cost):
    """``{"<kind> <axis>": (calls, bytes)}`` of an ``HloCost``'s log."""
    out = {}
    for r in cost.collectives:
        n, b = out.get(f"{r.kind} {r.axis}", (0, 0))
        out[f"{r.kind} {r.axis}"] = (n + 1, b + r.bytes)
    return out


# the dry run's serving check on (2, 2): case → (DRYRUN_CASES-like arch,
# RgCSR FFN through K2, shape kind, batch, seq): a prefill of batch × seq
# tokens, or one decode step against fresh caches of seq positions
DRYRUN_SERVE_CASES = {
    "granite-3-2b/prefill": ("granite-3-2b", True, "prefill", 4, 16),
    "granite-3-2b/decode": ("granite-3-2b", True, "decode", 4, 16),
    "granite-3-2b/long_decode": ("granite-3-2b", True, "long_decode", 1,
                                 128),
    "deepseek-v3-671b/prefill": ("deepseek-v3-671b", False, "prefill", 4,
                                 16),
    "deepseek-v3-671b/decode": ("deepseek-v3-671b", False, "decode", 4, 16),
    "recurrentgemma-9b/decode": ("recurrentgemma-9b", True, "decode", 4,
                                 16),
    "seamless-m4t-medium/prefill": ("seamless-m4t-medium", True, "prefill",
                                    4, 16),
}


def dryrun_serve_cfg(case):
    """A ``DRYRUN_SERVE_CASES`` case's smoke config in fp32,
    tensor-parallel, with the RgCSR FFN through K2 where it asks."""
    from repro_torch.configs.base import SparsityConfig
    arch, sparse = DRYRUN_SERVE_CASES[case][:2]
    cfg = dataclasses.replace(sharded_cfg(arch, False), act_shard=True)
    if sparse:
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
            enabled=True, density=0.25, group_size=128, impl="kernel"))
    return cfg


def serve_step_cost(cfg, mesh, kind, batch, seq, device="cpu"):
    """One serving step of ``cfg`` on ``mesh`` on this rank, on real
    tensors, as ``launch.dryrun.serve_cost`` runs it on meta ones (the
    same inputs' shapes, fresh caches of ``seq`` positions), counted by
    ``launch.hlo_cost.analyze_hlo``: ``{"flops", "by_dtype",
    "collectives"}``."""
    from repro_torch.configs import input_specs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.hlo_cost import analyze_hlo
    from repro_torch.launch.steps import (local_zeros, make_decode_step,
                                          make_prefill_step,
                                          shard_for_serving)
    from repro_torch.models import LanguageModel
    from repro_torch.sharding import Partitioner
    from repro_torch.train.trainer import _attention_on
    part = Partitioner(mesh, kind)
    cfg = _attention_on(cfg, mesh)
    model = shard_for_serving(LanguageModel(cfg, device=device, seed=0),
                              part)
    specs = input_specs(cfg, ShapeConfig("dryrun", seq, batch, kind))
    gen = torch.Generator().manual_seed(0)
    inputs = {k: (torch.randint(0, cfg.vocab, v.shape, generator=gen,
                                dtype=v.dtype)
                  if not v.is_floating_point()
                  else torch.randn(v.shape, generator=gen, dtype=v.dtype))
              for k, v in specs.items()}
    enc_len = (seq if kind == "prefill" else 4096) if cfg.enc_dec else 0
    caches = local_zeros(part, LanguageModel(cfg, device="meta").init_cache(
        batch, seq, shape_kind=kind, enc_len=enc_len, device="meta"),
        torch.device(device))
    if kind == "prefill":
        step = make_prefill_step(model, seq, kind, partitioner=part)
        run = lambda: step(inputs, caches=caches)          # noqa: E731
    else:
        step = make_decode_step(model, kind, partitioner=part)
        run = lambda: step(caches, inputs["tokens"])       # noqa: E731
    cost = analyze_hlo(run, mesh.size())
    return {"flops": cost.flops, "by_dtype": cost.flops_by_dtype,
            "collectives": collective_summary(cost)}


def dryrun_ranks(rank, world, device="cpu"):
    """One tensor-parallel train step of every ``DRYRUN_CASES`` case on a
    (2, 2) mesh of real ranks (``Trainer(mesh=)``), then one serving step
    of every ``DRYRUN_SERVE_CASES`` case (:func:`serve_step_cost`),
    counted by ``launch.hlo_cost.analyze_hlo``: each case's product
    FLOPs, FLOPs by dtype and collectives by kind and axis on this
    rank."""
    from repro_torch.launch.hlo_cost import analyze_hlo
    from repro_torch.sharding import Partitioner
    from repro_torch.train.trainer import Trainer
    mesh = make_mesh((2, 2), ("data", "model"), device_type=device)
    part = Partitioner(mesh, "train")
    out = {}
    for case in DRYRUN_CASES:
        tr = Trainer(dryrun_cfg(case), train_config("adamw",
                                                    micro=DRYRUN_MICRO),
                     mesh=mesh, partitioner=part, device=device)
        params, opt = tr.init_state(SEQ, BATCH)
        cost = analyze_hlo(lambda: tr.train_step(params, opt, tr._batch(0)),
                           world)
        out[case] = {"flops": cost.flops, "by_dtype": cost.flops_by_dtype,
                     "collectives": collective_summary(cost)}
    for case, (_, _, kind, batch, seq) in DRYRUN_SERVE_CASES.items():
        out[case] = serve_step_cost(dryrun_serve_cfg(case), mesh, kind,
                                    batch, seq, device)
    return out


# --------------------------------------------------------- serving on a mesh

# case → (arch, RgCSR FFN through K2, mesh shape, shape kind, overrides):
# the mesh prefill and decode steps against the port's one-device steps.
# granite's kv heads (2) divide a model axis of 2 (heads) but not of 4
# (repeat, the k/v cache cut over head-dim; seamless's cross ck/cv too);
# 6 query heads do not divide 4 either (seq; MLA's too); G = 128 lanes
# over 2 and 4 model ranks give K2 lane plans of 64 and 32 lanes;
# minicpm3 is MLA (its latent cut over R), deepseek-v3 MLA with
# whole-mesh MoE; long_decode holds batch 1, its cache's ring cut over
# data
SERVE_CASES = {
    "granite-3-2b": ("granite-3-2b", True, (2, 2), "decode", {}),
    "granite-3-2b/1x4": ("granite-3-2b", True, (1, 4), "decode", {}),
    "granite-3-2b/seq": ("granite-3-2b", False, (1, 4), "prefill",
                         {"n_heads": 6}),
    "granite-3-2b/long": ("granite-3-2b", True, (2, 2), "long_decode", {}),
    "minicpm3-4b": ("minicpm3-4b", True, (2, 2), "decode", {}),
    "minicpm3-4b/long": ("minicpm3-4b", False, (2, 2), "long_decode", {}),
    "minicpm3-4b/6heads": ("minicpm3-4b", False, (1, 4), "decode",
                           {"n_heads": 6}),
    "deepseek-v3-671b": ("deepseek-v3-671b", False, (2, 2), "decode", {}),
    "deepseek-v3-671b/scatter": ("deepseek-v3-671b", False, (1, 4),
                                 "decode", {"dispatch": "scatter"}),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", False, (2, 2),
                             "decode", {}),
    "mamba2-780m": ("mamba2-780m", False, (2, 2), "decode",
                    {"ssm": MAMBA2_SSM}),
    "recurrentgemma-9b": ("recurrentgemma-9b", True, (2, 2), "decode", {}),
    "seamless-m4t-medium": ("seamless-m4t-medium", True, (2, 2), "decode",
                            {}),
    "seamless-m4t-medium/1x4": ("seamless-m4t-medium", False, (1, 4),
                                "decode", {}),
    "pixtral-12b": ("pixtral-12b", True, (2, 2), "decode", {}),
}
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, SERVE_MAX = 4, 8, 3, 24
# long_decode: one prompt longer than the smoke configs' 64-slot window
SERVE_LONG_PROMPT = 70


def serve_cfg(case):
    """A ``SERVE_CASES`` case's smoke config in fp32, tensor-parallel, with
    the RgCSR FFN through K2 (``impl="kernel"``) where it asks for one."""
    from repro_torch.configs.base import SparsityConfig
    arch, sparse, _, _, over = SERVE_CASES[case]
    over = dict(over)
    if "dispatch" in over:
        over["moe"] = dataclasses.replace(get_smoke(arch).moe,
                                          dispatch=over.pop("dispatch"))
    cfg = dataclasses.replace(sharded_cfg(arch, False), act_shard=True,
                              **over)
    if sparse:
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
            enabled=True, density=0.25, group_size=128, impl="kernel"))
    return cfg


def serve_inputs(cfg, kind, device="cpu"):
    """The prompt batch of a case (drawn from seed 0) and ``s_max``."""
    from repro_torch.configs import concrete_inputs
    if kind == "long_decode":
        b, s = 1, SERVE_LONG_PROMPT
    else:
        b, s = SERVE_BATCH, SERVE_PROMPT + (cfg.frontend_tokens
                                            if cfg.family == "vlm" else 0)
    batch = concrete_inputs(cfg, batch=b, seq=s, kind="prefill", seed=0,
                            device=device)
    return batch, s + SERVE_STEPS + 1


def _np_caches(caches):
    """A cache tree as numpy leaves keyed by path."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}/")
        else:
            out[prefix[:-1]] = node.detach().float().cpu().numpy()
    walk(caches, "")
    return out


def serve_one_device(cfg, kind, device="cpu"):
    """The port's one-device prefill and ``SERVE_STEPS`` greedy decode
    steps of ``cfg``: (logits of each step, tokens fed, caches after the
    prefill and after the last step)."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import LanguageModel
    model = LanguageModel(cfg, device=device, seed=0)
    batch, s_max = serve_inputs(cfg, kind, device)
    with torch.no_grad():
        logits, caches = make_prefill_step(model, s_max, kind)(batch)
        first = [_np_caches(caches)]
        steps, fed = [logits], []
        decode = make_decode_step(model, kind)
        for _ in range(SERVE_STEPS):
            tok = torch.argmax(steps[-1][:, -1], -1).to(torch.int32)[:, None]
            fed.append(tok)
            logits, caches = decode(caches, tok)
            steps.append(logits)
    return steps, fed, first + [_np_caches(caches)], caches, s_max


def serve_ranks(rank, world, device="cpu", cases=None):
    """Every ``SERVE_CASES`` case (of ``cases``) on its mesh of the
    ``world`` ranks: the one-device steps, then the mesh steps
    (``make_prefill_step`` / ``make_decode_step`` with ``partitioner=``)
    fed the same tokens; each step's logits gap (this rank's rows against
    the one-device rows) relative to ``1 + max|one-device|``, the cache
    slices' gap against ``Partitioner.local_caches`` of the one-device
    caches and the slices gathered whole again
    (``Partitioner.whole_caches``) against them, the decode steps from
    the one-device prefill's caches sliced,
    the lane plans built, and the resolved attention mode and unit
    modes."""
    from repro_torch.launch.steps import (_Binding, make_decode_step,
                                          make_prefill_step,
                                          shard_for_serving)
    from repro_torch.models import LanguageModel
    from repro_torch.models.ffn import SparseLinear
    from repro_torch.sharding import Partitioner, layout
    from repro_torch.train.trainer import _attention_on
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    out = {}
    meshes = {}
    for case, (_, _, shape, kind, _) in SERVE_CASES.items():
        if cases is not None and case not in cases:
            continue
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"),
                                      device_type=dev.type)
        mesh = meshes[shape]
        part = Partitioner(mesh, kind)
        cfg = _attention_on(serve_cfg(case), mesh)
        steps, fed, want, whole, s_max = serve_one_device(cfg, kind, device)
        batch, _ = serve_inputs(cfg, kind, device)
        model = shard_for_serving(LanguageModel(cfg, device=device, seed=0),
                                  part)
        rows = part.batch_shardings(batch)["tokens"].placements()
        prefill = make_prefill_step(model, s_max, kind, partitioner=part)
        decode = make_decode_step(model, kind, partitioner=part)

        def gap(got, ref):     # the real columns (the padding's: -1e30)
            ref = layout.local_chunk(ref, mesh, rows)[..., :cfg.vocab]
            return float((got[..., :cfg.vocab] - ref).abs().max()
                         / (1.0 + ref.abs().max()))

        def cache_gap(local, ref):
            ref = _np_caches(part.local_caches(ref))
            got = _np_caches(local)
            assert sorted(got) == sorted(ref), (sorted(got), sorted(ref))
            return max(float(np.abs(got[k] - ref[k]).max()
                             / (1.0 + np.abs(ref[k]).max()))
                       if got[k].size else 0.0 for k in got)
        res = {"mode": cfg.attn_shard_mode, "units": sorted(
            str(m) for m in set(_Binding(model, part.tensor_parallel(
                model.spec()), True).modes.values()))}
        logits, caches = prefill(batch)
        res["logits"] = [gap(logits, steps[0])]
        res["tokens"] = [bool(torch.equal(
            torch.argmax(logits[:, -1], -1),
            layout.local_chunk(torch.argmax(steps[0][:, -1], -1), mesh,
                               rows)))]
        prefill_caches = caches
        for i, tok in enumerate(fed):
            logits, caches = decode(caches, tok)
            res["logits"].append(gap(logits, steps[i + 1]))
        res["caches"] = [cache_gap(caches, whole)]
        # and back: the ranks' slices gathered whole (a collective)
        back, ref = (_np_caches(t) for t in (part.whole_caches(caches, whole),
                                             whole))
        res["whole"] = (sorted(back) == sorted(ref), max(
            float(np.abs(back[k] - ref[k]).max()
                  / (1.0 + np.abs(ref[k]).max())) for k in ref))
        res["prefill_caches"] = prefill_caches is not None
        # decode from the one-device prefill's caches, sliced
        one = LanguageModel(cfg, device=device, seed=0)
        with torch.no_grad():
            _, c1 = make_prefill_step(one, s_max, kind)(batch)
        caches = part.local_caches(c1)
        for i, tok in enumerate(fed):
            logits, caches = decode(caches, tok)
            res["logits"].append(gap(logits, steps[i + 1]))
        res["caches"].append(cache_gap(caches, whole))
        res["lane_plans"] = [m.plan_builds for m in model.modules()
                             if isinstance(m, SparseLinear)]
        if res["lane_plans"]:
            view = part.tensor_parallel(model.spec())
            res["lanes"] = lane_checks(model, one, cfg, view,
                                       _Binding(model, view, True), device)
        out[case] = res
    if cases is None:
        out["raises"] = serve_raises(device)
    return out


def lane_checks(model, one, cfg, view, binding, device="cpu"):
    """Layer 0's RgCSR ``w_out`` of ``model`` (laid out on a mesh) on this
    rank's lanes: ``SparseLinear.lanes`` through K2 on the lane plan
    (``impl="kernel"``, the plain version on CPU tensors) and through the
    segment sum (``impl="ref"``) against the whole layer of ``one`` (the
    one-device model), on an input drawn from seed 0 (the rank's ``d_ff``
    slice of it); each gap relative to ``1 + max|whole|``."""
    gen = torch.Generator().manual_seed(0)
    whole_layer = one.layers[0].ffn.w_out
    x = torch.randn(2, 3, whole_layer.d_in, generator=gen).to(device)
    want = whole_layer(x)
    h = x.chunk(view.size, -1)[view.rank]
    block = model.layers[0]
    out = {}
    with torch.no_grad(), binding.step(model.tensors()), binding.bind(block):
        layer = block.ffn.w_out
        for impl in ("kernel", "ref"):
            saved = layer.cfg
            layer.cfg = dataclasses.replace(
                saved, sparsity=dataclasses.replace(saved.sparsity,
                                                    impl=impl))
            try:
                got = layer.lanes(h, view)
            finally:
                layer.cfg = saved
            out[impl] = float((got - want).abs().max()
                              / (1.0 + want.abs().max()))
    return out


def serve_raises(device="cpu"):
    """The refusals of serving on a (1, 4) mesh, each ``ValueError``'s
    message: an explicit attention mode the rules do not divide (2 kv
    heads over 4 ranks), K2 lanes G/n that are no multiple of 32 (64 over
    4), the paged pool, and a config without ``act_shard``."""
    from repro_torch.configs.base import SparsityConfig
    from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                          shard_for_serving)
    from repro_torch.models import LanguageModel
    from repro_torch.models.attention import PageGeometry
    from repro_torch.sharding import Partitioner
    from repro_torch.train.trainer import _attention_on
    mesh = make_mesh((1, 4), ("data", "model"),
                     device_type=torch.device(device).type)
    part = Partitioner(mesh, "decode")
    out = {}

    def message(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    def mesh_model(cfg):
        return shard_for_serving(LanguageModel(cfg, device=device, seed=0),
                                 part)
    base = serve_cfg("granite-3-2b")
    batch, s_max = serve_inputs(base, "decode", device)
    model = mesh_model(dataclasses.replace(base, attn_shard_mode="heads"))
    out["mode"] = message(lambda: make_prefill_step(model, s_max, "decode",
                                                    partitioner=part))
    cfg = _attention_on(dataclasses.replace(base, sparsity=SparsityConfig(
        enabled=True, density=0.25, group_size=64, impl="kernel")), mesh)
    model = mesh_model(cfg)
    step = make_prefill_step(model, s_max, "decode", partitioner=part)
    out["lanes"] = message(lambda: step(batch))
    cfg = _attention_on(base, mesh)
    model = mesh_model(cfg)
    one = LanguageModel(cfg, device=device, seed=0)
    geom = PageGeometry(n_pages=9, page_size=4, pages_per_slot=6)
    paged = part.local_caches(one.init_cache(SERVE_BATCH, 24, paging=geom))
    decode = make_decode_step(model, "decode", partitioner=part)
    tok = torch.zeros((SERVE_BATCH, 1), dtype=torch.int32)
    out["paged"] = message(lambda: decode(paged, tok))
    model = mesh_model(dataclasses.replace(cfg, act_shard=False))
    out["act_shard"] = message(lambda: make_decode_step(
        model, "decode", partitioner=part))
    return out
