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
    from repro_torch.configs import get_smoke
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
    from repro_torch.configs import get_smoke
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
