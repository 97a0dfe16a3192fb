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
