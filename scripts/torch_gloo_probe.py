"""Which collectives gloo runs on CUDA tensors: 4 ranks on cuda:0.

Why the port's sharded training moves its data with the plain
``torch.distributed`` collectives (``sharding/layout.py``) and never with
DTensor's redistribution: each case below runs on every rank and prints
``ok`` or ``FAIL``; the last case, DTensor's functional all-gather on a
mesh axis's group, ends the rank with a segmentation fault on PyTorch
2.11 with CUDA 12.8 (NVIDIA H100), after the plain collectives and the
DTensor containers passed.  The cases ``region_*`` run the port's
tensor-parallel region operators (``sharding/layout.py``: ``copy_in``,
``reduce_out``, ``gather_dim`` along a non-leading dim with either
backward, ``split_dim``, ``reduce_scatter_dim``, ``all_reduce_max``),
forward and backward, on
the ``model`` group, each checked against its sum.  On the CPU every case
passes::

    python3 scripts/torch_gloo_probe.py             # cuda:0
    PROBE_DEV=cpu python3 scripts/torch_gloo_probe.py
"""
import os
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_fn(rank, world, store):
    DEV = os.environ.get("PROBE_DEV", "cuda")
    if DEV == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dev = torch.device(DEV, 0) if DEV == "cuda" else torch.device("cpu")
    res = {}

    def tryit(name, fn):
        print(f"r{rank} start {name}", flush=True)
        try:
            out = fn()
            res[name] = f"ok {out}"
            print(f"r{rank} {name}: {res[name]}", flush=True)
        except Exception as e:  # noqa
            res[name] = f"FAIL {type(e).__name__}: {str(e)[:200]}"
            print(f"r{rank} {name}: {res[name]}", flush=True)

    x = torch.arange(8, dtype=torch.float32, device=dev) + rank
    tryit("all_reduce", lambda: (dist.all_reduce(x.clone()), "")[1])
    big = torch.empty(32, device=dev)
    tryit("all_gather_into_tensor",
          lambda: (dist.all_gather_into_tensor(big, x.clone()), big[:3].tolist())[1])
    tryit("all_gather", lambda: (dist.all_gather([torch.empty_like(x) for _ in range(world)], x), "")[1])
    mesh = DeviceMesh(DEV, torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    tryit("group_allreduce", lambda: (dist.all_reduce(x.clone(), group=mesh.get_group("model")), "")[1])
    full = torch.arange(64, dtype=torch.float32, device=dev).reshape(8, 8)
    coord = mesh.get_coordinate()
    loc = full.chunk(2, 0)[coord[0]].chunk(2, 1)[coord[1]].contiguous()
    gm = mesh.get_group("model")
    gd = mesh.get_group("data")

    def ag_sub():
        buf = torch.empty(2 * loc.numel(), device=dev)
        dist.all_gather_into_tensor(buf, loc.reshape(-1), group=gm)
        return buf.view((2,) + loc.shape)[:, 0, 0].tolist()
    tryit("c10d_all_gather_into_tensor_subgroup", ag_sub)

    def rs_world():
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x.clone())
        return out.tolist()
    tryit("c10d_reduce_scatter_world", rs_world)

    def rs_sub():
        out = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(out, x.clone(), group=gd)
        return out.tolist()
    tryit("c10d_reduce_scatter_subgroup", rs_sub)

    def rs_list():
        out = torch.empty(4, device=dev)
        dist.reduce_scatter(out, list(x.clone().chunk(2)), group=gd)
        return out.tolist()
    tryit("c10d_reduce_scatter_list_subgroup", rs_list)

    def dt_local():
        d = DTensor.from_local(loc, mesh, [Shard(0), Shard(1)], run_check=False)
        z = torch.zeros_like(d)
        return (tuple(d.shape), type(z).__name__, z.to_local().shape, d.to_local().data_ptr() == loc.data_ptr())
    tryit("dtensor_from_local_zeros_like", dt_local)

    def dt_rep_shard():
        d = DTensor.from_local(full.clone(), mesh, [Replicate(), Replicate()], run_check=False)
        return d.redistribute(mesh, [Shard(0), Shard(1)]).to_local().shape
    tryit("dtensor_replicate_to_shard", dt_rep_shard)

    def dt_param():
        p = torch.nn.Parameter(DTensor.from_local(loc.clone(), mesh, [Shard(0), Shard(1)], run_check=False))
        with torch.no_grad():
            p.to_local().mul_(2)
        return p.to_local()[0, :2].tolist()
    tryit("dtensor_param_local_inplace", dt_param)
    dist.barrier()

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.sharding import layout
    r = mesh.get_coordinate()[1]
    base = (torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3)
            + 10 * r)

    def region(fn, up, want_y, want_g, x=base):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        y.backward(up(y))
        if not (torch.equal(y.detach(), want_y)
                and torch.equal(x.grad, want_g)):
            raise AssertionError(f"got {y.tolist()} / {x.grad.tolist()}")
        return tuple(y.shape)
    other = base + 10 * (1 - 2 * r)           # the other model rank's base
    ones = lambda y: torch.full_like(y, 1.0 + r)  # noqa: E731
    tryit("region_copy_in", lambda: region(
        lambda x: layout.copy_in(x, mesh, 1), ones, base,
        torch.full_like(base, 3.0)))
    tryit("region_reduce_out", lambda: region(
        lambda x: layout.reduce_out(x, mesh, 1), ones, base + other,
        torch.full_like(base, 1.0 + r)))
    pair = [base, other] if r == 0 else [other, base]
    whole = torch.cat(pair, dim=1)
    ramp = lambda y: torch.arange(y.numel(), dtype=y.dtype,  # noqa: E731
                                  device=y.device).reshape(y.shape) + 100 * r
    tryit("region_gather_dim1_slice", lambda: region(
        lambda x: layout.gather_dim(x, 1, mesh, 1), ramp, whole,
        ramp(whole)[:, 3 * r:3 * r + 3]))
    summed = 2 * (ramp(whole) - 100 * r) + 100
    tryit("region_gather_dim1_sum", lambda: region(
        lambda x: layout.gather_dim(x, 1, mesh, 1, grad="sum"), ramp, whole,
        summed[:, 3 * r:3 * r + 3]))
    wide = torch.arange(8, dtype=torch.float32, device=dev).reshape(2, 4)
    tryit("region_split_dim1", lambda: region(
        lambda x: layout.split_dim(x, 1, mesh, 1), ones,
        wide[:, 2 * r:2 * r + 2], torch.cat([torch.full((2, 2), 1.0,
                                                       device=dev),
                                            torch.full((2, 2), 2.0,
                                                       device=dev)], 1),
        x=wide))
    halves = torch.cat([torch.full((2, 2), 1.0, device=dev),
                        torch.full((2, 2), 2.0, device=dev)], 1)
    tryit("region_reduce_scatter_dim1", lambda: region(
        lambda x: layout.reduce_scatter_dim(x, 1, mesh, 1), ones,
        (2 * wide + 10)[:, 2 * r:2 * r + 2], halves, x=wide + 10 * r))
    def max_case():
        got = layout.all_reduce_max(base, mesh, 1)
        if not torch.equal(got, torch.maximum(base, other)):
            raise AssertionError(f"got {got.tolist()}")
        return tuple(got.shape)
    tryit("region_all_reduce_max", max_case)
    dist.barrier()

    def funcol():
        import torch.distributed._functional_collectives as fc
        return fc.all_gather_tensor(loc, 0, gm).shape
    tryit("funcol_all_gather_subgroup (crash suspect)", funcol)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        for k, v in res.items():
            print(f"probe r0 {k}: {v}", flush=True)
    if rank == 1:
        for k, v in res.items():
            print(f"probe r1 {k}: {v}", flush=True)


if __name__ == "__main__":
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    d = tempfile.mkdtemp()
    mp.spawn(rank_fn, args=(4, os.path.join(d, "store")), nprocs=4)
    print("probe done")
