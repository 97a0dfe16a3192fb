"""Training launcher.

The PyTorch counterpart of ``repro.launch.train``: the same flags and the
same last line, plus ``--device`` (default ``cuda``; without a card it
raises unless ``--device cpu`` is given) and ``--backend``.
``--sparse-ffn`` stores every FFN down-projection in RgCSR (density 0.25,
G = 128) and trains it through the plain segment sum (``impl="ref"``), as
the reference does: K2 has no backward.  ``--layers N`` cuts the
config's depth (the port's addition).

``--mesh DxM`` (axes ``data``, ``model``) or ``PxDxM`` (``pod``, ``data``,
``model``) trains on a ``DeviceMesh`` with a ``Partitioner(mesh,
"train")``, as the reference does, with ``act_shard`` on: tensor-parallel
compute over ``model`` (each rank its slice of the heads, FFN, experts and
vocabulary; ``launch/steps.py``), the attention's mode resolved for the
axis's size.  Every rank runs this launcher; the
default process group comes from the standard launcher environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as
``torchrun`` sets them) with the backend named by ``--backend`` (``nccl``
for one rank per card, ``gloo`` where ranks share one), or from a group
the caller has initialised.  Rank 0 prints the last line.

Usage:
  python -m repro_torch.launch.train --arch granite-3-2b --steps 100 \\
      [--smoke] [--sparse-ffn] [--device cpu]
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2 \\
      --backend gloo [--smoke] [--device cpu]
"""
import argparse
import dataclasses
import logging
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--mesh", default=None,
                    help="e.g. 16x16 (data x model); default: one device")
    ap.add_argument("--backend", default=None,
                    help="process-group backend for --mesh (nccl, gloo) "
                    "when this launcher initialises the group")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--sparse-ffn", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.configs.base import SparsityConfig
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptimizerConfig

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.sparse_ffn:
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
            enabled=True, density=0.25, group_size=128, impl="ref"))

    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)

    mesh = part = None
    device = args.device
    if args.mesh:
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.shardlib import attn_mode_for
        from repro_torch.sharding import Partitioner
        _init_process_group(args.backend)
        device = _rank_device(args.device)
        shape = tuple(int(x) for x in args.mesh.split("x"))
        axes = ("data", "model")[: len(shape)] if len(shape) == 2 \
            else ("pod", "data", "model")
        mesh = make_mesh(shape, axes, device_type=device.type)
        part = Partitioner(mesh, "train")
        # tensor-parallel compute over `model`, the attention's mode
        # resolved for its size (models/shardlib.py)
        cfg = dataclasses.replace(
            cfg, act_shard=True,
            attn_shard_mode=attn_mode_for(cfg, shape[-1]),
            mesh_batch_axes=("pod", "data") if len(shape) == 3 else ("data",))

    seq = args.seq or (32 if args.smoke else 4096)
    batch = args.batch or (8 if args.smoke else 256)
    tc = TrainConfig(steps=args.steps, microbatches=args.micro,
                     ckpt_dir=args.ckpt_dir,
                     opt=OptimizerConfig(name=args.optimizer,
                                         warmup_steps=max(args.steps // 20, 5),
                                         decay_steps=args.steps))
    trainer = Trainer(cfg, tc, mesh=mesh, partitioner=part, device=device)
    state = trainer.init_state(seq_len=seq, global_batch=batch)
    state, step = trainer.run(state)
    if trainer._writer:
        print(f"done: {step} steps, final loss "
              f"{trainer.history[-1]['loss']:.4f}")
    return trainer, state


def _rank_device(device: str):
    """This rank's device: ``cuda`` without an index is card
    ``LOCAL_RANK`` modulo the cards present (ranks beyond them share),
    made current before the mesh is built."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", "0"))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _init_process_group(backend):
    """The default process group: the caller's, else one from the
    standard launcher environment with ``backend``."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing or not backend:
        what = f"the environment lacks {', '.join(missing)}" if missing \
            else "no --backend was named"
        raise RuntimeError(
            f"--mesh needs a process group: initialise one, or launch every "
            f"rank with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set "
            f"(e.g. torchrun) and --backend nccl|gloo; {what}")
    dist.init_process_group(backend)


if __name__ == "__main__":
    main()
