"""Training launcher.

The PyTorch counterpart of ``repro.launch.train`` on one device: the same
flags and the same last line, plus ``--device`` (default ``cuda``; without
a card it raises unless ``--device cpu`` is given).  ``--sparse-ffn``
stores every FFN down-projection in RgCSR (density 0.25, G = 128) and
trains it through the plain segment sum (``impl="ref"``), as the
reference does: K2 has no backward.  ``--mesh`` (sharded training) is not
ported yet.

Usage:
  python -m repro_torch.launch.train --arch granite-3-2b --steps 100 \\
      [--smoke] [--sparse-ffn] [--device cpu]
"""
import argparse
import dataclasses
import logging


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--mesh", default=None,
                    help="e.g. 16x16 (data x model): not ported yet")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--sparse-ffn", action="store_true")
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    if args.mesh:
        raise NotImplementedError(
            "--mesh (training on a device mesh) is not ported yet (ROADMAP "
            "queue 1, item 3: sharded training)")

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.configs.base import SparsityConfig
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptimizerConfig

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.sparse_ffn:
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
            enabled=True, density=0.25, group_size=128, impl="ref"))

    seq = args.seq or (32 if args.smoke else 4096)
    batch = args.batch or (8 if args.smoke else 256)
    tc = TrainConfig(steps=args.steps, microbatches=args.micro,
                     ckpt_dir=args.ckpt_dir,
                     opt=OptimizerConfig(name=args.optimizer,
                                         warmup_steps=max(args.steps // 20, 5),
                                         decay_steps=args.steps))
    trainer = Trainer(cfg, tc, device=args.device)
    state = trainer.init_state(seq_len=seq, global_batch=batch)
    state, step = trainer.run(state)
    print(f"done: {step} steps, final loss "
          f"{trainer.history[-1]['loss']:.4f}")
    return trainer, state


if __name__ == "__main__":
    main()
