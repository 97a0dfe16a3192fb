"""End-to-end training on the PyTorch port: train a ~100M-param GQA LM for a
few hundred steps.

Demonstrates the training substrate on the card (or ``--device cpu``):
deterministic data, AdamW + cosine schedule, microbatch gradient
accumulation, async checkpoints, the step-time watchdog, and (optionally)
the paper's RgCSR sparse-FFN feature (--sparse), trained through the
segment sum as the reference trains it (``impl="ref"``).

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
      [--sparse] [--device cpu]   (--tiny for a seconds-scale demo)
"""
import argparse
import dataclasses
import logging
import tempfile

from repro_torch.configs.base import ModelConfig, SparsityConfig
from repro_torch.core.formats import resolve_device
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.optimizer import OptimizerConfig


def model_100m(tiny: bool = False) -> ModelConfig:
    if tiny:
        return ModelConfig(
            name="demo-tiny", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=512,
            layer_pattern=("attn",))
    # ~105M params: 12L × 768 (GPT-2-small-like, GQA kv=4, SwiGLU)
    return ModelConfig(
        name="demo-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_head=64, d_ff=2048, vocab=32_000,
        layer_pattern=("attn",))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--sparse", action="store_true",
                    help="store FFN down-projections in RgCSR (the paper's "
                         "technique as an LM feature)")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    cfg = model_100m(args.tiny)
    if args.sparse:
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
            enabled=True, density=0.25, group_size=128, impl="ref"))

    with tempfile.TemporaryDirectory() as ckpt_dir:
        tc = TrainConfig(
            steps=args.steps if not args.tiny else 30,
            microbatches=2,
            log_every=10,
            ckpt_every=100,
            ckpt_dir=ckpt_dir,
            opt=OptimizerConfig(lr=3e-4 if not args.tiny else 3e-3,
                                warmup_steps=20, decay_steps=args.steps,
                                weight_decay=0.1),
        )
        trainer = Trainer(cfg, tc, device=dev)
        state = trainer.init_state(seq_len=args.seq if not args.tiny else 32,
                                   global_batch=args.batch)
        print(f"model: {cfg.name}  params={trainer.model.n_params():,}  "
              f"sparse_ffn={args.sparse}  device={dev}")
        state, step = trainer.run(state)

    first = trainer.history[0]["loss"]
    last = trainer.history[-1]["loss"]
    print(f"\ntrained {step} steps: loss {first:.3f} -> {last:.3f}")
    ewma = trainer.watchdog.ewma or 0.0
    print(f"step-time EWMA {ewma:.3f}s; stragglers flagged: "
          f"{len(trainer.watchdog.events)}")
    assert last < first, "training must reduce loss"
    return trainer


if __name__ == "__main__":
    main()
