"""Serving example on the PyTorch port: mixed-length request queue through
the paged engine (on a card its decode step is one captured CUDA graph).

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.formats import resolve_device
from repro_torch.serve import Engine, Request, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"

    cfg = get_smoke("granite-3-2b")
    eng = Engine(cfg, ServeConfig(max_seq=128, n_slots=4, temperature=0.0),
                 device=dev)
    rng = np.random.default_rng(0)

    print("=== batch generate ===")
    prompts = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    t0 = time.time()
    out = eng.generate(prompts, max_new_tokens=16)
    dt = time.time() - t0
    print(f"generated {out.size} tokens in {dt:.2f}s "
          f"({out.size / dt:.1f} tok/s on {where})")

    print("\n=== continuous mixed-length batching over 10 requests ===")
    reqs = [Request(tokens=rng.integers(0, cfg.vocab,
                                        (8 + 2 * i,)).astype(np.int32),
                    max_new_tokens=6 + i % 5) for i in range(10)]
    t0 = time.time()
    done = eng.serve(reqs)
    dt = time.time() - t0
    total = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests / {total} tokens in {dt:.2f}s; "
          f"all done: {all(r.done for r in done)}")
    for i, r in enumerate(done[:3]):
        print(f"  req{i}: prompt_len={len(r.tokens)} -> {r.out}")
    ps = eng.paging_stats
    print(f"paging: peak {ps['page_high_water']} pages in use "
          f"({ps['paged_peak_tokens']} tokens vs "
          f"{ps['dense_equiv_tokens']} dense), fragmentation at peak "
          f"{ps['frag_at_high_water']:.3f}")
    assert all(r.done for r in done), "every request must finish"
    return done


if __name__ == "__main__":
    main()
