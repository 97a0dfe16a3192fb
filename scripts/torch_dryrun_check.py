"""The dry run's prediction of one training step against the card.

granite-3-2b's smoke config on one device, 8 × 256 tokens in 2
microbatches, AdamW: the dry run (``repro_torch.launch.dryrun.step_cost``
on meta tensors) against the same step on the card — product FLOPs
(``FlopCounterMode``), the arguments' bytes, and the temporaries (the
step's ``max_memory_allocated`` above what the card held before it, in a
step of its own after a warm-up): :func:`measure`, which
``tests/test_torch_gpu.py::test_the_dry_run_predicts_the_card_s_step``
holds to its bars, printed.  Run from the repository's root on a machine with a
card::

    PYTHONPATH=src python scripts/torch_dryrun_check.py
"""
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import concrete_inputs, get_smoke
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_cost import PRODUCTS
from repro_torch.launch.steps import make_train_step
from repro_torch.models import LanguageModel
from repro_torch.train.optimizer import OptimizerConfig


def measure(device) -> dict:
    """The dry run's predictions and the card's numbers (the module's
    note), by name: ``flops``, ``arguments``, ``temporaries``, each a
    ``(predicted, measured)`` pair."""
    cfg, seq, batch, micro = get_smoke("granite-3-2b"), 256, 8, 2
    want = dryrun.step_cost(cfg, (1,), ("model",), seq=seq, batch=batch,
                            microbatches=micro, optimizer="adamw")
    model = LanguageModel(cfg, device=device).requires_grad_(True)
    step, init = make_train_step(model, OptimizerConfig(), micro)
    params = model.tensors()
    opt = init(params)
    data = concrete_inputs(cfg, batch=batch, seq=seq, device=device)
    params, opt, _ = step(params, opt, data)            # warm-up
    args = sum(t.numel() * t.element_size() for t in
               [*params.values(), *opt["m"].values(), *opt["v"].values(),
                opt["step"], *data.values()])
    flops = FlopCounterMode(display=False)
    with flops:
        params, opt, _ = step(params, opt, data)
    # memory in a step of its own: FlopCounterMode's module hooks keep
    # tensors alive longer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    step(params, opt, data)
    torch.cuda.synchronize()
    counts = flops.get_flop_counts()["Global"]
    mem = want["memory"]
    return {"flops": (want["cost"].flops, sum(
                v for op, v in counts.items() if op in PRODUCTS)),
            "arguments": (mem["argument_size_in_bytes"], args),
            "temporaries": (mem["temp_size_in_bytes"],
                            torch.cuda.max_memory_allocated() - before)}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = torch.cuda.get_device_name(0)
    for name, (predicted, measured) in measure(
            torch.device("cuda")).items():
        print(f"{name}: predicted {predicted:.0f}, {card} {measured:.0f}")


if __name__ == "__main__":
    main()
