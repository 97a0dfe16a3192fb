"""The benchmark's tests run on the CPU, at small sizes, from the root of
the repository: ``python -m pytest perfbench/tests``."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

# small stand-ins of the configurations and mixes, at the same keys
FEM_SMALL = {"nx": 64, "ny": 64, "rows": 4096, "nnz": 64 * 64 * 5 - 4 * 64}
GQA_SMALL = {"hidden_size": 64, "num_attention_heads": 4,
                 "num_key_value_heads": 2, "intermediate_size": 128,
                 "vocab_size": 512, "num_hidden_layers": 2,
                 "attention_multiplier": 0.25,
                 "max_position_embeddings": 128}
SERVE_SMALL = {"clients": 4, "slots": 4, "max_seq": 128, "deck": 4,
               "prompt": {"median": 16, "sigma": 0.5, "min": 4, "max": 48},
               "output": {"median": 8, "sigma": 0.4, "min": 4, "max": 16},
               "open_after": 2, "check_tokens": 48, "trace_seconds": 0.2}


@pytest.fixture(scope="session")
def bench():
    from perfbench import harness
    return harness.Bench(ROOT)


def small(cell: str):
    """``(config_override, traffic_override)`` of ``cell`` at test size."""
    if cell.startswith("fem2d"):
        return FEM_SMALL, {}
    return GQA_SMALL, SERVE_SMALL
