"""The benchmark's CPU tests: they import ``gpubench`` from the checkout
and run its drivers on the CPU at a small size (``SMALL``), with the
kernels' plain versions."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every configuration and mix of BENCHMARK.json at a size the CPU runs in seconds
SMALL_CONFIG = {
    "olmo-1b": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
                "d_ff": 128, "vocab_size": 500, "table_rows": 512},
    "mamba2-1.3b": {"n_layers": 2, "d_model": 64, "vocab_size": 500, "table_rows": 512,
                    "ssm": {"d_state": 16, "d_conv": 4, "expand": 2, "head_dim": 8,
                            "n_groups": 1, "chunk_size": 8}},
}
SMALL_MIX = {
    "serve_long": {"kernels": "plain", "slots": 4, "max_len": 64, "prefill_chunk": 16,
                   "prompt": [4, 12], "output": [8, 20], "check_requests": 3, "warm_steps": 1,
                   "profiled_steps": 2},
    "train_8x2048": {"batch": 2, "seq_len": 16},
}


# OLMo-1B's width at 2 layers and a small vocabulary: logits of its
# scale, so that a served token's gap is judged by the cell's own limit
WIDE_CONFIG = {"olmo-1b": {"n_layers": 2, "d_model": 2048, "n_heads": 16, "n_kv_heads": 16,
                           "head_dim": 128, "d_ff": 1024, "vocab_size": 4000, "table_rows": 4096}}


def small(cell, configs=SMALL_CONFIG) -> dict:
    """``run_cell``'s overrides for a resolved cell."""
    return {"config": configs[cell.entry["config"]], "mix": SMALL_MIX[cell.entry["traffic"]]}


@pytest.fixture(scope="session")
def harness():
    from gpubench import harness as H

    H.use_checkout()
    return H
