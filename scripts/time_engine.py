#!/usr/bin/env python3
"""Serve full-width OLMo-1B through one checkout's ``Engine`` on one NVIDIA GPU.

    python3 scripts/time_engine.py [--src DIR] [--label NAME] [--runs N]

``DIR`` is the ``src`` directory of a checkout of this repository (by
default this one's); its kernels are built into that checkout's
``build/kernels``.  The 12 requests of ``chip_smoke.py``'s engine phase
run ``N`` times (2 by default) through ``chip_smoke.run_engine`` with
``attn_impl="flash"``, each run printing its tokens/s, TTFT and decode
and prefill p50 (host clock, synchronised).  Two checkouts run in turns
in one call (parent, change, change, parent) compare on one card and
one host.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its helpers and settings; imports nothing of the port)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: the Engine is timed on an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import kernels as K
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, stdin=subprocess.DEVNULL,
                         timeout=60).stdout.strip()
    print(f"{args.label}: {K.__file__}; {smi}", flush=True)
    K.build()
    cfg = get_config("olmo-1b")
    params = T.Transformer(cfg, init_params(T.model_layout(cfg), seed=0, device="cuda")).params
    layers = cfg.num_layers

    def want(steps, chunks):
        return dict(chip_smoke.NO_LAUNCHES, decode_attention=steps * layers,
                    emit_norm_logits=steps, attention=chunks * layers)

    for run in range(args.runs):
        chip_smoke.run_engine(cfg, params, f"{args.label} run {run}", want,
                              prefill_chunk=128, attn_impl="flash")
    return 0


if __name__ == "__main__":
    sys.exit(main())
