#!/usr/bin/env python3
"""Serve chip_smoke.py's 12 requests with one checkout of the port and
print a digest of the tokens, on one NVIDIA GPU.

    python3 scripts/engine_tokens.py [--src DIR] [--label NAME]

``DIR`` is the ``src`` directory of a checkout of this repository (by
default this one's); its kernels are built into that checkout's
``build/kernels``.  Full-width OLMo-1B (random weights from seed 0)
through ``Engine`` with ``attn_impl="dense"`` and ``"flash"``, then
full-width Mamba2-1.3B, each run through ``chip_smoke.run_engine`` (the
launch counters checked against its formulas); one line a run with the
sha256 of its tokens and its launch counts.  Two checkouts run in one
call give the same digests when a change leaves the served tokens as
they were.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its helpers; it imports nothing of the port at import)


def digest(tokens) -> str:
    return hashlib.sha256(json.dumps(tokens).encode()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: the engine runs on an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import kernels as K
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    K.build()
    none = chip_smoke.NO_LAUNCHES
    for arch in ("olmo-1b", "mamba2-1.3b"):
        cfg = get_config(arch)
        params = T.Transformer(cfg, init_params(T.model_layout(cfg), seed=0,
                                                device="cuda")).params
        layers = cfg.num_layers
        if arch == "olmo-1b":
            runs = [
                ("dense", lambda s, c: dict(none, decode_attention=s * layers,
                                            emit_norm_logits=s),
                 dict(prefill_chunk=128, attn_impl="dense")),
                ("flash", lambda s, c: dict(none, decode_attention=s * layers,
                                            emit_norm_logits=s, attention=c * layers),
                 dict(prefill_chunk=128, attn_impl="flash")),
            ]
        else:
            runs = [("auto", lambda s, c: dict(none, ssd=c * layers,
                                               rmsnorm=2 * (s + c) * layers,
                                               emit_norm_logits=s),
                     dict(prefill_chunk=cfg.ssm.chunk_size))]
        for name, want, serve in runs:
            tokens, launches = chip_smoke.run_engine(cfg, params, name, want, **serve)
            print(f"TOKENS {args.label} {arch} {name}: sha256 {digest(tokens)} launches "
                  f"{json.dumps(launches, sort_keys=True)}", flush=True)
        del params
        chip_smoke.free_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
