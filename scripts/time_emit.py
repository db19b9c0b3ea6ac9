#!/usr/bin/env python3
"""Time the emit kernel of one checkout of the port on one NVIDIA GPU.

    python3 scripts/time_emit.py [--src DIR] [--label NAME] [--repeat N]

``DIR`` is the ``src`` directory of a checkout of this repository (by
default this one's); its kernels are built into that checkout's
``build/kernels``.  Every case of ``chip_smoke.EMIT_CASES`` runs through
``chip_smoke.emit_case``: the checkout's kernel against its plain version,
its device time beside norm + matmul's and the bytes bound, one line a
case (the list ``N`` times over), then one JSON line of all of them.
Two checkouts run in turns in one call (parent, change, change, parent)
compare on one card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its helpers; it imports nothing of the port at import)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--repeat", type=int, default=1, help="times over the list of cases")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: the emit kernel runs on an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.emit_norm_logits.ops import emit_norm_logits
    from repro_torch.kernels.emit_norm_logits.ref import emit_norm_logits_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{args.label}: {emit_norm_logits.__module__} from {args.src}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for rep in range(args.repeat):
        for norm, tied, v, d, dtypes in chip_smoke.EMIT_CASES:
            for name in dtypes:
                row = chip_smoke.emit_case(gen, norm, tied, v, d, getattr(torch, name),
                                           emit_norm_logits, emit_norm_logits_ref)
                rows.append(dict(norm=norm, tied=tied, V=v, d=d, dtype=name, rep=rep, **row))
    print(json.dumps({"label": args.label, "emit": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
