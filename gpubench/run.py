"""Run one cell of the benchmark once and print its result line.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Exits non-zero, printing no result, where
no CUDA device is present or fewer than the cell asks for, and where a
module of JAX or of the JAX package is loaded once the window has
closed.  The last lines on standard error, and the result's last key
``checks``, give each number that decides ``correct`` beside its limit.

``--control 1`` (never used by a benchmark run) adds the readings of
the control and of the faults planted in the reference
(``PERF.md`` gives the limits they set).
"""
from __future__ import annotations

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from gpubench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.use_checkout()
    cell = harness.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"{args.workload} needs {cell.entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              started=STARTED, control=bool(args.control))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules of JAX or of the JAX package are loaded: {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
