#!/usr/bin/env python3
"""Where a full-width OLMo-1B train step's time and memory go, on one NVIDIA GPU.

    python3 scripts/profile_train.py [--steps N] [--label NAME] [--default-workspace]

Builds the training phase of ``chip_smoke.py`` (OLMo-1B at full width
and depth, random weights from seed 0; 8 x 2048 tokens a step in 2
microbatches, remat, chunked attention, AdamW with fp32 moments), runs
two warm-up steps, then ``N`` steps (3 by default) under
``torch.profiler`` and prints: each step's host-clock time
(synchronised); the device's busy time over the steps' window and its
idle share (``repro_torch.roofline.trace``: the union of the kernel,
memcpy and memset spans), the 10 longest idle gaps with the host op that
held each; the 25 device
kernels (by stem) with the most time; and the peak memory of each part of a step
(the forward and backward of each microbatch, the update).  The last
line is one JSON object of the numbers.  ``--default-workspace`` drops
the ``CUBLAS_WORKSPACE_CONFIG`` that ``chip_smoke.py`` sets for its
deterministic fault replay, so that cuBLAS runs with its own default.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its helpers and settings; imports nothing of the port)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--label", default="")
    ap.add_argument("--default-workspace", action="store_true")
    args = ap.parse_args()
    if args.default_workspace:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: the train step is profiled on an NVIDIA GPU")
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.train import init_opt_state, make_train_step
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, stdin=subprocess.DEVNULL,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    cfg = get_config("olmo-1b")
    params = init_params(T.model_layout(cfg), seed=0, device="cuda")
    tcfg, ocfg, batch_fn = chip_smoke.train_setup(cfg)
    step_fn = make_train_step(cfg, tcfg, ocfg)
    opt = init_opt_state(params, ocfg)
    for step in range(2):
        params, opt, _ = step_fn(params, opt, batch_fn(step))
    torch.cuda.synchronize()

    # the peak of each part of a step
    peaks = {}
    base = torch.cuda.memory_allocated()
    real_vg, real_update = TS.value_and_grad, O.adamw_update
    calls = [0]

    def vg(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = real_vg(*a, **k)
        torch.cuda.synchronize()
        peaks[f"microbatch {calls[0]} forward+backward"] = torch.cuda.max_memory_allocated() - base
        calls[0] += 1
        return out

    def update(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = real_update(*a, **k)
        torch.cuda.synchronize()
        peaks["update (global norm, AdamW)"] = torch.cuda.max_memory_allocated() - base
        return out

    TS.value_and_grad, O.adamw_update = vg, update
    try:
        params, opt, _ = step_fn(params, opt, batch_fn(2))
    finally:
        TS.value_and_grad, O.adamw_update = real_vg, real_update
    for name, peak in peaks.items():
        print(f"peak above the weights and AdamW state ({base / 1e9:.2f} GB): {name} "
              f"{peak / 1e9:.2f} GB", flush=True)

    from repro_torch.roofline import trace as TR

    times, state = [], [params, opt]
    del params, opt
    batches = [batch_fn(3 + step) for step in range(args.steps)]

    def step(i):
        t = time.perf_counter()
        state[0], state[1], _ = step_fn(state[0], state[1], batches[i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)

    records = TR.profile_steps(step, args.steps, shapes=False)
    window = TR.span_window(records)
    busy = TR.device_busy_us(records, window)
    wall_us = window[1] - window[0]
    kernels = sum(1 for r in records if r.kind == "kernel" and window[0] <= r.start < window[1])
    print(f"{args.label} {smi}: step times {[round(t * 1e3, 1) for t in times]} ms; device "
          f"busy {busy / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms (idle share "
          f"{TR.idle_share(records, window):.3f}); {kernels} device kernels, "
          f"{kernels / args.steps:.0f} a step", flush=True)
    print("longest gaps: " + "; ".join(f"{g / 1e3:.3f} ms in {op}"
                                       for g, _, op in TR.longest_gaps(records, 10, window)),
          flush=True)
    for name, total, count in TR.kernel_time_by_name(records, 25, window):
        print(f"  {total / 1e3:10.3f} ms  {total / busy:6.1%}  x{count:<6d} {name}", flush=True)
    print(json.dumps({"label": args.label, "device": smi, "step_ms": [t * 1e3 for t in times],
                      "step_p50_ms": statistics.median(times) * 1e3,
                      "device_busy_ms": busy / 1e3, "wall_ms": wall_us / 1e3,
                      "kernels_a_step": kernels / args.steps,
                      "peaks_gb": {k: v / 1e9 for k, v in peaks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
