"""Quickstart for the PyTorch port: the Stream combinator algebra with a substitutable monad.

Builds stream programs with the algebra -- ``source . map . through .
zip . collect`` -- and runs them under the Lazy monad (sequential) and
under the Future monad (pipelined over stages, each stage a CUDA stream
of the card; on the CPU the stages run in tick order), showing the
paper's monad substitution: the program text does not change, only the
evaluator.  Then feedback (the serving decode shape), the chunking rule,
the prime sieve and a request served by the ``StreamEngine``.

Run (on the card unless ``--device cpu`` is given):
    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

``main(argv)`` returns what it printed, as numbers: the Lazy and Future
items, the zipped ones, the feedback items, the sieve's primes and the
served tokens.
"""
import argparse

import numpy as np
import torch

from repro_torch.algorithms import sieve
from repro_torch.core import (
    FutureEvaluator,
    LazyEvaluator,
    Stream,
    bubble_fraction,
    optimal_num_chunks,
)

STAGES = 4


def build_params(layout, device):
    """The served model's random weights (seed 0)."""
    from repro_torch.models.params import init_params

    return init_params(layout, seed=0, device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless 'cpu' is asked for; without a card "
                    "the default raises)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    out = {}

    # --- 1. A stream program, written with combinators ---------------------
    # Cell s multiplies the flowing item by a per-cell weight and bumps a
    # per-cell counter (mutable state, like the sieve's claimed primes).
    def cell_fn(state, item):
        weight, count = state
        return (weight, count + 1), torch.tanh(item * weight)

    num_cells, num_items = 8, 16
    states = (torch.linspace(0.5, 1.5, num_cells, device=device),
              torch.zeros(num_cells, dtype=torch.int32, device=device))
    items = torch.linspace(-1.0, 1.0, num_items * 4, device=device).reshape(num_items, 4)

    program = (
        Stream.source(items)
        .map(lambda x: x * 2.0)          # stateless: fused at lowering
        .through(cell_fn, states)        # the chain of dependent cells
    )

    lazy = program.collect(LazyEvaluator())
    print("lazy:   outs[0] =", lazy.items[0].cpu().numpy())
    fut = program.collect(FutureEvaluator(STAGES))
    print("future: outs[0] =", fut.items[0].cpu().numpy())
    print("lazy == future:", bool(torch.equal(lazy.items, fut.items)))
    print(f"bubble fraction (S={STAGES}, M={num_items}):", bubble_fraction(STAGES, num_items))
    out.update(lazy=lazy.items.cpu().numpy(), future=fut.items.cpu().numpy())

    # --- 1b. Multi-source: zip a second stream in --------------------------
    other = torch.linspace(0.0, 1.0, num_items * 4, device=device).reshape(num_items, 4)
    zipped = (
        Stream.source(items)
        .zip(Stream.source(other), lambda a, b: a + 0.25 * b)
        .through(cell_fn, states)
    )
    zl = zipped.collect(LazyEvaluator())
    zf = zipped.collect(FutureEvaluator(STAGES))
    print("zip: lazy == future:", bool(torch.equal(zl.items, zf.items)))
    out["zip"] = zl.items.cpu().numpy()

    # --- 1c. Feedback: a self-feeding stream (the serving decode shape) ----
    # Item b re-enters as emit(item b - lag): this is a decode loop --
    # the emitted token is the next step's input, per-cell state is the
    # KV cache, and `lag` in-flight items keep a pipeline busy.
    lag = 4
    fb = (
        Stream.feedback(items[:lag], num_items=12, emit=lambda x: x * 0.5 + 0.1)
        .through(cell_fn, states)
    )
    fb_lazy = fb.collect(LazyEvaluator())
    print("feedback: outs[-1] =", fb_lazy.items[-1].cpu().numpy())
    out["feedback"] = fb_lazy.items.cpu().numpy()

    # --- 2. The paper's §7 chunking rule -----------------------------------
    chunks = optimal_num_chunks(1.0, 4, 1e-3)
    print("optimal #chunks for work=1s, 4 stages, 1ms overhead:", chunks)
    out["chunks"] = chunks

    # --- 3. The paper's prime sieve (§5): source . mask . through ----------
    primes, count = sieve.run_sieve(200, block_size=64, primes_per_cell=4, device=device)
    primes = primes.cpu().numpy()
    print(f"primes < 200 ({int(count)}):", primes[primes > 0])
    out["primes"] = primes[primes > 0]

    # --- 4. Stream-shaped serving: decode as a feedback program ------------
    # The serving engine is the same construct at production scale: the
    # transformer's layer groups are the cells (each owning its KV-cache
    # shard as per-cell state), in-flight request microbatches are the
    # items, and the emit (logits -> sample -> re-embed) closes the loop.
    # StreamEngine runs it under LazyEvaluator here; give it stages and
    # it pipelines them over stage streams (gpipe / interleaved),
    # bit-identically.
    from repro_torch.configs.base import DecodePipelineConfig
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeConfig, StreamEngine

    # The smoke model's 16-wide heads are narrower than the CUDA kernels
    # take (32 to 256), so it runs the plain PyTorch ops on the card too.
    cfg = smoke_config(get_config("olmo-1b")).with_overrides(num_layers=4)
    params = build_params(T.model_layout(cfg), device)
    eng = StreamEngine(
        params, cfg,
        ServeConfig(max_batch=4, max_len=64, prefill_chunk=8, max_new_tokens=6),
        DecodePipelineConfig(num_cells=4, microbatches=2, round_steps=4, kernels="plain"),
        stages=None,  # pass a stage count to pipeline the cells over stage streams
        device=device,
    )
    reqs = [eng.submit(np.array([5, 9, 2, 7])), eng.submit(np.array([3, 1]))]
    eng.run_until_drained()
    for r in reqs:
        print(f"served req {r.uid}: {r.out_tokens}")
    out["served"] = {r.uid: list(r.out_tokens) for r in reqs}
    return out


if __name__ == "__main__":
    main()
