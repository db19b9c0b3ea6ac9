#!/usr/bin/env python3
"""The StreamEngine and the paper's two programs across four ranks, one
GPU each (NCCL): ``FutureEvaluator(mesh=)`` hopping between cards.

    python3 scripts/serve_ranks.py [--cpu] [--smoke]

Starts four processes (``torch.distributed`` over ``tcp://localhost``,
NCCL on ``cuda:RANK``; ``--cpu``: gloo on the CPU, the plain ops), each
holding full-width OLMo-1B (bf16, random weights from seed 0;
``--smoke``: its smoke config at 16 layers, fp32), on a one-axis
``pod`` mesh of the four ranks:

* Serving: ``chip_smoke.py``'s workload, 12 requests of 17-600 prompt
  tokens through ``max_batch`` 8, ``max_len`` 1024, 32 new tokens,
  ``prefill_chunk`` 128, ``attn_impl="flash"``, ``kernels="cuda"``.
  Rank 0 first serves it on its card alone: the ``Engine``, and the
  ``StreamEngine`` (Lazy) with 8 cells and 4 microbatches of 2.  Then
  every rank serves it through ``StreamEngine(mesh=)``: 8 cells and 1
  microbatch of 8 (gpipe), whose tokens must equal the one-card
  Engine's; 8 cells (2 a rank) and 4 microbatches of 2 under gpipe and
  under interleaved (2 virtual stages a rank), whose tokens must equal
  the one-card StreamEngine's.  Every rank must hold the same tokens;
  each rank's decode-attention launches must be its 2 cells' share (a
  quarter of the one-card StreamEngine's), only rank 3 may launch the
  emit, and every rank prefills (flash) as the one card does.  Rank 0
  prints tok/s and round p50 (host clock, synchronised) beside the
  one-card StreamEngine's.
* Supervised: run b's pipeline (8 cells, 4 microbatches of 2) through
  ``StreamEngine(mesh=)`` under ``ServeSupervisor``, which agrees every
  round attempt over the NCCL group: fault-free, ``raise@2`` on every
  rank and ``nan@2`` in rank 2's cells only, each with 0 requests lost,
  the one-card StreamEngine's tokens and the same ``stats`` and
  ``events`` on every rank; each rank snapshots its quarter of the cache
  (268,435,456 bytes of the 1,073,741,824), timed.
* Mamba2-1.3B at full width (48 blocks; ``--smoke``: 8 layers, fp32)
  through ``StreamEngine(mesh=)`` at 8 cells and 1 microbatch of 8: the
  tokens of its one-card ``Engine`` on every rank, SSD and RMSNorm
  launches as the calls made, the emit on rank 3 only.
* The paper's programs: the sieve (limit 20000, blocks of 256, 16 primes
  a cell, 168 cells: 42 a rank) and Fateman's (1+x+y+z)^20 squared (4
  limbs, 4 x-chunks, 224 cells of 8 terms: 56 a rank), gpipe across the
  four ranks, each equal to its exact result on every rank; rank 0
  prints the wall time (host clock, synchronised) beside the Lazy run
  on its card alone.  ``--smoke``: limit 2000 and power 8.

The launcher prints the cards' names and power limits.  Exits non-zero on
any difference or a rank's failure; every rank is killed after
``TIMEOUT_S``.
"""
from __future__ import annotations

import argparse
import datetime
import os
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 900
PROMPT_LENS = [17, 600, 128, 255, 64, 383, 511, 31, 129, 450, 200, 97]  # chip_smoke.py's
# (label, schedule, interleave, microbatches, round steps) of the ranked runs
RUNS = (("a: 8 cells, 1 microbatch, gpipe", "gpipe", 1, 1, 8),
        ("b: 8 cells, 4 microbatches, gpipe", "gpipe", 1, 4, 8),
        ("b: 8 cells, 4 microbatches, interleaved x2", "interleaved", 2, 4, 8))
CELLS = 8


def rank_main(rank: int, port: int, args) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.algorithms import polynomial as poly
    from repro_torch.algorithms import sieve
    from repro_torch.configs.base import DecodePipelineConfig
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.core import FutureEvaluator, LazyEvaluator
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import Engine, ServeConfig, StreamEngine

    cpu = args.cpu
    device = "cpu" if cpu else f"cuda:{rank}"
    if not cpu:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo" if cpu else "nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    mesh = make_mesh((WORLD,), ("pod",))
    cfg = get_config("olmo-1b")
    if args.smoke:
        cfg = smoke_config(cfg).with_overrides(num_layers=16, dtype=torch.float32)
    cfg = cfg.with_overrides(kernels="plain" if cpu else "cuda")
    params = T.Transformer(cfg, init_params(T.model_layout(cfg), seed=0, device=device)).params
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in PROMPT_LENS]
    scfg = ServeConfig(max_batch=8, max_len=1024, max_new_tokens=32, prefill_chunk=128,
                       attn_impl="flash")
    failed: list[str] = []

    def sync():
        if not cpu:
            torch.cuda.synchronize()

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    def serve(eng):
        """The workload through ``eng``: (tokens, wall s, round times,
        launch counts)."""
        rounds = []
        if isinstance(eng, StreamEngine):
            collect = eng._round

            def timed(*a):
                sync()
                t = time.perf_counter()
                out = collect(*a)
                sync()
                rounds.append(time.perf_counter() - t)
                return out

            eng._round = timed
        K.reset_launches()
        sync()
        t0 = time.perf_counter()
        reqs = [eng.submit(p) for p in prompts]
        eng.run_until_drained()
        sync()
        wall = time.perf_counter() - t0
        if not all(r.done and r.status == "ok" and len(r.out_tokens) == scfg.max_new_tokens
                   for r in reqs):
            failed.append(f"{type(eng).__name__}: a request did not finish its budget")
        return [r.out_tokens for r in reqs], wall, rounds, dict(K.LAUNCHES)

    def rate(tokens, wall, rounds):
        n = sum(map(len, tokens))
        p50 = f", round p50 {statistics.median(rounds) * 1e3:.1f} ms" if rounds else ""
        return f"{n} tokens in {wall:.3f} s: {n / wall:.1f} tok/s{p50}"

    # The kernels built once (rank 0; the ranks share the checkout's
    # build directory), then loaded and warmed on every card by one short
    # request, so that no timed run pays for either
    if rank == 0 and not cpu:
        K.build()
    dist.barrier()
    warm = Engine(params, cfg, ServeConfig(max_batch=8, max_len=1024, max_new_tokens=2,
                                           prefill_chunk=128, attn_impl="flash"), device=device)
    warm.submit(prompts[0])
    warm.run_until_drained()
    del warm

    # One card: rank 0 alone, the others waiting
    one = [None, None, None]
    if rank == 0:
        eng_tokens, wall, _, _ = serve(Engine(params, cfg, scfg, device=device))
        say(f"one card, Engine: {rate(eng_tokens, wall, [])}")
        pcfg = DecodePipelineConfig(num_cells=CELLS, microbatches=4, round_steps=8,
                                    admit_per_round=4)
        lazy_tokens, wall, rounds, launches = serve(StreamEngine(params, cfg, scfg, pcfg,
                                                                 device=device))
        say(f"one card, StreamEngine (Lazy, 8 cells, 4 microbatches): "
            f"{rate(lazy_tokens, wall, rounds)}; launches {launches}")
        one = [eng_tokens, lazy_tokens, launches]
    dist.broadcast_object_list(one, src=0)
    eng_tokens, lazy_tokens, one_launches = one

    layers = cfg.num_layers
    for label, schedule, interleave, m, steps in RUNS:
        pcfg = DecodePipelineConfig(num_cells=CELLS, microbatches=m, schedule=schedule,
                                    interleave=interleave, round_steps=steps,
                                    admit_per_round=4)
        eng = StreamEngine(params, cfg, scfg, pcfg, mesh=mesh, device=device)
        tokens, wall, rounds, launches = serve(eng)
        want = eng_tokens if m == 1 else lazy_tokens
        items = eng.rounds * steps * m
        expect = {"decode_attention": items * layers // WORLD,
                  "emit_norm_logits": items if rank == WORLD - 1 else 0}
        if m > 1:
            expect["decode_attention"] = one_launches["decode_attention"] // WORLD
        if cpu:
            expect = {k: 0 for k in expect}  # the plain ops count no launch
        got = {k: launches[k] for k in expect}
        every = [None] * WORLD
        dist.all_gather_object(every, (tokens, got, launches["attention"]))
        same = all(t == want for t, _, _ in every)
        if not same:
            failed.append(f"{label}: tokens differ from the one card's")
        if got != expect:
            failed.append(f"{label}: rank {rank} launches {got}, expected {expect}")
        say(f"{label}: across {WORLD} ranks {rate(tokens, wall, rounds)} (rank 0); tokens "
            f"{'identical to' if same else 'DIFFERENT from'} the one-card "
            f"{'Engine' if m == 1 else 'StreamEngine'}'s on every rank; launches by rank "
            f"(decode attention, emit, flash) {[(g['decode_attention'], g['emit_norm_logits'], f) for _, g, f in every]}")
        del eng

    # Supervised across the ranks: run b's pipeline under ServeSupervisor
    supervised_ranks(params, cfg, scfg, prompts, lazy_tokens, mesh, rank, device, cpu, failed,
                     say)
    del params
    free_card(cpu)
    # Mamba2-1.3B across the ranks, beside its one-card Engine
    mamba_ranks(args, mesh, rank, device, cpu, failed, say)

    # The paper's programs
    limit, power = (2000, 8) if args.smoke else (20000, 20)
    cells = 168 if not args.smoke else 32  # divisible by the 4 ranks
    ranked = FutureEvaluator(mesh=mesh)

    def timed(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t

    ref = sieve.reference_primes(limit)
    (primes, count), wall = timed(lambda: sieve.run_sieve(
        limit, block_size=256, primes_per_cell=16, num_cells=cells, evaluator=ranked,
        device=device))
    p = primes.cpu().numpy()
    if int(count) != len(ref) or not np.array_equal(p[p > 0], ref):
        failed.append(f"sieve across ranks: {int(count)} primes, expected {len(ref)}")
    terms = poly.fateman_terms(power)
    mod = 1 << (13 * 4)
    exact = {k: v % mod for k, v in poly.reference_product(terms, terms).items() if v % mod}
    capacity = -(-len(terms) // 32) * 32  # 4 x-chunks, cells of 8 terms, over 4 ranks
    x = poly.fateman_poly(power, capacity, 4, device=device)
    product, pwall = timed(lambda: poly.times(x, x, evaluator=ranked, num_x_chunks=4,
                                              terms_per_cell=8))
    if poly.to_dict(product) != exact:
        failed.append("fateman across ranks: differs from the exact product mod 2^52")
    dist.barrier()
    if rank == 0:
        (lprimes, _), lwall = timed(lambda: sieve.run_sieve(
            limit, block_size=256, primes_per_cell=16, num_cells=cells,
            evaluator=LazyEvaluator(), device=device))
        lproduct, lpwall = timed(lambda: poly.times(x, x, num_x_chunks=4, terms_per_cell=8))
        if not (torch.equal(lprimes, primes) and torch.equal(lproduct.keys, product.keys)
                and torch.equal(lproduct.coeffs, product.coeffs)):
            failed.append("the Lazy runs on one card differ from the runs across ranks")
        say(f"sieve (limit {limit}, {len(ref)} primes, {cells} cells): across {WORLD} ranks "
            f"{wall:.3f} s, Lazy on one card {lwall:.3f} s; equal to Eratosthenes")
        say(f"fateman (1+x+y+z)^{power} squared, 4 limbs ({len(exact)} terms, {capacity // 8} "
            f"cells): across {WORLD} ranks {pwall:.3f} s, Lazy on one card {lpwall:.3f} s; "
            f"equal to the exact product mod 2^52")
    dist.barrier()
    dist.destroy_process_group()
    if failed:
        print(f"rank {rank}: {failed}", file=sys.stderr, flush=True)
        sys.exit(1)


def free_card(cpu: bool) -> None:
    """Give back the memory of dropped weights (wrappers close over them)."""
    import gc

    import torch

    gc.collect()
    if not cpu:
        torch.cuda.empty_cache()


def supervised_ranks(params, cfg, scfg, prompts, want, mesh, rank, device, cpu, failed,
                     say) -> None:
    """``ServeSupervisor`` over ``StreamEngine(mesh=)`` at 8 cells and 4
    microbatches (gpipe): fault-free, ``raise@2`` on every rank, and
    ``nan@2`` in rank 2's cells only.  Every run loses no request and
    gives ``want`` (the one-card StreamEngine's tokens) on every rank,
    with the same ``stats`` and ``events`` on every rank; each rank's
    snapshot holds its cells' quarter of the cache, timed a round."""
    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch import pytree as P
    from repro_torch.configs.base import DecodePipelineConfig
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import StreamEngine
    from repro_torch.serve.supervisor import ServeSupervisor, chaos_injector

    pcfg = DecodePipelineConfig(num_cells=CELLS, microbatches=4, round_steps=8,
                                admit_per_round=4)
    eng = StreamEngine(params, cfg, scfg, pcfg, mesh=mesh, device=device)
    pristine = ServeSupervisor(eng).snapshot()
    nbytes = sum(t.numel() * t.element_size() for t in P.leaves(eng.cell_states))
    whole = sum(t.numel() * t.element_size()
                for t in P.leaves(T.cache_layout(cfg, scfg.max_batch, scfg.max_len)))
    if nbytes * WORLD != whole:
        failed.append(f"supervised: rank {rank} holds {nbytes} bytes of a {whole}-byte cache")
    for label, injector in (("fault-free", None), ("raise@2", chaos_injector("raise", 2)),
                            ("nan@2 in rank 2's cells",
                             chaos_injector("nan", 2) if rank == 2 else None)):
        sup = ServeSupervisor(eng, fail_injector=injector)
        sup.restore(pristine)
        snaps, rounds = [], []
        snapshot, step = sup._snapshot, sup.step

        def timed(fn, into):
            def call(*a):
                if not cpu:
                    torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a)
                if not cpu:
                    torch.cuda.synchronize()
                into.append(time.perf_counter() - t)
                return out
            return call

        sup._snapshot, sup.step = timed(snapshot, snaps), timed(step, rounds)
        K.reset_launches()
        reqs = [sup.submit(p) for p in prompts]
        sup.run_until_drained()
        tokens = [r.out_tokens for r in reqs]
        p50 = statistics.median(snaps[1:] or snaps)
        every = [None] * WORLD
        dist.all_gather_object(every, (tokens, sup.stats, sup.events, p50,
                                       dict(K.LAUNCHES)["decode_attention"]))
        if not all(t == want for t, *_ in every):
            failed.append(f"supervised {label}: tokens differ from the one-card StreamEngine's")
        if any(s != sup.stats or e != sup.events for _, s, e, _, _ in every):
            failed.append(f"supervised {label}: stats or events differ between ranks")
        if sup.stats["requests_lost"] or sup.stats["restarts"] != (label != "fault-free"):
            failed.append(f"supervised {label}: stats {sup.stats}")
        say(f"supervised {label}: across {WORLD} ranks (rank 0) {sum(map(len, tokens))} "
            f"tokens, round p50 {statistics.median(rounds) * 1e3:.1f} ms (host clock, "
            f"synchronised); tokens identical to the one-card StreamEngine's on every rank; "
            f"stats {sup.stats}; snapshot of {nbytes} bytes a rank ({whole} in all), p50 by "
            f"rank {[round(t * 1e3, 2) for *_, t, _ in every]} ms, "
            f"{sum(snaps) / sum(rounds):.3f} of rank 0's supervised rounds' time; decode "
            f"attention launches by rank {[n for *_, n in every]}; events "
            f"{[e['event'] for e in sup.events]}")
    del eng, pristine


def mamba_ranks(args, mesh, rank, device, cpu, failed, say) -> None:
    """Mamba2-1.3B (48 blocks; ``--smoke``: its smoke config at 8 layers,
    fp32) through ``StreamEngine(mesh=)`` at 8 cells and 1 microbatch of 8
    (gpipe), beside the one-card ``Engine`` (rank 0): the same tokens on
    every rank; SSD and RMSNorm launches as the calls made (every rank
    prefills the whole model; a rank decodes its cells), the emit on rank
    3 only.  ``prefill_chunk`` is the SSD chunk, 256."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.configs.base import DecodePipelineConfig
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import Engine, ServeConfig, StreamEngine

    cfg = get_config("mamba2-1.3b")
    if args.smoke:
        cfg = smoke_config(cfg).with_overrides(num_layers=8, dtype=torch.float32)
    cfg = cfg.with_overrides(kernels="plain" if cpu else "cuda")
    params = T.Transformer(cfg, init_params(T.model_layout(cfg), seed=0, device=device)).params
    scfg = ServeConfig(max_batch=8, max_len=1024, max_new_tokens=32,
                       prefill_chunk=cfg.ssm.chunk_size)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in PROMPT_LENS]

    def serve(eng):
        prefills = [0]
        prefill = eng._prefill

        def counted(*a, **kw):
            prefills[0] += 1
            return prefill(*a, **kw)

        eng._prefill = counted
        K.reset_launches()
        if not cpu:
            torch.cuda.synchronize()
        t = time.perf_counter()
        reqs = [eng.submit(p) for p in prompts]
        eng.run_until_drained()
        if not cpu:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        tokens = [r.out_tokens for r in reqs]
        if not all(r.done and len(t) == scfg.max_new_tokens for r, t in zip(reqs, tokens)):
            failed.append(f"mamba {type(eng).__name__}: a request did not finish its budget")
        return tokens, wall, prefills[0], dict(K.LAUNCHES)

    one = [None, None]
    if rank == 0:
        tokens, wall, _, _ = serve(Engine(params, cfg, scfg, device=device))
        n = sum(map(len, tokens))
        say(f"mamba one card, Engine: {n} tokens in {wall:.3f} s: {n / wall:.1f} tok/s")
        one = [tokens, wall]
    dist.broadcast_object_list(one, src=0)
    pcfg = DecodePipelineConfig(num_cells=CELLS, microbatches=1, round_steps=8,
                                admit_per_round=4)
    eng = StreamEngine(params, cfg, scfg, pcfg, mesh=mesh, device=device)
    tokens, wall, calls, launches = serve(eng)
    items = eng.rounds * pcfg.round_steps
    layers = cfg.num_layers
    expect = {"ssd": calls * layers, "rmsnorm": 2 * layers * (calls + items // WORLD),
              "emit_norm_logits": items if rank == WORLD - 1 else 0, "decode_attention": 0}
    if cpu:
        expect = {k: 0 for k in expect}  # the plain ops count no launch
    got = {k: launches[k] for k in expect}
    every = [None] * WORLD
    dist.all_gather_object(every, (tokens, got))
    same = all(t == one[0] for t, _ in every)
    if not same:
        failed.append("mamba across ranks: tokens differ from the one-card Engine's")
    if got != expect:
        failed.append(f"mamba across ranks: rank {rank} launches {got}, expected {expect}")
    n = sum(map(len, tokens))
    say(f"mamba across {WORLD} ranks ({cfg.num_layers} blocks, {CELLS} cells, 1 microbatch of "
        f"8): {n} tokens in {wall:.3f} s: {n / wall:.1f} tok/s (rank 0; one card's Engine "
        f"{one[1]:.3f} s); tokens {'identical to' if same else 'DIFFERENT from'} the one-card "
        f"Engine's on every rank; launches by rank (ssd, rmsnorm, emit) "
        f"{[(g['ssd'], g['rmsnorm'], g['emit_norm_logits']) for _, g in every]}")
    del eng, params
    free_card(cpu)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="gloo on the CPU (a rehearsal)")
    ap.add_argument("--smoke", action="store_true", help="OLMo-1B's smoke config, small programs")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.port, args)
        return 0
    if not args.cpu:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
            print(f"needs {WORLD} CUDA devices (or --cpu)", file=sys.stderr)
            return 1
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, stdin=subprocess.DEVNULL, timeout=60,
        ).stdout.strip().splitlines()
        print(f"{len(smi)} cards: {sorted(set(smi))}", flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, *sys.argv[1:], "--rank", str(r),
                               "--port", str(port)], stdin=subprocess.DEVNULL,
                              env=dict(os.environ, OMP_NUM_THREADS="1"))
             for r in range(WORLD)]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        print(f"a rank ran past {TIMEOUT_S} s", file=sys.stderr)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    print(f"ranks exited {codes}", flush=True)
    return 0 if codes == [0] * WORLD else 1


if __name__ == "__main__":
    sys.exit(main())
