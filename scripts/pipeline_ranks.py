#!/usr/bin/env python3
"""The pipelined demo step across four ranks, one GPU each (NCCL), against
the Lazy step: the hops of ``FutureEvaluator(mesh=)`` crossing GPUs.

    python3 scripts/pipeline_ranks.py [--cpu] [--smoke] [--steps N]

Starts four processes (``torch.distributed`` over ``tcp://localhost``,
NCCL on ``cuda:RANK``; ``--cpu``: gloo on the CPU), each running
``launch.pipeline_demo.make_pipelined_loss`` on qwen3-32b at every
published width cut to 4 layers, fp32 (``--smoke``: its smoke config)
on 16 x 512 tokens (``--smoke``: 16 x 32) in 8 microbatches, random
weights from seed 0, under deterministic algorithms: ``--steps`` Lazy
steps (every rank all the stages), then the same steps pipelined on
``(pod 4)`` under gpipe, one_f_one_b autodiff and one_f_one_b planned (4
stages, one a rank), and on ``(pod 2, data 2)`` under interleaved planned
(4 stages, 2 virtual stages a pod rank, DTensor blocks on each pod
rank's ``data`` pair).  Every loss and leaf must be bitwise the Lazy
steps' (this rank's stages only); rank 0 prints each run's step p50
(host clock, synchronised) and peak memory, and the card's name and
power limit.  Exits non-zero on any difference or a rank's failure.
"""
from __future__ import annotations

import argparse
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
# (label, mesh shape, schedule, interleave, backward); 4 stages in every run
RUNS = (("pod4 gpipe", (4,), "gpipe", 1, "autodiff"),
        ("pod4 one_f_one_b", (4,), "one_f_one_b", 1, "autodiff"),
        ("pod4 one_f_one_b planned", (4,), "one_f_one_b", 1, "planned"),
        ("pod2 x data2 interleaved planned", (2, 2), "interleaved", 2, "planned"))
STAGES = 4


def rank_main(rank: int, port: int, args) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch import pytree as P
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.core.pipeline import local_stages
    from repro_torch.launch import pipeline_demo as PD
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.parallel import sharding as SH

    cpu = args.cpu
    device = "cpu" if cpu else f"cuda:{rank}"
    if not cpu:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo" if cpu else "nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    cfg = get_config("qwen3-32b")
    if args.smoke:
        cfg = smoke_config(cfg)
    cfg = cfg.with_overrides(num_layers=4, dtype=torch.float32, kernels="plain")
    seq = 32 if args.smoke else 512
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    toks = torch.randint(0, cfg.vocab_size, (16, seq + 1), generator=gen, device=device)
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    layout = T.model_layout(cfg)

    def sync():
        if not cpu:
            torch.cuda.synchronize()

    def run(step, params, bt):
        sync()
        if not cpu:
            torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(args.steps):
            t = time.perf_counter()
            params, loss = step(params, bt)
            sync()
            times.append(time.perf_counter() - t)
            losses.append(loss)
        peak = 0 if cpu else torch.cuda.max_memory_allocated()
        return params, losses, times, peak

    def start():
        params = init_params(layout, seed=0, device=device)
        return dict(params, blocks=PD.stage_params(params["blocks"], STAGES))

    def local(x):
        return x.to_local() if SH.is_dtensor(x) else x

    def full(x):
        return x.full_tensor() if SH.is_dtensor(x) else x

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    torch.use_deterministic_algorithms(True)
    failed = []
    lazy = None
    for label, shape, schedule, interleave, backward in RUNS:
        tcfg = PD._train_config(pipeline_schedule=schedule, pipeline_interleave=interleave,
                                pipeline_backward=backward)
        pcfg = tcfg.pipeline_config(STAGES)
        if shape == (4,):
            mesh = make_mesh(shape, ("pod",))
            if lazy is None:
                new, losses, times, peak = run(
                    PD.make_pipelined_loss(cfg, mesh, tcfg, STAGES, lazy=True), start(), batch)
                lazy = ([t.cpu() for t in P.leaves(dict(
                    new, blocks=local_stages(new["blocks"], pcfg, mesh)))], losses)
                del new
                say(f"Lazy (every rank all 4 stages): losses {[float(x) for x in losses]}, "
                    f"step p50 {statistics.median(times) * 1e3:.1f} ms "
                    f"({[round(x * 1e3, 1) for x in times]}), peak {peak / 1e9:.2f} GB")
            want, want_losses = lazy
            args_, bt = start(), batch
        else:
            mesh = make_mesh(shape, ("pod", "data"))
            sub = PD.stage_mesh(mesh)
            specs = SH.param_pspecs(layout, PD.RULES, sub)
            args_ = start()
            specs = dict(specs, blocks=P.tree_map(
                lambda s, t: SH.fit_spec(SH.PartitionSpec(None, *s), tuple(t.shape), sub),
                specs["blocks"], args_["blocks"]))
            args_ = P.tree_map(lambda t, s: SH.distribute(t, sub, SH.placements(s, sub)),
                               args_, specs)
            bt = {k: SH.distribute(v, sub, SH.placements(SH.fit_spec(
                SH.spec_for(("batch", "seq"), PD.RULES), tuple(v.shape), sub), sub))
                for k, v in batch.items()}
            new, want_losses, _, _ = run(PD.make_pipelined_loss(cfg, mesh, tcfg, STAGES,
                                                                lazy=True), args_, bt)
            want = [local(t).cpu() for t in P.leaves(dict(
                new, blocks=local_stages(new["blocks"], pcfg, mesh)))]
            del new
            args_ = P.tree_map(lambda t, s: SH.distribute(t, sub, SH.placements(s, sub)),
                               start(), specs)
        args_ = dict(args_, blocks=local_stages(args_["blocks"], pcfg, mesh))
        new, losses, times, peak = run(PD.make_pipelined_loss(cfg, mesh, tcfg, STAGES),
                                       args_, bt)
        same = [torch.equal(local(a).cpu(), b) for a, b in zip(P.leaves(new), want)]
        same_loss = all(torch.equal(full(a).cpu(), full(b).cpu())
                        for a, b in zip(losses, want_losses))
        del new
        if not (same_loss and all(same) and len(same) == len(want)):
            failed.append(label)
        say(f"{label}: losses {[float(full(x)) for x in losses]}, "
            f"{'bitwise' if same_loss and all(same) else 'DIFFERENT from'} the Lazy steps' "
            f"(rank 0: {sum(same)}/{len(same)} leaves); step p50 "
            f"{statistics.median(times) * 1e3:.1f} ms ({[round(x * 1e3, 1) for x in times]}), "
            f"peak {peak / 1e9:.2f} GB")
    torch.use_deterministic_algorithms(False)
    dist.barrier()
    dist.destroy_process_group()
    if failed:
        print(f"rank {rank}: {failed} differ from the Lazy steps", file=sys.stderr, flush=True)
        sys.exit(1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="gloo on the CPU (a rehearsal)")
    ap.add_argument("--smoke", action="store_true", help="qwen3-32b's smoke config")
    ap.add_argument("--steps", type=int, default=2)
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
    extra = [a for a in sys.argv[1:]]
    procs = [subprocess.Popen([sys.executable, __file__, *extra, "--rank", str(r),
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
