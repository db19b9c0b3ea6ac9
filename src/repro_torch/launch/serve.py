"""End-to-end serving entry point: continuous batching over a token stream.

PyTorch port of ``repro.launch.serve``, with the reference's flags.  It
runs on the card unless ``--device cpu`` is given (without a card the
default raises); ``--kernels`` is ``plain | cuda | auto`` (``auto``: the
CUDA kernels on a card, the plain PyTorch ops on the CPU).

    # layer-sequential reference engine (smoke-sized, on the CPU)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --smoke --device cpu --requests 8 --max-new 6

    # Stream-shaped decode: 8 cells over 4 pipeline stages, each stage a
    # CUDA stream of the one card (--devices 0 or 1: the Lazy evaluator)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --engine stream --devices 4 --cells 8 --microbatches 4 \\
        --max-batch 8 --max-len 1024 --prefill-chunk 128 --kernels cuda

    # Resilient serving: supervised rounds with a watchdog deadline and
    # a chaos fault injected at round 2 to show zero-loss replay
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --smoke --device cpu --requests 8 --watchdog-ms 30000 --chaos raise@2

    # a Mixture-of-Experts model (also llama4-maverick-400b-a17b and the
    # hybrid jamba-1.5-large-398b; full width only where it fits the card)
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch moonshot-v1-16b-a3b --smoke --device cpu --requests 4

    # the vision-language llama-3.2-vision-90b serves text prompts, as
    # the JAX engines do: no vision embeds are passed, so its
    # cross-attention blocks read the zero vision K/V of a fresh cache
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama-3.2-vision-90b --smoke --device cpu --requests 4

    # the same decode across the GPUs of a host: one rank a card, the
    # 8 cells split over the 4 ranks of a one-axis "pod" mesh (NCCL;
    # with --device cpu, gloo); --devices must be the world size, and
    # rank 0 prints
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --arch olmo-1b \\
        --engine stream --devices 4 --cells 8 --microbatches 4 \\
        --max-batch 8 --max-len 1024 --prefill-chunk 128 --kernels cuda

    # supervised across the ranks: every rank's supervisor agrees each
    # round's faults, replays and drain with the others (a SIGTERM to
    # any rank drains all of them); --chaos fires on every rank
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --arch olmo-1b \\
        --engine stream --devices 4 --cells 8 --microbatches 4 \\
        --max-batch 8 --max-len 1024 --prefill-chunk 128 --kernels cuda \\
        --watchdog-ms 30000 --chaos raise@2

``main(argv)`` returns the finished requests.  An embedding-input arch
(musicgen-medium) exits with a message, as the reference's CLI does: it
needs the embedding frontend stub.
"""
from __future__ import annotations

import argparse
import datetime
import os
import signal
import time

import numpy as np

from repro_torch.configs.base import DecodePipelineConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, smoke_config
from repro_torch.kernels import KERNEL_MODES
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params, param_count
from repro_torch.serve.engine import (
    Engine, QueueFullError, ServeConfig, StreamEngine,
    decode_copy_bytes_per_tick, suggest_decode_pipeline,
)
from repro_torch.serve.supervisor import ServeSupervisor, SupervisorConfig, chaos_injector


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-32b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda unless 'cpu' is asked "
                    "for; without a card the default raises)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    # Stream-shaped serving knobs (DecodePipelineConfig)
    ap.add_argument("--engine", choices=("sequential", "stream"),
                    default="sequential")
    ap.add_argument("--schedule", default="gpipe",
                    choices=("gpipe", "one_f_one_b", "interleaved"))
    ap.add_argument("--interleave", type=int, default=1)
    ap.add_argument("--cells", type=int, default=4,
                    help="layer-group pipeline cells (must divide groups)")
    ap.add_argument("--microbatches", type=int, default=4,
                    help="in-flight request microbatches (feedback lag)")
    ap.add_argument("--round-steps", type=int, default=8,
                    help="decode steps per round")
    ap.add_argument("--admit-per-round", type=int, default=4)
    ap.add_argument("--kernels", choices=KERNEL_MODES, default="auto",
                    help="decode-path kernel dispatch (repro_torch.kernels): "
                    "cuda = the hand-written Hopper kernels (a card is "
                    "required); plain = the PyTorch ops; auto = cuda on a "
                    "card, plain on the CPU")
    ap.add_argument("--devices", type=int, default=0,
                    help="pipeline stages for --engine stream, each a CUDA "
                    "stream of the card (0 or 1 = LazyEvaluator, "
                    "layer-sequential); under a torch.distributed process "
                    "group (torchrun) the ranks of the world, one a stage")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="override layer count (smoke configs have only "
                    "2 groups — deepen them so --cells can split)")
    ap.add_argument("--suggest-schedule", action="store_true",
                    help="print chunking.optimal_schedule's pick with the "
                    "decode cache-traffic (per-tick copy-bytes) term "
                    "before serving; compute terms come from "
                    "--model-work/--model-overhead (only the copy bytes "
                    "are derived from the model config)")
    ap.add_argument("--model-work", type=float, default=1e-3,
                    help="modeled serial decode-step seconds per item "
                    "for --suggest-schedule (an assumption, not a "
                    "measurement)")
    ap.add_argument("--model-overhead", type=float, default=1e-5,
                    help="modeled per-tick dispatch overhead seconds "
                    "for --suggest-schedule")
    ap.add_argument("--model-copy-gbps", type=float, default=50.0,
                    help="modeled cache write bandwidth (GB/s) for the "
                    "copy-bytes term")
    # Resilience knobs (repro_torch.serve.supervisor / engine robustness)
    ap.add_argument("--deadline-ms", type=float, default=0,
                    help="per-request wall-clock deadline from submission "
                    "(0 = none); expired requests resolve with "
                    "status='expired' at the next step boundary")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded admission queue (0 = unbounded); a full "
                    "queue sheds load by rejecting submit")
    ap.add_argument("--watchdog-ms", type=float, default=0,
                    help="supervised-round watchdog deadline (0 = off); "
                    "setting it wraps the engine in a ServeSupervisor "
                    "with snapshot/replay fault recovery")
    ap.add_argument("--chaos", default=None, metavar="KIND@ROUND",
                    help="inject one fault for the recovery demo: "
                    "raise@K, nan@K, wedge@K, or sigterm@K (implies the "
                    "supervisor; see repro_torch.serve.supervisor)")
    return ap


# How long a rank waits on the others before its collective fails (a
# rank that died fails the world; it never hangs it).
GROUP_TIMEOUT = datetime.timedelta(seconds=300)


def _world(args):
    """``(rank, world size, made)`` of the process group the CLI serves
    across -- the caller's, or one it makes from torchrun's ``env://``
    variables (``made``) -- or None without one.  NCCL on
    ``cuda:LOCAL_RANK``, gloo with ``--device cpu``."""
    import torch
    import torch.distributed as dist

    made = False
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return None
        if args.device != "cpu":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("gloo" if args.device == "cpu" else "nccl",
                                init_method="env://", timeout=GROUP_TIMEOUT)
        made = True
    if dist.get_world_size() <= 1:
        return None
    return dist.get_rank(), dist.get_world_size(), made


def main(argv=None):
    args = _parser().parse_args(argv)
    world = _world(args)
    if world is None:
        return _serve(args, None, print)
    rank, size, made = world
    try:
        if args.engine != "stream" or args.devices != size:
            raise SystemExit(f"under a process group of {size} ranks the CLI serves "
                             f"--engine stream --devices {size} across them")
        from repro_torch.launch.mesh import make_mesh

        if args.device != "cpu":
            args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
        # the StreamEngine's cells split over a one-axis pod mesh of the
        # world, each rank on its own device; rank 0 prints
        return _serve(args, make_mesh((size,), ("pod",)), print if rank == 0 else _quiet)
    finally:
        if made:
            import torch.distributed as dist

            dist.destroy_process_group()


def _quiet(*_args, **_kw) -> None:
    pass


def _serve(args, mesh, say):
    """Serve ``args``'s workload (a StreamEngine across the ranks of
    ``mesh`` where one is given), printing through ``say``."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.num_layers:
        cfg = cfg.with_overrides(num_layers=args.num_layers)
    cfg = cfg.with_overrides(kernels=args.kernels)
    if cfg.embeds_input:
        raise SystemExit("embeds-input archs need the embedding frontend stub; "
                         "use a token arch for the serving example")
    layout = T.model_layout(cfg)
    params = init_params(layout, seed=args.seed, device=args.device)
    say(f"arch={cfg.name} params={param_count(layout)/1e6:.1f}M device={args.device}")

    scfg = ServeConfig(
        max_batch=args.max_batch, max_len=args.max_len,
        prefill_chunk=args.prefill_chunk, max_new_tokens=args.max_new,
        temperature=args.temperature, seed=args.seed,
        max_queue=args.max_queue or None,
    )
    if args.engine == "stream":
        ndev = args.devices
        pcfg = DecodePipelineConfig(
            num_cells=args.cells, microbatches=args.microbatches,
            schedule=args.schedule, interleave=args.interleave,
            round_steps=args.round_steps, admit_per_round=args.admit_per_round,
        )
        if args.suggest_schedule and ndev <= 1:
            say(
                "suggest-schedule: skipped — needs > 1 pipeline stage "
                "(set --devices); there is no (schedule, M, V) choice on "
                "one stage"
            )
        if args.suggest_schedule and ndev > 1:
            mb = max(1, args.max_batch // args.microbatches)
            pick = suggest_decode_pipeline(
                cfg, devices=ndev, work_per_item=args.model_work,
                per_tick_overhead=args.model_overhead, microbatch=mb,
                num_cells=args.cells, max_len=args.max_len,
                copy_bytes_per_second=args.model_copy_gbps * 1e9,
                max_chunks=args.max_batch,
            )
            rows_b = decode_copy_bytes_per_tick(cfg, mb, args.cells)
            slab_b = decode_copy_bytes_per_tick(
                cfg, mb, args.cells, row_scatter=False, max_len=args.max_len
            )
            say(
                f"cost-model pick (ASSUMING work/item={args.model_work}s, "
                f"tick overhead={args.model_overhead}s, "
                f"{args.model_copy_gbps:.0f} GB/s — override with "
                f"--model-*; only the copy bytes are config-derived): "
                f"{pick.schedule} M={pick.num_chunks} V={pick.interleave}; "
                f"per-tick cache rows ≈ {rows_b} B vs {slab_b} B under "
                f"the slab scheme"
            )
        eng = StreamEngine(params, cfg, scfg, pcfg,
                           stages=ndev if ndev > 1 and mesh is None else None,
                           device=args.device, mesh=mesh)
        mode = (f"stream/{args.schedule}xV{args.interleave} D={ndev}"
                f"{' ranks' if mesh is not None else ''} "
                f"S={args.cells} M={args.microbatches} T={args.round_steps} "
                f"kernels={eng.kernels}")
    else:
        if args.suggest_schedule:
            say(
                "suggest-schedule: skipped — the cost model picks a "
                "pipeline (schedule, M, V); run with --engine stream"
            )
        eng = Engine(params, cfg, scfg, device=args.device)
        mode = "sequential"

    # Supervised serving: --chaos or --watchdog-ms wraps the engine in a
    # ServeSupervisor (round snapshot/replay, bounded retry, SIGTERM
    # drain).  Submission and drain go through the supervisor so its
    # bookkeeping sees every request.
    server, sup = eng, None
    if args.chaos or args.watchdog_ms:
        injector = None
        if args.chaos:
            try:
                kind, at = args.chaos.rsplit("@", 1)
                injector = chaos_injector(kind, int(at))
            except ValueError as e:
                raise SystemExit(f"--chaos expects KIND@ROUND: {e}") from e
        sup = ServeSupervisor(
            eng,
            SupervisorConfig(deadline_s=(args.watchdog_ms / 1e3) or None),
            fail_injector=injector,
        )
        server = sup
        mode += " +supervised"

    np_rng = np.random.default_rng(args.seed)
    deadline_s = (args.deadline_ms / 1e3) or None
    prev_sigterm = signal.getsignal(signal.SIGTERM)
    if sup is not None:
        sup.install_signal_handlers()
    try:
        t0 = time.perf_counter()
        reqs, shed = [], 0
        for _ in range(args.requests):
            prompt = np_rng.integers(0, cfg.vocab_size, size=args.prompt_len)
            try:
                reqs.append(server.submit(prompt, deadline_s=deadline_s))
            except QueueFullError:
                shed += 1
        done = server.run_until_drained()
        wall = time.perf_counter() - t0
    finally:
        # main() may be called in process: hand SIGTERM back to the caller
        signal.signal(signal.SIGTERM, prev_sigterm)
    total_new = sum(len(r.out_tokens) for r in done)
    expired = sum(r.status == "expired" for r in done)
    say(f"[{mode}] {len(done)} requests, {total_new} tokens in {wall:.2f}s "
          f"({total_new/wall:.1f} tok/s with continuous batching)")
    if shed or expired:
        say(f"  load_shed={shed} expired={expired}")
    if sup is not None:
        say(f"  supervisor: {sup.stats}")
    for r in done[:4]:
        say(f"  req {r.uid}: {r.out_tokens}")
    return done


if __name__ == "__main__":
    main()
