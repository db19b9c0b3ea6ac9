"""End-to-end training entry point (port of ``repro.launch.train``, without the mesh).

Wires the training substrate together: config registry -> parameters
and AdamW state on one device -> step-keyed synthetic data -> the train
step (a microbatch stream) -> the resilient loop (heartbeats, straggler
detection, asynchronous checkpoints, restart on failure).  It runs on
the card unless ``--device cpu`` is given (without a card the default
raises).  Training runs the plain PyTorch ops, as the reference's runs
XLA's: ``--kernels`` is ``plain`` or ``auto`` (which resolves to plain).

    # smoke-sized, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --device cpu --steps 20 --global-batch 8 --seq-len 64

    # full-width OLMo-1B on the card, resumable
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --steps 100 --global-batch 8 --seq-len 2048 --microbatches 2 \\
        --attn-impl chunked --checkpoint-dir build/ckpt --resume

``main(argv)`` returns the history (one dict a step).  An
embedding-input arch (musicgen-medium) and a cross-attention arch
(llama-3.2-vision-90b) exit with a message: the synthetic source makes
tokens only (the reference's CLI fails on them deeper in).
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import time
from pathlib import Path

import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params, param_count
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault import FaultConfig, ResilientLoop
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import TrainConfig, make_train_step

DEFAULT_CHECKPOINT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def build(args):
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
        cfg = cfg.with_overrides(
            d_model=args.d_model or 256,
            num_layers=args.layers or cfg.num_layers,
            d_ff=4 * (args.d_model or 256) if cfg.d_ff else 0,
            vocab_size=1024,
        )
    elif args.d_model or args.layers:
        cfg = cfg.with_overrides(
            d_model=args.d_model or cfg.d_model, num_layers=args.layers or cfg.num_layers
        )
    tcfg = TrainConfig(
        num_microbatches=args.microbatches,
        attn_impl=args.attn_impl,
        remat=True,
        pipeline_schedule=args.pipeline_schedule,
        pipeline_backward=args.pipeline_backward,
        kernels=args.kernels,
    )
    ocfg = AdamWConfig(
        learning_rate=args.lr, warmup_steps=args.warmup, total_steps=args.steps,
    )
    return cfg, tcfg, ocfg


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="olmo-1b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda unless 'cpu' is asked "
                    "for; without a card the default raises)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--attn-impl", default="dense",
                    choices=["dense", "chunked", "flash"],
                    help="flash runs the flash kernel's plain version: training "
                    "never runs the CUDA kernels")
    ap.add_argument("--pipeline-schedule", default="gpipe",
                    choices=["gpipe", "one_f_one_b", "interleaved"],
                    help="layer-pipeline tick schedule (the stash bound printed)")
    ap.add_argument("--pipeline-backward", default="autodiff",
                    choices=["autodiff", "planned"],
                    help="backward execution: autograd through the forward plan, "
                    "or the combined plan's B units (true 1F1B)")
    ap.add_argument("--kernels", choices=["plain", "auto"], default="plain",
                    help="kernel dispatch (repro_torch.kernels); training runs "
                    "the plain ops, and auto resolves to plain")
    ap.add_argument("--checkpoint-dir", default=str(DEFAULT_CHECKPOINT_DIR))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    cfg, tcfg, ocfg = build(args)
    if cfg.embeds_input or cfg.vision_tokens:
        raise SystemExit(
            f"{cfg.name} takes {'embeddings' if cfg.embeds_input else 'vision embeddings'}: "
            "the synthetic source makes tokens only"
        )
    layout = T.model_layout(cfg)
    print(f"arch={cfg.name} params={param_count(layout)/1e6:.1f}M device={args.device}")
    if tcfg.num_microbatches > 1:
        # The schedule's memory bound at a 4-stage split (this CLI
        # itself runs unpipelined): the combined plan's stash bound
        # against what autodiff keeps live.
        pcfg = tcfg.pipeline_config(num_stages=4)
        auto = dataclasses.replace(pcfg, backward="autodiff").peak_stash_items
        print(f"pipeline: schedule={tcfg.pipeline_schedule} "
              f"backward={tcfg.pipeline_backward} -> combined-plan stash "
              f"bound {pcfg.peak_stash_items}/{tcfg.num_microbatches} "
              f"microbatches per stage at a 4-stage split (autodiff "
              f"keeps {auto}/{tcfg.num_microbatches} live)")

    params = init_params(layout, seed=args.seed, device=args.device)
    opt_state = init_opt_state(params, ocfg)

    # data: step-keyed
    source = make_source(DataConfig(
        seq_len=args.seq_len, global_batch=args.global_batch,
        seed=args.seed, vocab_size=cfg.vocab_size,
    ))
    device = params["embed"]["embedding"].device

    def batch_fn(step):
        return {k: torch.from_numpy(v).to(device) for k, v in source.batch(step).items()}

    step_fn = make_train_step(cfg, tcfg, ocfg)

    ckpt = Checkpointer(args.checkpoint_dir)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        state, start_step = ckpt.restore({"params": params, "opt_state": opt_state})
        params, opt_state = state["params"], state["opt_state"]
        print(f"resumed from step {start_step}")

    loop = ResilientLoop(
        step_fn, ckpt,
        FaultConfig(checkpoint_every=args.checkpoint_every,
                    heartbeat_path=str(Path(args.checkpoint_dir) / "heartbeat")),
    )
    prev_sigterm = signal.getsignal(signal.SIGTERM)
    loop.install_signal_handlers()
    t0 = time.perf_counter()
    try:
        params, opt_state, step, history = loop.run(
            params, opt_state, batch_fn, args.steps, start_step=start_step
        )
    finally:
        # main() may be called in process: hand SIGTERM back to the caller
        signal.signal(signal.SIGTERM, prev_sigterm)
    wall = time.perf_counter() - t0
    for h in history[:: args.log_every]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.3f}  lr {h['learning_rate']:.2e}")
    if history:
        print(f"final loss {history[-1]['loss']:.4f}  "
              f"({wall/max(1,len(history)):.2f}s/step, "
              f"restarts={loop.stats['restarts']}, "
              f"stragglers={loop.stats['stragglers']})")
    return history


if __name__ == "__main__":
    main()
