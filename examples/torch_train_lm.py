"""End-to-end LM training example for the PyTorch port: trains a
reduced-config model on the synthetic corpus with checkpointing and fault
tolerance, and checks that the loss decreases.

Run (a ~25M-param model; on the card unless ``--device cpu`` is given):
    PYTHONPATH=src python examples/torch_train_lm.py
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20 \
        --layers 2 --seq-len 64      # the smallest run: a few seconds

A larger (~100M) run, as the reference's example offers:
    PYTHONPATH=src python examples/torch_train_lm.py --big

It runs the reference example's arguments through the port's train CLI
(``repro_torch.launch.train``); ``main(argv)`` returns the history.
"""
import argparse

from repro_torch.launch.train import DEFAULT_CHECKPOINT_DIR
from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--big", action="store_true", help="~100M params")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--pipeline-schedule", default="one_f_one_b",
                    choices=["gpipe", "one_f_one_b", "interleaved"])
    ap.add_argument("--pipeline-backward", default="planned",
                    choices=["autodiff", "planned"],
                    help="the planned 1F1B backward (B units on the stage streams) "
                         "or autograd through the forward plan")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless 'cpu' is asked for)")
    ap.add_argument("--checkpoint-dir", default=str(DEFAULT_CHECKPOINT_DIR))
    ap.add_argument("--layers", type=int, default=None,
                    help="override the layer count (8, or 16 with --big)")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="override the sequence length (256, or 512 with --big)")
    args = ap.parse_args(argv)

    if args.big:
        argv = [
            "--arch", "olmo-1b", "--smoke", "--d-model", "640",
            "--layers", str(args.layers or 16),
            "--steps", str(args.steps or 300), "--global-batch", "8",
            "--seq-len", str(args.seq_len or 512), "--microbatches", "2",
        ]
    else:
        argv = [
            "--arch", "olmo-1b", "--smoke", "--d-model", "320",
            "--layers", str(args.layers or 8),
            "--steps", str(args.steps or 200), "--global-batch", "8",
            "--seq-len", str(args.seq_len or 256), "--microbatches", "2",
        ]
    argv += [
        "--pipeline-schedule", args.pipeline_schedule,
        "--pipeline-backward", args.pipeline_backward,
        "--device", args.device, "--checkpoint-dir", args.checkpoint_dir,
    ]
    history = train_main(argv)
    first = sum(h["loss"] for h in history[:10]) / 10
    last = sum(h["loss"] for h in history[-10:]) / 10
    print(f"mean loss first-10 {first:.4f} -> last-10 {last:.4f}")
    if not last < first:
        raise SystemExit("loss did not decrease")
    print("OK: loss decreased")
    return history


if __name__ == "__main__":
    main()
