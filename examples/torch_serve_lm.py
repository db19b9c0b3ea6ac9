"""End-to-end serving example for the PyTorch port: continuous batching
with chunked prefill on a reduced qwen3 config; prints throughput.

    PYTHONPATH=src python examples/torch_serve_lm.py               # on the card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

It runs the reference example's arguments through the port's serve CLI
(``repro_torch.launch.serve``); ``main(argv)`` returns the finished
requests.
"""
import argparse

from repro_torch.launch.serve import main as serve_main

ARGV = ["--arch", "qwen3-32b", "--smoke", "--requests", "12",
        "--max-batch", "4", "--max-new", "8", "--prompt-len", "20"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless 'cpu' is asked for)")
    args = ap.parse_args(argv)
    # the smoke model's 16-wide heads are narrower than the CUDA kernels
    # take (32 to 256): it runs the plain PyTorch ops on the card too
    return serve_main(ARGV + ["--device", args.device, "--kernels", "plain"])


if __name__ == "__main__":
    main()
