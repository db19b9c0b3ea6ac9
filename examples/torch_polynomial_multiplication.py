"""Paper §6 in the PyTorch port: sparse polynomial multiplication as a stream computation.

Reproduces the paper's experiment shape: ``stream`` (small coefficients,
4 limbs) vs ``stream_big`` (coefficients x 100000000001, 12 limbs) under
the Lazy and Future evaluators, plus the data-parallel ``list`` control
(``times_dense``); each product is checked against the exact one.  The
Future evaluator pipelines the cells over ``--stages`` stages, each a
CUDA stream of the card (2 by default: the paper's hyperthreaded Atom;
on the CPU the stages run in tick order).

Run (on the card unless ``--device cpu`` is given):
    PYTHONPATH=src python examples/torch_polynomial_multiplication.py --power 6
    PYTHONPATH=src python examples/torch_polynomial_multiplication.py --power 2 --device cpu

``main(argv)`` returns each variant's product as a dict of terms.
"""
import argparse
import time

import torch

from repro_torch.algorithms import polynomial as poly
from repro_torch.core import FutureEvaluator


def timed(fn, *args, device, repeats=1, **kwargs):
    out = fn(*args, **kwargs)  # warm up: library handles, first launches
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) / repeats


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--power", type=int, default=6, help="k in (1+x+y+z)^k")
    ap.add_argument("--terms-per-cell", type=int, default=8)
    ap.add_argument("--x-chunks", type=int, default=4)
    ap.add_argument("--stages", type=int, default=2, help="Future evaluator stages")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless 'cpu' is asked for)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")

    n_terms = (args.power + 3) * (args.power + 2) * (args.power + 1) // 6
    # capacity must be divisible by terms_per_cell x stages (cells) and
    # by x_chunks (items).
    quantum = args.terms_per_cell * max(args.stages, args.x_chunks)
    cap = -(-n_terms // quantum) * quantum
    p2 = args.power * 2
    acc_cap = 1 << ((p2 + 3) * (p2 + 2) * (p2 + 1) // 6 - 1).bit_length()
    print(f"(1+x+y+z)^{args.power}: {n_terms} terms (cap {cap}) -> product capacity {acc_cap}")

    kw = dict(num_x_chunks=args.x_chunks, terms_per_cell=args.terms_per_cell,
              acc_capacity=acc_cap)
    products = {}
    for tag, limbs, big in (("stream", 4, 1), ("stream_big", 12, 100000000001)):
        x = poly.fateman_poly(args.power, cap, limbs, big_factor=big, device=device)
        y = poly.fateman_poly(args.power, cap, limbs, big_factor=big, device=device)
        ref = poly.reference_product(poly.to_dict(x), poly.to_dict(y))

        out, seq = timed(poly.times, x, y, device=device, **kw)
        if poly.to_dict(out) != ref:
            raise SystemExit(f"{tag}: stream/lazy result mismatch")
        fut = FutureEvaluator(args.stages, device=device)
        outp, par = timed(poly.times, x, y, device=device, evaluator=fut, **kw)
        if poly.to_dict(outp) != ref:
            raise SystemExit(f"{tag}: stream/future result mismatch")
        outd, dense = timed(poly.times_dense, x, y, device=device, capacity=acc_cap)
        if poly.to_dict(outd) != ref:
            raise SystemExit(f"{tag}: list result mismatch")
        products[tag] = {"lazy": poly.to_dict(out), "future": poly.to_dict(outp),
                         "list": poly.to_dict(outd)}

        print(
            f"{tag:12s} seq(Lazy) {seq*1e3:8.1f} ms   "
            f"par(Future,{args.stages} stages) {par*1e3:8.1f} ms   "
            f"list(dense) {dense*1e3:8.1f} ms"
        )
    return products


if __name__ == "__main__":
    main()
