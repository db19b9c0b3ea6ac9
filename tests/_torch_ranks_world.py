"""One rank of tests/test_torch_future_ranks.py's 4-rank gloo world.

``python tests/_torch_ranks_world.py RANK WORLD DIR``: joins the world
through the file store ``DIR/store`` (every collective times out after
``GROUP_TIMEOUT``), reads the seeded inputs ``DIR/inputs.npz`` (the
battery's arrays and the smoke OLMo's parameters), runs the port's side
and writes ``DIR/report<RANK>.json``; rank 0 also writes what the JAX
side is compared with to ``DIR/ranks.npz``.  It imports no JAX.

* The tests/test_multidevice.py battery under ``FutureEvaluator(mesh=)``
  on ``(pod 4)``, gpipe, one_f_one_b and interleaved (2 virtual stages a
  rank): every program's items, bitwise the port's ``LazyEvaluator``'s,
  and this rank's final states, bitwise Lazy's rows of its cells (the
  cells ``(v*4 + rank) * c + i``); the sieve and the products also
  through their entry points (``run_sieve``, ``times``,
  ``times_into``), bitwise their Lazy runs.  Rank 0 keeps the items and
  the whole states (:meth:`FutureEvaluator.gather_states`).
* ``StreamEngine(mesh=)`` on ``(pod 4)`` at fp32, gpipe (8 cells, 8
  microbatches) and interleaved (2 virtual stages, 8 cells, 4
  microbatches), greedy and at temperature 0.9 (seed 11): the tokens,
  this rank's cache groups, whether its cache shards were written in
  place, and (rank r for run r) the port's Lazy StreamEngine's tokens of
  the same run.
* The errors: ``stages`` with ``mesh``; autograd through a ranked chain
  of mutable state, of ``const_state``, of feedback, of two sources, of
  the whole chain; an interior zip on a ``local_cells`` chain.
* The serve CLI under the group (``--device cpu --engine stream
  --devices 4``): what each rank prints; then, the group gone, rank 0
  runs it again as one process.
"""
import contextlib
import datetime
import io
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch.distributed as dist  # noqa: E402

from repro_torch import pytree as P  # noqa: E402
from repro_torch.algorithms import polynomial as poly  # noqa: E402
from repro_torch.algorithms import sieve  # noqa: E402
from repro_torch.configs.base import DecodePipelineConfig  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.core import FutureEvaluator, LazyEvaluator, Stream  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeConfig, StreamEngine  # noqa: E402

GROUP_TIMEOUT = datetime.timedelta(seconds=60)
ZOO = (("gpipe", 1), ("one_f_one_b", 1), ("interleaved", 2))
# (name, schedule, interleave, cells, microbatches, temperature) of the engine runs
ENGINE_RUNS = (("gpipe", "gpipe", 1, 8, 8, 0.0), ("interleaved", "interleaved", 2, 8, 4, 0.0),
               ("gpipe_t09", "gpipe", 1, 8, 8, 0.9), ("interleaved_t09", "interleaved", 2, 8, 4, 0.9))
CLI = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--num-layers", "8", "--engine",
       "stream", "--devices", "4", "--cells", "8", "--microbatches", "4", "--max-batch", "8",
       "--requests", "10", "--max-new", "6", "--max-len", "64", "--prompt-len", "13",
       "--prefill-chunk", "4", "--round-steps", "4"]


def _cell(state, item):
    return state + 1, item * 1.001 + state


def _cell2(w, x):
    return w, torch.tanh(x * w)


def _fbcell(s, x):
    return s + 1.0, torch.tanh(x * 1.01) + s * 0.001


def _fbemit(x):
    return x * 0.9 + 1.0


def _ccell(c, s, x):
    return s + 1.0, torch.tanh(x * c) + s * 0.01


def programs(inp) -> dict:
    """name -> (stream(), entry(evaluator) or None): the battery; fresh
    states each call (a run may update them in place)."""
    t = {k: torch.from_numpy(inp[k]) for k in inp.files if not k.startswith("params/")}
    a7, b7, w4a, w4b = t["a7"], t["b7"], t["w4a"], t["w4b"]

    def w8():
        return t["w8"].clone()

    def fb(lag, n):
        init = t[f"fb{lag}"]
        return lambda: Stream.feedback(init, n, _fbemit).through(_fbcell, w8())

    def px(cap):
        return poly.fateman_poly(3, cap, 6, device="cpu")

    z7 = poly.from_dict({(1, 2, 3): 7, (0, 0, 1): 5}, 8, 6, device="cpu")

    def sieve_run(ev):
        primes, count = sieve.run_sieve(600, block_size=64, primes_per_cell=2, num_cells=56,
                                        evaluator=ev, device="cpu")
        return primes, count.to(torch.int32)  # a sum: int64 in PyTorch, int32 in JAX

    def prod(p):
        return p.keys, p.coeffs

    return {
        "equiv": (lambda: Stream.source(t["items6"]).through(_cell, w8()), None),
        "equiv_ragged": (lambda: Stream.source(t["items5"]).through(_cell, w8()), None),
        "algebra_map": (lambda: Stream.source(a7).map(lambda x: x * 2.0).through(_cell, w8())
                        .map(lambda x: x + 1.0), None),
        "algebra_zip_entry": (lambda: Stream.source(a7).zip(Stream.source(b7), lambda x, y: x * y)
                              .through(_cell, w8()), None),
        "algebra_zip_mid": (lambda: Stream.source(a7).through(_cell, w4a.clone())
                            .zip(Stream.source(b7), lambda f, s: f + s)
                            .through(_cell2, w4b.clone(), mutable_state=False), None),
        "algebra_concat": (lambda: Stream.source(a7[:3]).concat(Stream.source(a7[3:]))
                           .through(_cell, w8()), None),
        "algebra_mask": (lambda: Stream.source(a7).mask(lambda v: v > 0.3)
                         .map(lambda d: d["value"] * d["valid"].to(torch.float32))
                         .through(_cell, w8()), None),
        "algebra_two_seg": (lambda: Stream.source(a7).through(_cell, w4a.clone())
                            .through(_cell2, w4b.clone(), mutable_state=False), None),
        "algebra_mid_map": (lambda: Stream.source(a7).through(_cell, w4a.clone())
                            .map(lambda x: x * 0.5 + 0.1)
                            .through(_cell2, w4b.clone(), mutable_state=False), None),
        "poly_zip": (lambda: poly.times_stream(px(24), px(24), num_x_chunks=4, terms_per_cell=3,
                                               acc_capacity=256), None),
        "feedback_8_24": (fb(8, 24), None),
        "feedback_4_16": (fb(4, 16), None),
        "feedback_3_14": (fb(3, 14), None),
        "const": (lambda: Stream.source(a7).through(_ccell, w8(), const_state=t["cst"]), None),
        "const_feedback": (lambda: Stream.feedback(t["fb4"], 16, _fbemit).through(
            _ccell, w8(), const_state=t["cst"]), None),
        "sieve": (lambda: sieve.sieve_stream(600, block_size=64, primes_per_cell=2,
                                             num_cells=56, device="cpu"), sieve_run),
        "poly": (lambda: poly.times_stream(px(40), px(40), num_x_chunks=4, terms_per_cell=5,
                                           acc_capacity=256),
                 lambda ev: prod(poly.times(px(40), px(40), evaluator=ev, num_x_chunks=4,
                                            terms_per_cell=5, acc_capacity=256))),
        "poly_fma": (lambda: poly.times_stream(px(24), px(24), num_x_chunks=4, terms_per_cell=3,
                                               acc_capacity=256, into=z7),
                     lambda ev: prod(poly.times_into(px(24), px(24), z7, evaluator=ev,
                                                     num_x_chunks=4, terms_per_cell=3,
                                                     acc_capacity=256))),
    }


def bitwise(a, b) -> bool:
    la, lb = P.leaves(a), P.leaves(b)
    return P.structure(a) == P.structure(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def my_rows(chain_states, rank: int, v_: int, d_: int = 4) -> tuple:
    """Lazy's whole states cut to this rank's cells, per segment: a
    segment's rows at the chain cells ``(v*D + rank) * c + i``."""
    sizes = [P.leaves(s)[0].shape[0] for s in chain_states]
    c = sum(sizes) // (d_ * v_)
    cells = [(v * d_ + rank) * c + i for v in range(v_) for i in range(c)]
    out, off = [], 0
    for n, s in zip(sizes, chain_states):
        idx = [g - off for g in cells if off <= g < off + n]
        out.append(P.tree_map(lambda x, _i=idx: x[_i], s))
        off += n
    return tuple(out)


def battery(mesh, rank, inp, report, keep) -> None:
    for name, (stream, entry) in programs(inp).items():
        lazy = stream().collect(LazyEvaluator())
        lazy_entry = entry(LazyEvaluator()) if entry else None
        for schedule, v in ZOO:
            case = f"{name}-{schedule}"
            ev = FutureEvaluator(mesh=mesh, schedule=schedule, interleave=v)
            got = stream().collect(ev)
            report[f"{case}/items"] = bitwise(got.items, lazy.items)
            report[f"{case}/states"] = bitwise(got.states, my_rows(lazy.states, rank, v))
            whole = ev.gather_states(got.states)
            report[f"{case}/gathered"] = bitwise(whole, lazy.states)
            value = (got.items, whole)
            if entry:
                value = entry(ev)
                report[f"{case}/entry"] = bitwise(value, lazy_entry)
            if rank == 0:
                for i, leaf in enumerate(P.leaves(value)):
                    keep[f"{case}/{i}"] = leaf.numpy()


def serve(eng, prompts, budgets) -> list:
    reqs = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    eng.run_until_drained()
    assert all(r.done and r.status == "ok" for r in reqs)
    return [r.out_tokens for r in reqs]


def engines(mesh, rank, inp, report) -> None:
    cfg = smoke_config(get_config("olmo-1b")).with_overrides(
        num_layers=8, dtype=torch.float32, kernels="plain")
    params = params_from_numpy(unflatten(inp, "params"), device="cpu")
    prompts = [inp[f"prompt{i}"] for i in range(int(inp["num_prompts"]))]
    budgets = [int(b) for b in inp["budgets"]]
    for i, (name, schedule, v, cells, m, temp) in enumerate(ENGINE_RUNS):
        n = 14 if temp == 0 else 10
        scfg = ServeConfig(max_batch=8, max_len=64, prefill_chunk=4,
                           max_new_tokens=6 if temp == 0 else 5, temperature=temp,
                           seed=11 if temp else 0)
        pcfg = DecodePipelineConfig(num_cells=cells, microbatches=m, schedule=schedule,
                                    interleave=v, round_steps=4, admit_per_round=4)
        eng = StreamEngine(params, cfg, scfg, pcfg, mesh=mesh, device="cpu")
        ptrs = [t.data_ptr() for t in P.leaves(eng.cell_states)]
        report[f"engine_{name}"] = serve(eng, prompts[:n], budgets[:n])
        # the rounds wrote the cache shards in place: no round replaced one
        report[f"engine_{name}_in_place"] = ptrs == [t.data_ptr()
                                                    for t in P.leaves(eng.cell_states)]
        report[f"engine_{name}_ranked"] = (eng.evaluator.mesh is mesh
                                           and eng.evaluator.local_cells)
        report[f"engine_{name}_cache_groups"] = int(P.leaves(eng.cache)[0].shape[0])
        if i == rank:  # the port's Lazy StreamEngine, a run a rank
            lazy = StreamEngine(params, cfg, scfg, pcfg, device="cpu")
            report[f"lazy_{name}"] = serve(lazy, prompts[:n], budgets[:n])


def raises(fn, match: str) -> bool:
    try:
        fn()
    except ValueError as e:
        return match in str(e)
    return False


def errors(mesh, inp, report) -> None:
    t = {k: torch.from_numpy(inp[k]) for k in ("a7", "b7", "w8", "cst", "fb4")}
    ev = FutureEvaluator(mesh=mesh)
    local = FutureEvaluator(mesh=mesh, local_cells=True)
    scope = "autograd through a FutureEvaluator across ranks"

    def grad(x):
        return x.clone().requires_grad_(True)

    def collect(stream, evaluator=ev):
        return lambda: stream().collect(evaluator)

    cfg = smoke_config(get_config("olmo-1b")).with_overrides(num_layers=8, kernels="plain")
    params = params_from_numpy(unflatten(inp, "params"), device="cpu")
    report["error_stages_and_mesh"] = raises(
        lambda: StreamEngine(params, cfg, ServeConfig(max_batch=8, max_len=64),
                             DecodePipelineConfig(num_cells=8), stages=4, mesh=mesh,
                             device="cpu"), "not both")
    report["error_grad_mutable"] = raises(collect(
        lambda: Stream.source(t["a7"]).through(_cell, grad(t["w8"]))), scope)
    report["error_grad_const"] = raises(collect(
        lambda: Stream.source(t["a7"]).through(_ccell, t["w8"].clone(), mutable_state=False,
                                               const_state=grad(t["cst"]))), scope)
    report["error_grad_feedback"] = raises(collect(
        lambda: Stream.feedback(grad(t["fb4"]), 16, _fbemit).through(
            _cell2, t["w8"].clone(), mutable_state=False)), scope)
    report["error_grad_two_sources"] = raises(collect(
        lambda: Stream.source(t["a7"]).zip(Stream.source(grad(t["b7"])), lambda x, y: x * y)
        .through(_cell2, t["w8"].clone(), mutable_state=False)), scope)
    report["error_grad_whole_chain"] = raises(collect(
        lambda: Stream.source(t["a7"]).through(_cell2, grad(t["w8"]), mutable_state=False)),
        scope)
    report["error_local_interior_zip"] = raises(collect(
        lambda: Stream.source(t["a7"]).through(_cell, t["w8"][:2].clone())
        .zip(Stream.source(t["b7"]), lambda f, s: f + s).through(_cell, t["w8"][:2].clone()),
        local), "takes zips at its entry")


def cli(rank, report) -> None:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        done = serve_cli.main(CLI)
    report["cli_ranked_stdout"] = out.getvalue()
    report["cli_ranked_tokens"] = [r.out_tokens for r in done]


def unflatten(flat, prefix: str) -> dict:
    """A nested dict from the ``prefix/a/b`` keys of an npz file."""
    tree: dict = {}
    for key in flat.files:
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return tree


def main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    inp = np.load(os.path.join(d, "inputs.npz"))
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'store')}",
                            rank=rank, world_size=world, timeout=GROUP_TIMEOUT)
    mesh = make_mesh((world,), ("pod",))
    report, keep = {}, {}
    battery(mesh, rank, inp, report, keep)
    engines(mesh, rank, inp, report)
    errors(mesh, inp, report)
    cli(rank, report)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:  # the same CLI run as one process: 4 logical stages
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            done = serve_cli.main(CLI)
        report["cli_one_process_stdout"] = out.getvalue()
        report["cli_one_process_tokens"] = [r.out_tokens for r in done]
        np.savez(os.path.join(d, "ranks.npz"), **keep)
    with open(os.path.join(d, f"report{rank}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
