"""``FutureEvaluator(mesh=)`` for every chain the one-device loop runs,
and ``StreamEngine(mesh=)``, on four gloo ranks, against the port's Lazy
evaluator and the JAX package.

The test writes seeded inputs (the battery's arrays, the smoke OLMo's
fp32 parameters from the port's ``init_params`` at seed 0, the serving
prompts), then starts one JAX subprocess (four host devices through
``XLA_FLAGS``) and one spawned world of four gloo ranks
(``tests/_torch_ranks_world.py``, a ``file://`` store in ``tmp_path``,
one thread a rank) together, under one deadline: every process is
killed when it runs out, and the world's collectives time out after 60
s, so a rank that dies fails the test, never hangs it.

The JAX side runs the tests/test_multidevice.py battery (EQUIV, the
ragged M 5, the seven algebra programs, the two-source product zip,
feedback at lags 8, 4 and 3, const_state plain and under feedback, the
sieve at 600, the product and the fused multiply-add) under its mesh
``FutureEvaluator`` on ``(pod 4)`` for each schedule.  Where that
evaluator raises at ``_varying``'s ``pcast`` (JAX 0.9.0 in some
environments: ROADMAP C; it then fails every chain, so it is not tried
again) the JAX side records its ``LazyEvaluator``'s result, which the
reference's own battery holds bitwise equal to it, and says which it
recorded.  It also serves tests/test_serve_pipeline.py's workload (14 ragged
prompts from seed 7, budgets 1-7; at temperature 0.9 with seed 11 the
first 10, 5 new tokens) through the JAX sequential ``Engine`` and the
JAX ``StreamEngine(mesh=None)`` at 8 and at 4 microbatches.

Held here, for each program under gpipe, one_f_one_b and interleaved (2
virtual stages a rank), each a case of its own: on every rank the items
and the rank's own states bitwise the port's Lazy run (its rows of its
cells), the whole states gathered bitwise too, the entry points
(``run_sieve``, ``times``, ``times_into``) bitwise their Lazy runs; and
the values equal the JAX side's (integers exactly, floats at rtol = atol
= 1e-6, as tests/test_torch_future.py).  For each serving run, on every
rank: the tokens of the JAX ``Engine``, of the JAX ``StreamEngine`` and
of the port's Lazy ``StreamEngine``, each rank holding 2 of the 8 layer
groups' cache and writing it in place.  The errors: ``stages`` with ``mesh``, and autograd
through a ranked chain outside the training shape.  The serve CLI under
the group prints on rank 0 what one process prints.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch import pytree as P
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params
from test_torch_mesh import _run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT = 600  # the JAX side compiles 54 mesh programs where its mesh evaluator runs
NAMES = ("equiv", "equiv_ragged", "algebra_map", "algebra_zip_entry", "algebra_zip_mid",
         "algebra_concat", "algebra_mask", "algebra_two_seg", "algebra_mid_map", "poly_zip",
         "feedback_8_24", "feedback_4_16", "feedback_3_14", "const", "const_feedback",
         "sieve", "poly", "poly_fma")
SCHEDULES = ("gpipe", "one_f_one_b", "interleaved")
CASES = [f"{n}-{s}" for n in NAMES for s in SCHEDULES]
ENTRY = ("sieve", "poly", "poly_fma")
# engine run -> (its JAX StreamEngine's microbatches, temperature)
ENGINE_RUNS = {"gpipe": (8, 0.0), "interleaved": (4, 0.0), "gpipe_t09": (8, 0.9),
               "interleaved_t09": (4, 0.9)}
ERRORS = ("stages_and_mesh", "grad_mutable", "grad_const", "grad_feedback", "grad_two_sources",
          "grad_whole_chain", "local_interior_zip")

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.algorithms import polynomial as poly
from repro.algorithms import sieve
from repro.configs.base import DecodePipelineConfig
from repro.configs.registry import get_config, smoke_config
from repro.core import FutureEvaluator, LazyEvaluator, Stream
from repro.serve.engine import Engine, ServeConfig, StreamEngine

d = sys.argv[1]
inp = np.load(os.path.join(d, "inputs.npz"))
out, meta = {}, {"oracle": {}}

# The serving workload: the JAX Engine and StreamEngine(mesh=None)
params = {}
for key in inp.files:
    if key.startswith("params/"):
        node = params
        parts = key.split("/")[1:]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(inp[key])
sc = smoke_config(get_config("olmo-1b")).with_overrides(num_layers=8, dtype=jnp.float32)
prompts = [inp[f"prompt{i}"] for i in range(int(inp["num_prompts"]))]
budgets = [int(b) for b in inp["budgets"]]
def serve(eng, n):
    reqs = [eng.submit(p, b) for p, b in zip(prompts[:n], budgets[:n])]
    eng.run_until_drained()
    return [[int(t) for t in r.out_tokens] for r in reqs]
for temp in (0.0, 0.9):
    n = 14 if temp == 0 else 10
    scfg = ServeConfig(max_batch=8, max_len=64, prefill_chunk=4,
                       max_new_tokens=6 if temp == 0 else 5, temperature=temp,
                       seed=11 if temp else 0)
    meta[f"engine_{temp}"] = serve(Engine(params, sc, scfg), n)
    for m in (8, 4):
        pcfg = DecodePipelineConfig(num_cells=8, microbatches=m, round_steps=4,
                                    admit_per_round=4)
        meta[f"stream_{m}_{temp}"] = serve(StreamEngine(params, sc, scfg, pcfg), n)

# The battery under the mesh FutureEvaluator (the Lazy one where it raises)
t = {k: jnp.asarray(inp[k]) for k in inp.files
     if not k.startswith("params/") and not k.startswith("prompt")}
cell = lambda s, x: (s + 1, x * 1.001 + s)
cell2 = lambda w, x: (w, jnp.tanh(x * w))
fbcell = lambda s, x: (s + 1.0, jnp.tanh(x * 1.01) + s * 0.001)
fbemit = lambda x: x * 0.9 + 1.0
ccell = lambda c, s, x: (s + 1.0, jnp.tanh(x * c) + s * 0.01)
a7, b7, w8, w4a, w4b = t["a7"], t["b7"], t["w8"], t["w4a"], t["w4b"]
px = lambda cap: poly.fateman_poly(3, cap, 6)
z7 = poly.from_dict({(1, 2, 3): 7, (0, 0, 1): 5}, 8, 6)
def collect(mk):
    def run(ev):
        r = mk().collect(ev)
        return (r.items, r.states)
    return run
def fb(lag, n):
    return collect(lambda: Stream.feedback(t[f"fb{lag}"], n, fbemit).through(fbcell, w8))
PROGRAMS = {
    "equiv": collect(lambda: Stream.source(t["items6"]).through(cell, w8)),
    "equiv_ragged": collect(lambda: Stream.source(t["items5"]).through(cell, w8)),
    "algebra_map": collect(lambda: Stream.source(a7).map(lambda x: x * 2.0).through(cell, w8)
                           .map(lambda x: x + 1.0)),
    "algebra_zip_entry": collect(lambda: Stream.source(a7).zip(Stream.source(b7),
                                                               lambda x, y: x * y).through(cell, w8)),
    "algebra_zip_mid": collect(lambda: Stream.source(a7).through(cell, w4a)
                               .zip(Stream.source(b7), lambda f, s: f + s)
                               .through(cell2, w4b, mutable_state=False)),
    "algebra_concat": collect(lambda: Stream.source(a7[:3]).concat(Stream.source(a7[3:]))
                              .through(cell, w8)),
    "algebra_mask": collect(lambda: Stream.source(a7).mask(lambda v: v > 0.3)
                            .map(lambda d: d["value"] * d["valid"].astype(jnp.float32))
                            .through(cell, w8)),
    "algebra_two_seg": collect(lambda: Stream.source(a7).through(cell, w4a)
                               .through(cell2, w4b, mutable_state=False)),
    "algebra_mid_map": collect(lambda: Stream.source(a7).through(cell, w4a)
                               .map(lambda x: x * 0.5 + 0.1)
                               .through(cell2, w4b, mutable_state=False)),
    "poly_zip": collect(lambda: poly.times_stream(px(24), px(24), num_x_chunks=4,
                                                  terms_per_cell=3, acc_capacity=256)),
    "feedback_8_24": fb(8, 24), "feedback_4_16": fb(4, 16), "feedback_3_14": fb(3, 14),
    "const": collect(lambda: Stream.source(a7).through(ccell, w8, const_state=t["cst"])),
    "const_feedback": collect(lambda: Stream.feedback(t["fb4"], 16, fbemit).through(
        ccell, w8, const_state=t["cst"])),
    "sieve": lambda ev: sieve.run_sieve(600, block_size=64, primes_per_cell=2, num_cells=56,
                                        evaluator=ev),
    "poly": lambda ev: (lambda p: (p.keys, p.coeffs))(poly.times(
        px(40), px(40), evaluator=ev, num_x_chunks=4, terms_per_cell=5, acc_capacity=256)),
    "poly_fma": lambda ev: (lambda p: (p.keys, p.coeffs))(poly.times_into(
        px(24), px(24), z7, evaluator=ev, num_x_chunks=4, terms_per_cell=3,
        acc_capacity=256)),
}
mesh = compat.make_mesh((4,), ("pod",), axis_types=(compat.AxisType.Auto,))
lazy, mesh_runs = {}, True
for name, run in PROGRAMS.items():
    for sched, v in (("gpipe", 1), ("one_f_one_b", 1), ("interleaved", 2)):
        case = f"{name}-{sched}"
        value = None
        if mesh_runs:
            try:
                value, oracle = run(FutureEvaluator(mesh, "pod", schedule=sched,
                                                    interleave=v)), "mesh"
            except ValueError as e:  # the reference's _varying fault: it fails every chain
                if "pcast" not in str(e):
                    raise
                mesh_runs = False
        if value is None:
            if name not in lazy:
                lazy[name] = run(LazyEvaluator())
            value, oracle = lazy[name], "lazy"
        meta["oracle"][case] = oracle
        for i, leaf in enumerate(jax.tree.leaves(value)):
            out[f"{case}/{i}"] = np.asarray(leaf)
np.savez(os.path.join(d, "jax.npz"), **out)
with open(os.path.join(d, "jax.json"), "w") as f:
    json.dump(meta, f)
print("JAX_DONE")
"""


def _inputs(d: str) -> None:
    """The battery's arrays, the smoke OLMo's fp32 params and the
    serving prompts, in ``d/inputs.npz``."""
    arrays = {
        "a7": np.linspace(0, 1, 18, dtype=np.float32).reshape(6, 3),
        "b7": np.linspace(1, 2, 18, dtype=np.float32).reshape(6, 3),
        "w8": np.arange(8, dtype=np.float32),
        "w4a": np.arange(4, dtype=np.float32),
        "w4b": np.linspace(0.5, 1.5, 4, dtype=np.float32),
        "cst": np.linspace(1.0, 2.0, 8, dtype=np.float32),
        "items6": np.linspace(0, 1, 18, dtype=np.float32).reshape(6, 3),
        "items5": np.linspace(0, 1, 15, dtype=np.float32).reshape(5, 3),
    }
    for lag in (8, 4, 3):
        arrays[f"fb{lag}"] = np.linspace(0.0, 1.0, lag * 3, dtype=np.float32).reshape(lag, 3)
    cfg = smoke_config(get_config("olmo-1b")).with_overrides(num_layers=8, dtype=torch.float32)
    params = init_params(T.model_layout(cfg), seed=0, device="cpu")
    for path, leaf in P.flatten_with_paths(params):
        arrays["params/" + "/".join(path.strip("[]'").split("']['"))] = leaf.numpy()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(rng.integers(1, 9))) for _ in range(14)]
    arrays["budgets"] = rng.integers(1, 8, size=14)
    arrays["num_prompts"] = np.array(len(prompts))
    for i, p in enumerate(prompts):
        arrays[f"prompt{i}"] = p.astype(np.int32)
    np.savez(os.path.join(d, "inputs.npz"), **arrays)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ranks_world"))
    _inputs(d)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    world_cmd = os.path.join(ROOT, "tests", "_torch_ranks_world.py")
    results = _run([[sys.executable, "-c", JAX_SCRIPT, d]]
                   + [[sys.executable, world_cmd, str(r), str(WORLD), d] for r in range(WORLD)],
                   env, TIMEOUT, d, "proc")
    for name, (rc, err) in zip(["jax"] + [f"rank {r}" for r in range(WORLD)], results):
        assert rc == 0, f"{name}: {err}"
    reports = [json.load(open(os.path.join(d, f"report{r}.json"))) for r in range(WORLD)]
    jax_meta = json.load(open(os.path.join(d, "jax.json")))
    return (reports, dict(np.load(os.path.join(d, "ranks.npz"))),
            dict(np.load(os.path.join(d, "jax.npz"))), jax_meta)


@pytest.mark.parametrize("case", CASES)
def test_ranked_battery_bitwise_equals_lazy(world, case):
    reports = world[0]
    for rank, r in enumerate(reports):
        assert r[f"{case}/items"], (case, rank, "items")
        assert r[f"{case}/states"], (case, rank, "this rank's states")
        assert r[f"{case}/gathered"], (case, rank, "the whole states, gathered")
        if case.split("-")[0] in ENTRY:
            assert r[f"{case}/entry"], (case, rank, "the entry point")


@pytest.mark.parametrize("case", CASES)
def test_ranked_battery_matches_jax(world, case):
    _, ranks, jx, meta = world
    assert meta["oracle"][case] in ("mesh", "lazy")
    keys = sorted((k for k in jx if k.startswith(case + "/")), key=lambda k: int(k.split("/")[1]))
    assert keys and len(keys) == sum(k.startswith(case + "/") for k in ranks)
    for k in keys:
        a, b = ranks[k], jx[k]
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape, b.shape, a.dtype, b.dtype)
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_sieve_and_products_are_exact(world):
    from repro_torch.algorithms import polynomial as poly
    from repro_torch.algorithms import sieve

    _, ranks, _, _ = world
    ref = sieve.reference_primes(600)
    x40 = poly.fateman_poly(3, 40, 6, device="cpu")
    x24 = poly.fateman_poly(3, 24, 6, device="cpu")
    z7 = {(1, 2, 3): 7, (0, 0, 1): 5}
    fma = dict(poly.reference_product(poly.to_dict(x24), poly.to_dict(x24)))
    for k, v in z7.items():
        fma[k] = fma.get(k, 0) + v
    for s in SCHEDULES:
        primes, count = ranks[f"sieve-{s}/0"], ranks[f"sieve-{s}/1"]
        assert int(count) == len(ref) and np.array_equal(primes[primes > 0], ref)
        got = poly.Poly(torch.from_numpy(ranks[f"poly-{s}/0"]), torch.from_numpy(ranks[f"poly-{s}/1"]))
        assert poly.to_dict(got) == poly.reference_product(poly.to_dict(x40), poly.to_dict(x40))
        got = poly.Poly(torch.from_numpy(ranks[f"poly_fma-{s}/0"]),
                        torch.from_numpy(ranks[f"poly_fma-{s}/1"]))
        assert poly.to_dict(got) == {k: v for k, v in fma.items() if v}


@pytest.mark.parametrize("run", sorted(ENGINE_RUNS))
def test_ranked_stream_engine_matches_the_engines(world, run):
    reports, _, _, meta = world
    m, temp = ENGINE_RUNS[run]
    seq, stream = meta[f"engine_{temp}"], meta[f"stream_{m}_{temp}"]
    assert seq == stream  # the reference's own claim
    lazy = [r[f"lazy_{run}"] for r in reports if f"lazy_{run}" in r]
    assert len(lazy) == 1 and lazy[0] == stream
    for rank, r in enumerate(reports):
        assert r[f"engine_{run}"] == stream, (run, rank)
        assert r[f"engine_{run}_ranked"], (run, rank)
        assert r[f"engine_{run}_cache_groups"] == 2, (run, rank)  # 8 layer groups, 4 ranks
        assert r[f"engine_{run}_in_place"], (run, rank)


@pytest.mark.parametrize("error", ERRORS)
def test_ranked_errors(world, error):
    for rank, r in enumerate(world[0]):
        assert r[f"error_{error}"], (error, rank)


def test_serve_cli_across_ranks_prints_what_one_process_prints(world):
    reports = world[0]
    ranked, alone = reports[0]["cli_ranked_stdout"], reports[0]["cli_one_process_stdout"]
    # every line but the timing line ([mode] ... tok/s)
    keep = [line for line in ranked.splitlines() if not line.startswith("[")]
    assert keep == [line for line in alone.splitlines() if not line.startswith("[")]
    assert len(keep) >= 5 and "ranks" in ranked and "ranks" not in alone
    assert all(r["cli_ranked_stdout"] == "" for r in reports[1:])
    assert all(r["cli_ranked_tokens"] == reports[0]["cli_one_process_tokens"] for r in reports)
