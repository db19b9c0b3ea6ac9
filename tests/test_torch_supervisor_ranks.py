"""``ServeSupervisor`` over ``StreamEngine(mesh=)``, and the zoo's other
families served across ranks, on four gloo ranks against the port's
Lazy ``StreamEngine`` and the JAX package.

The test writes seeded inputs (the JAX ``init_params`` weights at
``PRNGKey(0)`` of each model, carried across as their fp32 images; the
prompts; the vision embeddings), starts one spawned world of four gloo
ranks (``tests/_torch_supervisor_world.py``, a ``file://`` store in
``tmp_path``, one thread a rank) and, while it runs, computes the JAX
side in this process.  Every rank is killed when the world's deadline
runs out, and the world's collectives time out after 60 s, so a rank
that dies or hangs fails the test, never hangs it.

The chaos battery is tests/test_serve_resilience.py's
``TestChaosPipelined`` (the smoke OLMo of 8 layers in bf16, its
``ServeConfig``, prompts and budgets; gpipe at 8 cells and 8
microbatches, interleaved at 2 virtual stages a rank, 8 cells and 4
microbatches): ``raise`` at every round, ``nan@1``, ``sigterm@0`` and
``wedge@1`` under a deadline, and the faults on one rank only.  Every
run, on every rank, loses no request and gives the JAX sequential
``Engine``'s tokens bitwise (the JAX side compiled with XLA's excess
precision off, so that bf16 rounds where PyTorch rounds), and its
``stats`` and ``events`` are equal on every rank.  A budget that runs
out raises on every rank with the same ``requests_lost``.

The families (fp32, 8 cells, 4 microbatches, gpipe and interleaved):
mamba2 (SSD and conv state in the cells' state), jamba (Mamba, MoE and
attention blocks in one period) and llama-3.2-vision (the gates set, one
request given vision embeddings at its first prefill chunk: its vision
K/V rides the cache shards).  Held: the tokens on every rank bitwise the
port's Lazy ``StreamEngine``'s, and each rank's final cache bitwise the
Lazy cache's rows of its own cells; and the tokens equal to the JAX
``StreamEngine(mesh=None)``'s -- exactly, at fp32 -- for every request of
jamba (all prompts a multiple of ``prefill_chunk``) and llama-vision, and
for mamba2's requests whose prompt is a multiple of ``prefill_chunk``
(the JAX engine pads a ragged SSM tail into the state: ROADMAP C).
"""
import ast
import json
import os
import subprocess
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DecodePipelineConfig as JaxPipelineConfig
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.models.params import init_params as jax_init_params
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import StreamEngine as JaxStreamEngine
from repro_torch import pytree as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_supervisor_world as W  # noqa: E402

WORLD = 4
TIMEOUT = 300
EXACT = {"xla_allow_excess_precision": False}
SCHEDULES = [name for name, *_ in W.PIPELINES]
CHAOS = ["fault_free", "raise_every_round", "nan@1", "sigterm@0", "wedge@1"] + list(W.TARGETED)
SSM_CHUNK = 8  # prefill_chunk of the families


def _jax_params(arch, layers, dtype, gates=False):
    cfg = jax_smoke_config(jax_get_config(arch)).with_overrides(num_layers=layers, dtype=dtype)
    params = jax_init_params(jax.random.PRNGKey(0), JT.model_layout(cfg))
    if gates:  # tests/test_torch_cross_attn.py's build(gates=True)
        rng = np.random.default_rng(1)
        for blk in params["blocks"].values():
            if "xattn_gate" in blk:
                g = blk["xattn_gate"]["gate"]
                blk["xattn_gate"]["gate"] = jnp.asarray(rng.uniform(0.5, 1.5, g.shape), g.dtype)
    return cfg, params


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return ([rng.integers(1, 512, size=n).astype(np.int32) for n in lens],
            [int(b) for b in rng.integers(2, 7, size=len(lens))])


WORKLOADS = {"ragged": _prompts([8, 5, 16, 13, 24, 8, 3, 16], 3),
             "aligned": _prompts([8, 16, 24, 8, 16, 8, 24, 16], 4)}


def _chaos_workload(vocab):
    """The JAX battery's prompts and budgets."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, vocab, size=int(rng.integers(1, 9))) for _ in range(10)]
    return prompts, [int(b) for b in rng.integers(1, 7, size=10)]


def _inputs(d):
    """Write ``d/inputs.npz``; return what the JAX side serves."""
    arrays, models = {}, {}

    def put(prefix, params):
        for path, leaf in P.flatten_with_paths(jax.tree.map(np.asarray, params)):
            arrays[f"{prefix}/" + "/".join(path.strip("[]'").split("']['"))] = (
                leaf.astype(np.float32))

    def put_prompts(name, prompts, budgets):
        arrays[f"{name}/n"] = np.array(len(prompts))
        arrays[f"{name}/budgets"] = np.array(budgets)
        for i, p in enumerate(prompts):
            arrays[f"{name}/prompt{i}"] = np.asarray(p, np.int32)

    cfg, params = _jax_params("olmo-1b", 8, jnp.bfloat16)
    put("olmo", params)
    models["olmo"] = (cfg, params)
    put_prompts("chaos", *_chaos_workload(cfg.vocab_size))
    for model, (arch, layers, _) in W.FAMILIES.items():
        models[model] = _jax_params(arch, layers, jnp.float32, gates=model == "vision")
        put(model, models[model][1])
    for name, (prompts, budgets) in WORKLOADS.items():
        put_prompts(name, prompts, budgets)
    vcfg = models["vision"][0]
    arrays["vision"] = np.random.default_rng(5).normal(
        size=(1, vcfg.vision_tokens, vcfg.d_model)).astype(np.float32)
    np.savez(os.path.join(d, "inputs.npz"), **arrays)
    return models, arrays["vision"]


def _jax_serve(eng, prompts, budgets):
    reqs = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    eng.run_until_drained()
    return [[int(t) for t in r.out_tokens] for r in reqs]


def _jax_side(models, vision):
    """The JAX sequential Engine's tokens of the chaos battery (bf16,
    excess precision off) and the JAX StreamEngine(mesh=None)'s of each
    family."""
    cfg, params = models["olmo"]
    eng = JaxEngine(params, cfg, JaxServeConfig(max_batch=8, max_len=64, prefill_chunk=4,
                                                max_new_tokens=6))
    eng._prefill = jax.jit(partial(JT.prefill_step, cfg=cfg, attn_impl="dense"),
                           compiler_options=EXACT)
    eng._decode = jax.jit(partial(JT.decode_step, cfg=cfg, attn_impl="dense"),
                          compiler_options=EXACT)
    out = {"golden": _jax_serve(eng, *_chaos_workload(cfg.vocab_size))}
    for model, (_, _, workload) in W.FAMILIES.items():
        cfg, params = models[model]
        eng = JaxStreamEngine(params, cfg, JaxServeConfig(**W.FAMILY_SCFG),
                              JaxPipelineConfig(**W.FAMILY_PIPE))
        if model == "vision":
            W.with_image(eng, W.IMAGE_UID, jnp.asarray(vision))
        out[model] = _jax_serve(eng, *WORKLOADS[workload])
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("supervisor_world"))
    models, vision = _inputs(d)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    logs = [open(os.path.join(d, f"rank{r}.log"), "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, W.__file__, str(r), str(WORLD), d], env=env,
                              cwd=ROOT, stdin=subprocess.DEVNULL, stdout=log,
                              stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + TIMEOUT
    try:
        jx = _jax_side(models, vision)
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}: " + open(os.path.join(d, f"rank{r}.log")).read()[-4000:]
    reports = [json.load(open(os.path.join(d, f"report{r}.json"))) for r in range(WORLD)]
    return reports, jx, d


def _runs(reports, schedule, case):
    """Each rank's run(s) of ``case``: every ``raise@k`` for
    ``raise_every_round``."""
    if case != "raise_every_round":
        return [[r[f"{schedule}/{case}"]] for r in reports]
    rounds = reports[0][f"{schedule}/fault_free"]["stats"]["rounds"]
    return [[r[f"{schedule}/raise@{k}"] for k in range(rounds)] for r in reports]


@pytest.mark.parametrize("case", CHAOS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_chaos_across_ranks_zero_loss_bitwise(world, schedule, case):
    reports, jx, _ = world
    per_rank = _runs(reports, schedule, case)
    assert len(per_rank[0]) >= (2 if case == "raise_every_round" else 1)
    for rank, runs in enumerate(per_rank):
        for run in runs:
            assert run["ok"] and run["raised"] is None, (rank, run)
            assert run["stats"]["requests_lost"] == 0, (rank, run["stats"])
            assert run["tokens"] == jx["golden"], (rank, case)
            if case.startswith("sigterm"):
                assert run["draining"] and {"event": "drained"} in run["events"], (rank, run)
            elif case != "fault_free":
                assert run["stats"]["restarts"] >= 1, (rank, run["stats"])
    # every decision was agreed: the same stats, events and round index on every rank
    for runs in per_rank[1:]:
        for a, b in zip(runs, per_rank[0]):
            assert a["stats"] == b["stats"] and a["events"] == b["events"]
            assert a["round_idx"] == b["round_idx"] == b["stats"]["rounds"]


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_fault_on_one_rank_is_replayed_on_every_rank(world, schedule):
    """The event names the rank that faulted and its kind; the other
    ranks replayed the round with it."""
    reports = world[0]
    for case, kind in (("raise_rank1", "rank 1 exception: InjectedFault"),
                       ("nan_rank2", "rank 2 numerics: NumericsFault"),
                       ("wedge_rank3", "rank 3 watchdog: WatchdogTimeout")):
        run = reports[0][f"{schedule}/{case}"]
        faults = [e for e in run["events"] if e["event"] == "round_fault"]
        assert faults and kind in faults[0]["error"], (case, faults)
        assert all(r[f"{schedule}/{case}"]["stats"]["restarts"] == run["stats"]["restarts"]
                   for r in reports)
    assert run["stats"]["restarts"] >= 1
    drain = reports[3][f"{schedule}/sigterm_rank0"]["events"]
    assert drain[0] == {"event": "drain_requested"} and drain[-1] == {"event": "drained"}


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_spent_budget_raises_on_every_rank(world, schedule):
    """Rank 1 raises at every attempt of round 1 with one restart
    allowed: rank 1 raises its own fault, every other rank a RoundFault
    naming it, each with the same requests lost."""
    reports = world[0]
    runs = [r[f"{schedule}/budget"] for r in reports]
    assert runs[1]["raised"][0] == "InjectedFault"
    for rank, run in enumerate(runs):
        if rank != 1:
            assert run["raised"][0] == "RoundFault" and "rank 1 exception" in run["raised"][1]
        assert run["stats"] == runs[0]["stats"] and run["events"] == runs[0]["events"]
    stats, gave_up = runs[0]["stats"], runs[0]["events"][-1]
    assert stats["faults"] == 2 and stats["restarts"] == 1
    assert gave_up["event"] == "gave_up" and stats["requests_lost"] == len(gave_up["requests_lost"]) > 0


def test_each_rank_keeps_its_own_shards_and_heartbeat(world):
    reports, _, d = world
    for rank, r in enumerate(reports):
        for schedule in SCHEDULES:
            assert r[f"{schedule}/cache_groups"] == 2  # 8 layer groups over 4 ranks
            assert os.path.exists(os.path.join(d, f"hb-{schedule}.rank{rank}"))


def _lazy(reports, model):
    got = [r[f"{model}/lazy"] for r in reports if f"{model}/lazy" in r]
    assert len(got) == 1
    return got[0]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("model", sorted(W.FAMILIES))
def test_family_across_ranks_bitwise_equals_lazy(world, model, schedule):
    reports, _, d = world
    lazy = _lazy(reports, model)
    whole = torch.load(os.path.join(d, f"cache-{model}-lazy.pt"))
    v = dict((n, v) for n, _, v, _, _ in W.PIPELINES)[schedule]
    cells = W.FAMILY_PIPE["num_cells"]
    for rank, r in enumerate(reports):
        assert r[f"{model}/{schedule}"] == lazy, (rank, model, schedule)
        # this rank's cache: the Lazy cache's rows of its cells, nothing more
        c = cells // (WORLD * v)
        mine = [(k * WORLD + rank) * c + i for k in range(v) for i in range(c)]
        leaves = torch.load(os.path.join(d, f"cache-{model}-{schedule}-{rank}.pt"))
        assert len(leaves) == len(whole)
        for got, want in zip(leaves, whole):
            assert got.shape[0] == len(mine) and torch.equal(got, want[mine])
        assert r[f"{model}/{schedule}/cache_groups"] == cells // WORLD  # 8 layer groups


@pytest.mark.parametrize("model", sorted(W.FAMILIES))
def test_family_matches_jax_stream_engine(world, model):
    reports, jx, _ = world
    _, _, workload = W.FAMILIES[model]
    prompts, _ = WORKLOADS[workload]
    keep = [i for i, p in enumerate(prompts) if model != "mamba2" or len(p) % SSM_CHUNK == 0]
    assert len(keep) >= 5
    got, want = _lazy(reports, model), jx[model]
    assert [got[i] for i in keep] == [want[i] for i in keep]
    if model == "vision":  # the image request read its vision K/V
        assert got[W.IMAGE_UID] != reports[3]["vision/text_only"][W.IMAGE_UID]


def test_serve_cli_supervised_across_ranks_prints_what_one_process_prints(world):
    reports = world[0]
    ranked, alone = reports[0]["cli_ranked_stdout"], reports[0]["cli_one_process_stdout"]

    def lines(text):  # every line but the timing line ([mode] ... tok/s), stats apart
        keep = [line for line in text.splitlines() if not line.startswith("[")]
        stats = [line for line in keep if "supervisor:" in line]
        return [line for line in keep if "supervisor:" not in line], stats

    (r_lines, r_stats), (a_lines, a_stats) = lines(ranked), lines(alone)
    assert r_lines == a_lines and len(r_lines) >= 5
    # the round times differ, so the straggler counts may: the rest agrees
    (r_stats,), (a_stats,) = r_stats, a_stats
    r_d = ast.literal_eval(r_stats.split("supervisor:")[1].strip())
    a_d = ast.literal_eval(a_stats.split("supervisor:")[1].strip())
    r_d.pop("stragglers"), a_d.pop("stragglers")
    assert r_d == a_d and r_d["restarts"] == 1 and r_d["requests_lost"] == 0
    assert "ranks" in ranked and "+supervised" in ranked
    assert all(r["cli_ranked_stdout"] == "" for r in reports[1:])
    assert all(r["cli_ranked_tokens"] == reports[0]["cli_one_process_tokens"] for r in reports)
