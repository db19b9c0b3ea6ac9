"""``launch/pipeline_demo``: the pipelined train step with its stages on
the ranks of ``pod``, on four gloo ranks, against the JAX package.

One JAX subprocess (``_REPRO_DEVICES_SET=dryrun`` and the ``PIPE_*``
variables set before the import, as the reference reads them there)
runs the reference demo's ``make_pipelined_loss(cfg, None)`` -- the Lazy
path, which the reference defines equal to its Future path for every
schedule -- on qwen3-32b's smoke config in fp32 at 8 layers and 2
stages, on 16 x 32 seeded tokens in 8 microbatches, and records its
initial parameters, the loss and every updated leaf; and the reference's
``PipelineConfig`` bubble and stash bound and ``step_flops`` for the
demo cell under several schedules.  The reference's mesh pipeline
cannot be the oracle: its ``pcast`` of an already-varying value fails
on JAX 0.9.0 (ROADMAP, faults of the reference).  Then one spawned world
of four gloo ranks (``tests/_torch_pipeline_world.py``, a ``file://``
store in ``tmp_path``, one thread a rank, each process under one
deadline) runs the port's side.

Held here: ``ring_hop_future``'s values and gradients exactly, with the
hops issued out of order; each pipelined step across the ranks bitwise
equal to the port's Lazy step of the same split (loss and every leaf:
``embed``, ``final_norm``, ``head`` and this rank's stage blocks) for
gpipe, one_f_one_b (autodiff and planned) and interleaved (2 virtual
stages a rank; autodiff and planned) on ``(pod 4)``, and with DTensor
stages on ``(pod 2, data 2)``, and gpipe with every p2p batch returning
one work, as NCCL's (one H100 cannot hold two NCCL ranks); the port's Lazy step equal to the JAX
demo step at tests/test_torch_train_accum.py's bounds (loss rtol 1e-5,
leaves within 2e-5 * max|p|); the analytic record of qwen3-32b x
``train_4k`` on the 2x16x16 mesh: bubble and stash bound equal to the
JAX ``PipelineConfig``'s, ``analytic_flops`` to the JAX ``step_flops``,
the XLA-only fields ``null``.
"""
import json
import os
import sys

import numpy as np
import pytest

from repro_torch.launch import pipeline_demo as PD
from test_torch_mesh import _run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
JAX_TIMEOUT, WORLD_TIMEOUT = 240, 300
LOSS_RTOL, PARAM_TOL = 1e-5, 2e-5
RUNS = ("pod4_gpipe", "pod4_1f1b", "pod4_1f1b_planned", "pod4_interleaved",
        "pod4_interleaved_planned", "pod2_data2_gpipe", "pod2_data2_interleaved_planned",
        "pod4_gpipe_coalesced")
# (schedule, interleave, stages, backward) of the record comparisons
RECORD_CASES = (("gpipe", 1, 2, "autodiff"), ("one_f_one_b", 1, 2, "planned"),
                ("interleaved", 2, 4, "autodiff"), ("interleaved", 2, 4, "planned"))

JAX_SCRIPT = r"""
import os, sys
os.environ["_REPRO_DEVICES_SET"] = "dryrun"
os.environ.update(PIPE_SCHEDULE="gpipe", PIPE_INTERLEAVE="1", PIPE_STAGES="2",
                  PIPE_BACKWARD="autodiff", PIPE_REMAT="1", PIPE_SMALL="0")
import json
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import SHAPES
from repro.configs.registry import get_config, smoke_config
from repro.launch import pipeline_demo as PD
from repro.models import transformer as T
from repro.models.params import init_params
from repro.roofline import analytic as AN
from repro.train.train_step import TrainConfig

d = sys.argv[1]
cases = json.loads(sys.argv[2])
inp = np.load(os.path.join(d, "inputs.npz"))
out = {}
cfg = smoke_config(get_config("qwen3-32b")).with_overrides(num_layers=8, dtype=jnp.float32)
params = init_params(jax.random.PRNGKey(0), T.model_layout(cfg))
def flat(tree, prefix):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            flat(tree[k], prefix + "/" + k)
        else:
            out[prefix + "/" + k] = np.asarray(tree[k])
flat(params, "params")
staged = dict(params, blocks=jax.tree.map(lambda x: x.reshape((2, -1) + x.shape[1:]),
                                          params["blocks"]))
batch = {k: jnp.asarray(inp[k]) for k in ("tokens", "labels")}
new, loss = jax.jit(PD.make_pipelined_loss(cfg, None))(staged, batch)
new = dict(new, blocks=jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), new["blocks"]))
flat(new, "step")
out["step_loss"] = np.asarray(loss)
big = get_config("qwen3-32b").with_overrides(dtype=jnp.float32)
out["analytic_flops"] = np.asarray(
    AN.step_flops(big, SHAPES["train_4k"], remat=True, causal_skip=True)["total"])
for i, (sched, v, stages, backward) in enumerate(cases):
    pc = TrainConfig(num_microbatches=8, remat=True, pipeline_schedule=sched,
                     pipeline_interleave=v, pipeline_backward=backward).pipeline_config(stages)
    out[f"bubble{i}"] = np.asarray(pc.bubble_fraction)
    out[f"stash{i}"] = np.asarray(pc.peak_stash_items)
np.savez(os.path.join(d, "jax.npz"), **out)
print("JAX_DONE")
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pipeline_world"))
    rng = np.random.default_rng(0)
    np.savez(os.path.join(d, "inputs.npz"),
             tokens=rng.integers(0, 256, (16, 32)).astype(np.int32),
             labels=rng.integers(0, 256, (16, 32)).astype(np.int32))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    [(rc, err)] = _run([[sys.executable, "-c", JAX_SCRIPT, d, json.dumps(RECORD_CASES)]], env,
                       JAX_TIMEOUT, d, "jax")
    assert rc == 0, err
    results = _run([[sys.executable, os.path.join(ROOT, "tests", "_torch_pipeline_world.py"),
                     str(r), str(WORLD), d] for r in range(WORLD)],
                   env, WORLD_TIMEOUT, d, "rank")
    for r, (rc, err) in enumerate(results):
        assert rc == 0, f"rank {r}: {err}"
    reports = [json.load(open(os.path.join(d, f"report{r}.json"))) for r in range(WORLD)]
    return reports, dict(np.load(os.path.join(d, "out0.npz"))), dict(np.load(os.path.join(d, "jax.npz")))


def test_ring_hop_values_exact_out_of_order(world):
    reports, _, _ = world
    assert [r["hop_values"] for r in reports] == [True] * WORLD


def test_ring_hop_gradients_exact(world):
    reports, _, _ = world
    assert [r["hop_grads"] for r in reports] == [True] * WORLD


@pytest.mark.parametrize("run", RUNS)
def test_pipelined_step_bitwise_equals_lazy(world, run):
    reports, _, _ = world
    for rank, r in enumerate(reports):
        assert r[f"{run}_loss_bitwise"], (run, rank)
        assert r[f"{run}_leaves"] > 10
        assert r[f"{run}_leaves_bitwise"] == r[f"{run}_leaves"], (run, rank)
    # every rank ends with the same loss
    assert len({r[f"{run}_loss"] for r in reports}) == 1


@pytest.mark.parametrize("run", RUNS)
def test_pipelined_step_keeps_its_layout(world, run):
    """Each rank holds its own stages only: 2 layers of 8 over 4 ranks
    (gpipe, 1F1B), 2 virtual stages of 1 (interleaved on 4), 4 layers
    over 2 pod ranks; on (pod 2, data 2) every leaf is a DTensor."""
    reports, _, _ = world
    want = {"pod4_gpipe": 1, "pod4_1f1b": 1, "pod4_1f1b_planned": 1, "pod4_interleaved": 2,
            "pod4_interleaved_planned": 2, "pod2_data2_gpipe": 1,
            "pod2_data2_interleaved_planned": 2, "pod4_gpipe_coalesced": 1}[run]
    for r in reports:
        assert r[f"{run}_local_blocks"] == [want]
        if run.startswith("pod2_data2"):
            assert r[f"{run}_dtensors"] == r[f"{run}_leaves"]
        else:
            assert r[f"{run}_dtensors"] == 0


def test_lazy_step_equals_jax_demo_step(world):
    _, out, jx = world
    assert float(out["lazy_loss"]) == pytest.approx(float(jx["step_loss"]), rel=LOSS_RTOL)
    n = 0
    for key, want in jx.items():
        if not key.startswith("step/"):
            continue
        path = key[len("step/"):]
        torch_key = "lazy" + "".join(f"['{p}']" for p in path.split("/"))
        pmax = np.abs(jx["params/" + path]).max()
        assert np.abs(out[torch_key] - want).max() <= PARAM_TOL * max(pmax, 1e-30), key
        n += 1
    assert n == sum(k.startswith("params/") for k in jx) > 10


@pytest.mark.parametrize("case", range(len(RECORD_CASES)))
def test_record_matches_the_reference(world, case):
    _, _, jx = world
    sched, v, stages, backward = RECORD_CASES[case]
    tcfg = PD._train_config(pipeline_schedule=sched, pipeline_interleave=v,
                            pipeline_backward=backward)
    rec = PD.record("qwen3-32b", False, tcfg, stages)
    assert rec["bubble_fraction"] == float(jx[f"bubble{case}"])
    assert rec["peak_stash_items"] == int(jx[f"stash{case}"])
    assert rec["analytic_flops"] == float(jx["analytic_flops"])
    assert rec["compile_seconds"] is None and rec["memory_analysis"]["temp_size_gib"] is None
    assert all(v is None for v in rec["hlo_analysis"].values())
    assert rec["cell"] == "qwen3-32b×train_4k×multipod-PIPELINE"


def test_main_writes_the_record(tmp_path, monkeypatch):
    monkeypatch.setattr(PD, "ARTIFACT_DIR", str(tmp_path))
    rec = PD.main()
    saved = json.load(open(tmp_path / "qwen3-32b_train_4k_pipeline.json"))
    assert saved == json.loads(json.dumps(rec))
    assert saved["memory_analysis"]["argument_size_gib"] > 0
    # the 2x16x16 mesh: per chip, a 512th of the fp32 state at most
    params = 32_762_123_264
    assert saved["memory_analysis"]["argument_size_gib"] < 4 * params / 2**30 / 64
