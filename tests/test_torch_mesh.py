"""The port's mesh layer on four gloo ranks against the JAX package.

One JAX subprocess (four host devices through ``XLA_FLAGS``) computes,
on seeded numpy inputs: each device's slice of an array under four specs
on a (data 2, model 2) mesh; the five collectives under ``shard_map`` on
a four-device ``pod`` axis; the qwen3-32b smoke config's fp32
parameters (``init_params``) and one unsharded train step
(``TrainConfig(num_microbatches=2, attn_impl="dense")``).  Then one
spawned world of four gloo ranks (``tests/_torch_mesh_world.py``, a
``file://`` store in ``tmp_path``, one thread a rank) runs the port's
side; each process has its own timeout and is killed when it runs out.

Held here:

* each rank's local shard equals JAX's slice of the array, for a tuple
  of axes on one dim, two sharded dims in and out of the mesh's order,
  and one sharded dim;
* ``all_gather_future`` (tiled and stacked), ``ring_all_gather_overlapped``
  exactly; ``psum_scatter_future`` and ``reduce_scatter_then_all_gather``
  to rtol 1e-6; ``pod_allreduce_compressed``'s bf16 mean within one bf16
  ulp, its new error feedback exactly;
* ``remesh_state`` 2x2 -> (4, 1) and, through a checkpoint the four
  ranks wrote, down to one rank's (1, 1) mesh: every value bitwise;
* the sharded train step on the 2x2 mesh with ``TRAIN_RULES`` and
  ``param_pspecs``, for qwen3-32b's smoke config with dense and with
  chunked attention (8-token chunks) and, on the port's own weights,
  moonshot's (MoE), jamba's (SSM, attention and MoE), mamba2's (the SSD
  scan) and llama-3.2-vision's (cross-attention), each cut to one period
  of its layer pattern: the hooks redistributed
  DTensor activations, the params keep their placements, and loss (rtol
  1e-5), the MoE drop fraction (exactly) and every param and moment leaf
  (atol 1e-5) equal the port's unsharded step, run on plain tensors
  under the abstract (2, 2) mesh so that its MoE dispatch is blocked by
  data shard as the sharded one is (and the reference's); moonshot's
  and jamba's steps again at 6 tokens (B 1 x S 6) on a (pod 2, data 2)
  mesh, where the dispatch halves to 2 blocks, each shared by a pod
  rank's two data ranks, and moonshot's on (data 4, model 1), where
  every rank runs both blocks; qwen3's
  unsharded step equals the JAX unsharded step at tests/test_torch_train_accum.py's
  bounds (loss rtol 1e-5, leaves within 2e-5 * max|p|).  AdamW runs at
  eps 1e-3 and lr 1e-3 there, as in that file.  The JAX *sharded* step
  (tests/test_multidevice.py's, red: ROADMAP C) is not a reference.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
JAX_TIMEOUT, WORLD_TIMEOUT = 180, 300
SHARD_NAMES = ("tuple", "two_dim", "swapped", "model_only")
LOSS_RTOL, LEAF_ATOL, PARAM_TOL = 1e-5, 1e-5, 2e-5
STEP_ARCHS = ("qwen3", "qwen3_chunked", "moonshot", "jamba", "mamba2", "vision",
              "moonshot_ds2", "jamba_ds2", "moonshot_ds2_data4")

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import compat
from repro.core.future import all_gather_future, psum_scatter_future
from repro.parallel import collectives as C
from repro.configs.registry import get_config, smoke_config
from repro.models import transformer as T
from repro.models.params import init_params
from repro.train import optimizer as O
from repro.train import train_step as S

d = sys.argv[1]
inp = np.load(os.path.join(d, "inputs.npz"))
out = {}
devs = np.array(jax.devices())
mesh2 = Mesh(devs.reshape(2, 2), ("data", "model"))
specs = {"tuple": P(("data", "model"), None), "two_dim": P("data", "model"),
         "swapped": P("model", "data"), "model_only": P(None, None, "model")}
for name, spec in specs.items():
    shape = inp["shard_" + name].shape
    idx = NamedSharding(mesh2, spec).devices_indices_map(shape)
    out["idx_" + name] = np.array([[(s.start or 0, shape[k] if s.stop is None else s.stop)
                                    for k, s in enumerate(idx[dv])] for dv in devs])

mesh = Mesh(devs, ("pod",))
def sm(f, n_out=1):
    return jax.jit(compat.shard_map(f, mesh=mesh, in_specs=(P("pod"), P("pod")),
                                    out_specs=tuple([P("pod")] * n_out)))
x, err = jnp.asarray(inp["coll_x"]), jnp.asarray(inp["coll_err"])
def body(v, e):
    ring = jnp.stack(C.ring_all_gather_overlapped(v, "pod", lambda s, slot: s * (slot + 1.0)))
    red, new_err = C.pod_allreduce_compressed({"g": v}, "pod", {"g": e})
    return (all_gather_future(v, "pod").force(),
            all_gather_future(v, "pod", tiled=False).force(),
            psum_scatter_future(v, "pod").force(), ring,
            C.reduce_scatter_then_all_gather(v, "pod").force(), red["g"], new_err["g"])
names = ["all_gather", "all_gather_untiled", "psum_scatter", "ring", "rs_ag", "compressed",
         "compressed_err"]
for n, v in zip(names, sm(body, len(names))(x, err)):
    out["coll_" + n] = np.asarray(v)

cfg = smoke_config(get_config("qwen3-32b")).with_overrides(dtype=jnp.float32)
params = init_params(jax.random.PRNGKey(0), T.model_layout(cfg))
def flat(tree, prefix):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            flat(tree[k], prefix + "/" + k)
        else:
            out[prefix + "/" + k] = np.asarray(tree[k])
flat(params, "params")
ocfg = O.AdamWConfig(learning_rate=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)
step = jax.jit(S.make_train_step(cfg, S.TrainConfig(num_microbatches=2, attn_impl="dense"), ocfg))
batch = {k: jnp.asarray(inp[k]) for k in ("tokens", "labels")}
p1, o1, m1 = step(params, O.init_opt_state(params, ocfg), batch)
flat(p1, "step/params"); flat(o1["m"], "step/m"); flat(o1["v"], "step/v")
out["step_loss"] = np.asarray(m1["loss"])
np.savez(os.path.join(d, "jax.npz"), **out)
print("JAX_DONE")
"""


def _run(cmds, env, timeout, logdir, tag):
    """Start every command (output to ``logdir/<tag><i>.log``), wait for
    all within ``timeout`` seconds in all, kill the rest when it runs
    out; returns ``(returncode, log tail)`` per command."""
    logs = [os.path.join(logdir, f"{tag}{i}.log") for i in range(len(cmds))]
    procs = []
    for c, log in zip(cmds, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(c, env=env, cwd=ROOT, stdin=subprocess.DEVNULL,
                                          stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, open(log).read()[-4000:]) for p, log in zip(procs, logs)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_world"))
    rng = np.random.default_rng(0)
    np.savez(
        os.path.join(d, "inputs.npz"),
        coll_x=rng.standard_normal((16, 6)).astype(np.float32),
        coll_err=(1e-3 * rng.standard_normal((16, 6))).astype(np.float32),
        shard_tuple=rng.standard_normal((8, 3)).astype(np.float32),
        shard_two_dim=rng.standard_normal((4, 6)).astype(np.float32),
        shard_swapped=rng.standard_normal((6, 4)).astype(np.float32),
        shard_model_only=rng.standard_normal((2, 3, 4)).astype(np.float32),
        tokens=rng.integers(0, 256, (4, 16)).astype(np.int32),
        labels=rng.integers(0, 256, (4, 16)).astype(np.int32),
        vision_embeds=rng.standard_normal((4, 16, 64)).astype(np.float32),
        tokens6=rng.integers(0, 256, (1, 6)).astype(np.int32),
        labels6=rng.integers(0, 256, (1, 6)).astype(np.int32),
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    [(rc, err)] = _run([[sys.executable, "-c", JAX_SCRIPT, d]], env, JAX_TIMEOUT, d, "jax")
    assert rc == 0, err
    env.pop("XLA_FLAGS", None)
    results = _run([[sys.executable, os.path.join(ROOT, "tests", "_torch_mesh_world.py"),
                     str(r), str(WORLD), d] for r in range(WORLD)],
                   env, WORLD_TIMEOUT, d, "rank")
    for r, (rc, err) in enumerate(results):
        assert rc == 0, f"rank {r}: {err}"
    reports = [json.load(open(os.path.join(d, f"report{r}.json"))) for r in range(WORLD)]
    outs = [dict(np.load(os.path.join(d, f"out{r}.npz"))) for r in range(WORLD)]
    return reports, outs, dict(np.load(os.path.join(d, "jax.npz")))


def _block(jax_out, rank):
    """Device ``rank``'s block of a shard_map output tiled over pod."""
    return jax_out.reshape((WORLD, -1) + jax_out.shape[1:])[rank]


@pytest.mark.parametrize("name", SHARD_NAMES)
def test_local_shards_are_jax_slices(world, name):
    reports, _, _ = world
    assert [r[f"shard_{name}"] for r in reports] == [True] * WORLD


@pytest.mark.parametrize("name", ["all_gather", "all_gather_untiled", "ring"])
def test_gathers_and_permutes_equal_jax_exactly(world, name):
    _, outs, jx = world
    for r in range(WORLD):
        want = _block(jx[f"coll_{name}"], r).reshape(outs[r][name].shape)
        np.testing.assert_array_equal(outs[r][name], want)


@pytest.mark.parametrize("name", ["psum_scatter", "rs_ag"])
def test_reductions_equal_jax(world, name):
    _, outs, jx = world
    for r in range(WORLD):
        want = _block(jx[f"coll_{name}"], r).reshape(outs[r][name].shape)
        np.testing.assert_allclose(outs[r][name], want, rtol=1e-6, atol=0)


def test_compressed_mean_within_one_bf16_ulp(world):
    _, outs, jx = world
    for r in range(WORLD):
        got = outs[r]["compressed"]
        want = _block(jx["coll_compressed"], r).reshape(got.shape)
        # one bf16 ulp at the value: 2^(exponent - 7)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp), r
        np.testing.assert_array_equal(
            outs[r]["compressed_err"],
            _block(jx["coll_compressed_err"], r).reshape(got.shape))


def test_collective_group_from_the_mesh_set(world):
    reports, _, _ = world
    assert all(r["ag_under_set_mesh"] for r in reports)


def test_remesh_state(world):
    reports, _, _ = world
    for r in reports:
        assert r["remesh_placements"] and r["remesh_2x2_to_4x1"]
        assert r["remesh_sharded"] > 0
    assert reports[0]["plan_one"] == [[1, 1, 1], ["data", "model", "pipe"]]
    assert reports[0]["restore_one_rank"]


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_sharded_step_runs_sharded(world, arch):
    reports, _, _ = world
    for r in reports:
        assert r[f"{arch}_constrained_dtensors"] > 0
        assert r[f"{arch}_sharded_params_placements"]


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_sharded_step_equals_unsharded(world, arch):
    reports, outs, _ = world
    for r, rep in enumerate(reports):
        assert rep[f"{arch}_loss_sharded"] == pytest.approx(rep[f"{arch}_loss_plain"],
                                                            rel=LOSS_RTOL)
        assert rep[f"{arch}_drop_sharded"] == rep[f"{arch}_drop_plain"]
        plain = f"{arch}_plain"
        keys = [k[len(plain):] for k in outs[r] if k.startswith(plain + "[")]
        assert len(keys) > 20
        for k in keys:
            np.testing.assert_allclose(outs[r][f"{arch}_sharded" + k], outs[r][plain + k],
                                       rtol=0, atol=LEAF_ATOL, err_msg=k)


def test_unsharded_step_equals_jax(world):
    reports, outs, jx = world
    assert reports[0]["qwen3_loss_plain"] == pytest.approx(float(jx["step_loss"]),
                                                           rel=LOSS_RTOL)
    n = 0
    for key, want in jx.items():
        if not key.startswith("step/"):
            continue
        part, path = key.split("/", 2)[1:]
        torch_key = f"qwen3_plain['{part}']" + "".join(
            f"['{p}']" for p in path.split("/"))
        pmax = np.abs(jx["params/" + path]).max()
        assert np.abs(outs[0][torch_key] - want).max() <= PARAM_TOL * max(pmax, 1e-30), key
        n += 1
    assert n == 3 * sum(k.startswith("params/") for k in jx)
