"""One rank of tests/test_torch_mesh.py's 4-rank gloo world.

``python tests/_torch_mesh_world.py RANK WORLD DIR``: joins the world
through the file store ``DIR/store``, reads the seeded inputs
(``DIR/inputs.npz``) and the JAX side's results (``DIR/jax.npz``), runs
the battery and writes ``DIR/report<RANK>.json`` and
``DIR/out<RANK>.npz``; the test holds them to the JAX results.  It
imports no JAX.  Rank 0 ends with the elastic step down to one rank: a
world of its own (one rank, a hash store) restoring the checkpoint the
four ranks wrote into a template sharded on a (1, 1) mesh.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch.distributed as dist  # noqa: E402

from repro_torch import pytree as PT  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.core.future import all_gather_future, psum_scatter_future  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params, params_from_numpy  # noqa: E402
from repro_torch.parallel import collectives as C  # noqa: E402
from repro_torch.parallel import sharding as SH  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train.checkpoint import Checkpointer  # noqa: E402
from repro_torch.train.elastic import choose_elastic_plan, remesh_state  # noqa: E402
from repro_torch.train.train_step import TrainConfig, make_train_step  # noqa: E402

# spec name -> spec on the (data 2, model 2) mesh; the JAX side computes
# each device's slice of the same array under the same spec
SHARD_SPECS = {
    "tuple": SH.PartitionSpec(("data", "model"), None),
    "two_dim": SH.PartitionSpec("data", "model"),
    "swapped": SH.PartitionSpec("model", "data"),
    "model_only": SH.PartitionSpec(None, None, "model"),
}
OCFG = O.AdamWConfig(learning_rate=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)
TCFG = TrainConfig(num_microbatches=2, attn_impl="dense")


def step_cases(qwen_cfg, qwen_layout, qwen_params):
    """``(name, cfg, layout, params, TrainConfig)`` of each sharded-step
    case: qwen3 on the JAX weights, the others on the port's seeded ones
    (fp32, plain kernels, at least 2 layers and one period of the pattern); a vision config's cross-attention gates get
    seeded values in [0.5, 1.5] (zeros add nothing)."""
    chunked = TrainConfig(num_microbatches=2, attn_impl="chunked", q_chunk=8, kv_chunk=8)
    yield "qwen3", qwen_cfg, qwen_layout, qwen_params, TCFG
    yield "qwen3_chunked", qwen_cfg, qwen_layout, qwen_params, chunked
    for name, arch in (("moonshot", "moonshot-v1-16b-a3b"), ("jamba", "jamba-1.5-large-398b"),
                       ("mamba2", "mamba2-1.3b"), ("vision", "llama-3.2-vision-90b")):
        acfg = smoke_config(get_config(arch)).with_overrides(dtype=torch.float32,
                                                             kernels="plain")
        # one period of the layer pattern holds every block kind: jamba's 16
        # smoke layers cut to 8, llama-3.2-vision's 10 to 5
        acfg = acfg.with_overrides(num_layers=max(2, T.effective_period(acfg)))
        alayout = T.model_layout(acfg)
        aparams = init_params(alayout, seed=0, device="cpu")
        gen = torch.Generator().manual_seed(1)
        for blk in aparams["blocks"].values():
            if "xattn_gate" in blk:
                g = blk["xattn_gate"]["gate"]
                blk["xattn_gate"]["gate"] = 0.5 + torch.rand(g.shape, generator=gen)
        yield name, acfg, alayout, aparams, TCFG


def unflatten(flat: dict, prefix: str) -> dict:
    """A nested dict from the ``prefix/a/b`` keys of an npz file."""
    tree: dict = {}
    for key in flat.files if hasattr(flat, "files") else flat:
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return tree


def full(x):
    return x.full_tensor() if SH.is_dtensor(x) else x


def step_case(arch, acfg, alayout, aparams, tcfg, batch, mesh, report, out):
    """One sharded train step on ``mesh`` against the unsharded step on
    plain tensors under the abstract mesh of the same shape (its MoE
    dispatch blocked by data shard as the sharded one is): losses, drop
    fractions, the constraint count and every leaf into ``report`` and
    ``out`` under ``arch``."""
    dbatch = {}
    for k, v in batch.items():
        bspec = SH.fit_spec(SH.spec_for(("batch",) + (None,) * (v.dim() - 1),
                                        SH.TRAIN_RULES), tuple(v.shape), mesh)
        dbatch[k] = SH.distribute(v, mesh, SH.placements(bspec, mesh))
    aspecs = SH.param_pspecs(alayout, SH.TRAIN_RULES, mesh)
    dparams = remesh_state(aparams, alayout, SH.TRAIN_RULES, mesh)
    with SH.set_mesh(SH.AbstractMesh(tuple(mesh.shape), tuple(mesh.mesh_dim_names))):
        plain = make_train_step(acfg, tcfg, OCFG)(aparams, O.init_opt_state(aparams, OCFG),
                                                  batch)
    calls = []
    inner = SH.maybe_constrain

    def counting(x, spec):
        calls.append(SH.is_dtensor(x))
        return inner(x, spec)

    SH.maybe_constrain = counting
    try:
        step = make_train_step(acfg, tcfg, OCFG, param_pspecs=aspecs)
        with SH.set_mesh(mesh):
            sharded = step(dparams, O.init_opt_state(dparams, OCFG), dbatch)
    finally:
        SH.maybe_constrain = inner
    report[f"{arch}_constrained_dtensors"] = sum(calls)
    report[f"{arch}_sharded_params_placements"] = all(
        tuple(t.placements) == SH.placements(s, mesh)
        for t, s in zip(PT.leaves(sharded[0]), PT.leaves(aspecs)))
    for tag, (p, o, m) in (("plain", plain), ("sharded", sharded)):
        report[f"{arch}_loss_{tag}"] = float(full(m["loss"]))
        report[f"{arch}_drop_{tag}"] = float(full(m["moe_drop_fraction"]))
        for path, leaf in PT.flatten_with_paths({"params": p, "m": o["m"], "v": o["v"]}):
            out[f"{arch}_{tag}{path}"] = full(leaf)


def main(rank: int, world: int, d: str):
    torch.set_num_threads(1)
    inp, jx = np.load(os.path.join(d, "inputs.npz")), np.load(os.path.join(d, "jax.npz"))
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'store')}",
                            rank=rank, world_size=world)
    report, out = {}, {}
    mesh2 = make_mesh((2, 2), ("data", "model"))
    mesh_pod = make_host_mesh("pod")

    # 1. local shards rank by rank: JAX's slice of each device
    for name, spec in SHARD_SPECS.items():
        x = torch.from_numpy(inp[f"shard_{name}"])
        local = SH.distribute(x, mesh2, SH.placements(spec, mesh2)).to_local()
        idx = jx[f"idx_{name}"][rank]
        want = x[tuple(slice(int(a), int(b)) for a, b in idx)]
        report[f"shard_{name}"] = bool(torch.equal(local, want))

    # 2. the five collectives over the 4-rank axis, on rank r's block
    xs = torch.from_numpy(inp["coll_x"])
    x = xs.view(world, -1, xs.shape[-1])[rank].clone()
    err = torch.from_numpy(inp["coll_err"]).view(world, -1, xs.shape[-1])[rank].clone()
    out["all_gather"] = all_gather_future(x, "pod", mesh=mesh_pod).force()
    out["all_gather_untiled"] = all_gather_future(x, "pod", tiled=False, mesh=mesh_pod).force()
    out["psum_scatter"] = psum_scatter_future(x, "pod", mesh=mesh_pod).force()
    out["ring"] = torch.stack(C.ring_all_gather_overlapped(
        x, "pod", lambda s, slot: s * (slot + 1.0), mesh=mesh_pod))
    out["rs_ag"] = C.reduce_scatter_then_all_gather(x, "pod", mesh=mesh_pod).force()
    red, new_err = C.pod_allreduce_compressed({"g": x}, "pod", {"g": err}, mesh=mesh_pod)
    out["compressed"], out["compressed_err"] = red["g"], new_err["g"]
    with SH.set_mesh(mesh_pod):  # the axis group from the mesh set
        report["ag_under_set_mesh"] = bool(torch.equal(
            all_gather_future({"a": x}, "pod").force()["a"], out["all_gather"]))

    # 3. remesh_state: onto the 2x2 mesh, then to (data 4, model 1)
    cfg = smoke_config(get_config("qwen3-32b")).with_overrides(dtype=torch.float32,
                                                              kernels="plain")
    layout = T.model_layout(cfg)
    params = params_from_numpy(unflatten(jx, "params"), device="cpu")
    d2 = remesh_state(params, layout, SH.TRAIN_RULES, mesh2)
    specs = SH.param_pspecs(layout, SH.TRAIN_RULES, mesh2)
    report["remesh_placements"] = all(
        tuple(t.placements) == SH.placements(s, mesh2)
        for t, s in zip(PT.leaves(d2), PT.leaves(specs)))
    report["remesh_sharded"] = sum(
        t.to_local().numel() < t.numel() for t in PT.leaves(d2))
    mesh41 = make_mesh((4, 1), ("data", "model"))
    d41 = remesh_state(d2, layout, SH.TRAIN_RULES, mesh41)
    report["remesh_2x2_to_4x1"] = all(
        torch.equal(full(a), b) for a, b in zip(PT.leaves(d41), PT.leaves(params)))
    Checkpointer(os.path.join(d, f"ckpt{rank}")).save(0, {"params": d2}, blocking=True)

    # 4. the sharded train step on the 2x2 mesh against the unsharded one,
    # which runs on plain tensors under the abstract (2, 2) mesh (the MoE
    # dispatch blocks by its data shards there, as the reference's does):
    # qwen3-32b's smoke config on the JAX weights with dense and chunked
    # attention, and moonshot's (MoE), jamba's (SSM, attention, MoE),
    # mamba2's (SSM) and llama-3.2-vision's (cross-attention) on the port's
    # own
    moe_cases = []
    for arch, acfg, alayout, aparams, tcfg in step_cases(cfg, layout, params):
        batch = {k: torch.from_numpy(inp[k]).long() for k in ("tokens", "labels")}
        if acfg.vision_tokens:
            batch["vision_embeds"] = torch.from_numpy(inp["vision_embeds"])
        step_case(arch, acfg, alayout, aparams, tcfg, batch, mesh2, report, out)
        if acfg.moe is not None:
            moe_cases.append((arch, acfg, alayout, aparams, tcfg))
    # the MoE dispatch at halved blocks: 6 tokens (B 1 x S 6, one
    # microbatch) over 4 (pod, data) ranks make 2 blocks, each shared by
    # the 2 data ranks of a pod rank; over (data 4, model 1) the 2 blocks
    # shard over no axis and every rank runs both
    batch6 = {k: torch.from_numpy(inp[k + "6"]).long() for k in ("tokens", "labels")}
    mesh_pd = make_mesh((2, 2), ("pod", "data"))
    for arch, acfg, alayout, aparams, tcfg in moe_cases:
        tcfg1 = dataclasses.replace(tcfg, num_microbatches=1)
        step_case(f"{arch}_ds2", acfg, alayout, aparams, tcfg1, batch6, mesh_pd, report, out)
        if arch == "moonshot":
            step_case(f"{arch}_ds2_data4", acfg, alayout, aparams, tcfg1, batch6, mesh41,
                      report, out)
    dist.barrier()
    dist.destroy_process_group()

    # 5. rank 0: the elastic step down to one rank
    if rank == 0:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        plan = choose_elastic_plan(1)
        report["plan_one"] = [list(plan.mesh_shape), list(plan.axis_names)]
        mesh11 = make_mesh(plan.mesh_shape[:2], plan.axis_names[:2])
        template = {"params": remesh_state(params, layout, SH.TRAIN_RULES, mesh11)}
        restored, step_no = Checkpointer(os.path.join(d, "ckpt0")).restore(template)
        report["restore_one_rank"] = step_no == 0 and all(
            SH.is_dtensor(a) and a.device_mesh is mesh11 and torch.equal(a.to_local(), b)
            for a, b in zip(PT.leaves(restored["params"]), PT.leaves(params)))
        dist.destroy_process_group()

    np.savez(os.path.join(d, f"out{rank}.npz"),
             **{k: v.detach().numpy() for k, v in out.items()})
    with open(os.path.join(d, f"report{rank}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
