"""One rank of tests/test_torch_pipeline_demo.py's 4-rank gloo world.

``python tests/_torch_pipeline_world.py RANK WORLD DIR``: joins the world
through the file store ``DIR/store``, reads the seeded batch
(``DIR/inputs.npz``) and the JAX side's initial parameters
(``DIR/jax.npz``), runs the battery and writes ``DIR/report<RANK>.json``
and ``DIR/out<RANK>.npz``.  It imports no JAX.

* ``ring_hop_future`` on ``(pod 4)``: three hops a rank, issued in an
  order that differs from rank to rank and forced in another; the values
  and the gradients through them against their closed forms;
* the pipelined demo step (qwen3-32b's smoke config, 8 layers, fp32, 16
  x 32 tokens in 8 microbatches) across the ranks of ``pod`` against the
  port's Lazy step of the same stage split, bitwise: on ``(pod 4)``
  gpipe, one_f_one_b (autodiff and planned) with 4 stages and
  interleaved (2 virtual stages a rank, autodiff and planned) with 8; on
  ``(pod 2, data 2)`` with the params and the batch DTensors on each pod
  rank's ``data`` sub-mesh (``TRAIN_RULES``, ``batch="data"``), gpipe
  with 2 stages and interleaved planned with 4, against the Lazy step on
  the same sub-mesh; and gpipe on ``(pod 4)`` again with each p2p batch
  returning one work, as NCCL's does.  Rank 0 also keeps the Lazy 2-stage step's loss and
  leaves, which the test holds to the JAX demo step.
"""
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
from repro_torch.core.future import ring_hop_future  # noqa: E402
from repro_torch.core.pipeline import local_stages  # noqa: E402
from repro_torch.launch import pipeline_demo as PD  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.parallel import sharding as SH  # noqa: E402

LAYERS = 8
# (name, mesh shape, schedule, interleave, stages, backward)
RUNS = (
    ("pod4_gpipe", (4,), "gpipe", 1, 4, "autodiff"),
    ("pod4_1f1b", (4,), "one_f_one_b", 1, 4, "autodiff"),
    ("pod4_1f1b_planned", (4,), "one_f_one_b", 1, 4, "planned"),
    ("pod4_interleaved", (4,), "interleaved", 2, 8, "autodiff"),
    ("pod4_interleaved_planned", (4,), "interleaved", 2, 8, "planned"),
    ("pod2_data2_gpipe", (2, 2), "gpipe", 1, 2, "autodiff"),
    ("pod2_data2_interleaved_planned", (2, 2), "interleaved", 2, 4, "planned"),
    ("pod4_gpipe_coalesced", (4,), "gpipe", 1, 4, "autodiff"),
)


class Coalesced:
    """One work for a whole p2p batch, as NCCL returns it (gloo returns one
    an op), whose receives land in their buffers only when it is waited
    on (a consumer that reads a buffer before waiting on its batch reads
    garbage, as it would on a card)."""

    def __init__(self, works, staged):
        self.works, self.staged = works, staged

    def wait(self):
        for w in self.works:
            w.wait()
        for dst, src in self.staged:
            dst.copy_(src)
        self.works, self.staged = [], []
        return True


def nccl_shaped(batch_isend_irecv):
    def batch(ops):
        staged, sent = [], []
        for op in ops:
            if op.op is dist.irecv:
                staged.append((op.tensor, torch.full_like(op.tensor, float("nan"))))
                op = dist.P2POp(op.op, staged[-1][1], op.peer, op.group, op.tag)
            sent.append(op)
        return [Coalesced(batch_isend_irecv(sent), staged)]

    return batch


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


def local(x):
    return x.to_local() if SH.is_dtensor(x) else x


def full(x):
    return x.full_tensor() if SH.is_dtensor(x) else x


def hop_battery(mesh, rank: int, report: dict) -> None:
    """Three hops a rank, tags issued in a rank-dependent order and forced
    in tag order; then the gradient of a weighted sum of what arrived."""
    world = 4
    x = (torch.arange(5.0) + 10 * rank).requires_grad_(True)
    futs = {}
    for tag in [(rank + i) % 3 for i in range(3)]:
        futs[tag] = ring_hop_future(x * (tag + 1), "pod", mesh=mesh, tag=tag)
    back = ring_hop_future(x * 7, "pod", mesh=mesh, reverse=True, tag=3)
    got = [futs[tag].force() for tag in range(3)] + [back.force()]
    prev, nxt = (rank - 1) % world, (rank + 1) % world
    want = [(torch.arange(5.0) + 10 * prev) * (tag + 1) for tag in range(3)]
    want.append((torch.arange(5.0) + 10 * nxt) * 7)
    report["hop_values"] = all(torch.equal(a, b) for a, b in zip(got, want))
    loss = sum(((i + 2) * y).sum() for i, y in enumerate(got))
    (g,) = torch.autograd.grad(loss, [x])
    # x * (t + 1) reaches the next rank, weighted there by t + 2; x * 7 the
    # previous rank, weighted by 5
    report["hop_grads"] = bool(torch.equal(g, torch.full((5,), 2.0 + 6 + 12 + 35)))


def distributed(tree, specs, mesh):
    return PT.tree_map(lambda t, s: SH.distribute(t, mesh, SH.placements(s, mesh)), tree, specs)


def main(rank: int, world: int, d: str):
    torch.set_num_threads(1)
    inp, jx = np.load(os.path.join(d, "inputs.npz")), np.load(os.path.join(d, "jax.npz"))
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'store')}",
                            rank=rank, world_size=world)
    report, out = {}, {}
    pod4 = make_mesh((4,), ("pod",))
    hop_battery(pod4, rank, report)

    cfg = smoke_config(get_config("qwen3-32b")).with_overrides(
        num_layers=LAYERS, dtype=torch.float32, kernels="plain")
    params = params_from_numpy(unflatten(jx, "params"), device="cpu")
    batch = {k: torch.from_numpy(inp[k]).long() for k in ("tokens", "labels")}

    def staged(tree, stages):
        return dict(tree, blocks=PD.stage_params(tree["blocks"], stages))

    # the Lazy steps: the JAX demo's 2 stages, and each run's split
    lazy = {}
    for stages in (2, 4, 8):
        tcfg = PD._train_config(pipeline_schedule="gpipe", pipeline_interleave=1)
        lazy[stages] = PD.make_pipelined_loss(cfg, None, tcfg, stages)(
            staged(params, stages), batch)
    if rank == 0:
        new, loss = lazy[2]
        out["lazy_loss"] = loss
        for path, leaf in PT.flatten_with_paths(
                dict(new, blocks=PT.tree_map(lambda t: t.reshape((-1,) + t.shape[2:]),
                                             new["blocks"]))):
            out["lazy" + path] = leaf

    # the pipelined steps across the pod ranks
    layout = T.model_layout(cfg)
    for name, shape, schedule, interleave, stages, backward in RUNS:
        tcfg = PD._train_config(pipeline_schedule=schedule, pipeline_interleave=interleave,
                                pipeline_backward=backward)
        pcfg = tcfg.pipeline_config(stages)
        start = staged(params, stages)
        if shape == (4,):
            mesh, ref = pod4, lazy[stages]
            args, bt = start, batch
        else:
            mesh = make_mesh(shape, ("pod", "data"))
            sub = PD.stage_mesh(mesh)
            specs = SH.param_pspecs(layout, PD.RULES, sub)
            specs = dict(specs, blocks=PT.tree_map(
                lambda s, t: SH.fit_spec(SH.PartitionSpec(None, *s), tuple(t.shape), sub),
                specs["blocks"], start["blocks"]))
            args = distributed(start, specs, sub)
            bt = {k: SH.distribute(v, sub, SH.placements(SH.fit_spec(
                SH.spec_for(("batch", "seq"), PD.RULES), tuple(v.shape), sub), sub))
                for k, v in batch.items()}
            ref = PD.make_pipelined_loss(cfg, mesh, tcfg, stages, lazy=True)(args, bt)
        args = dict(args, blocks=local_stages(args["blocks"], pcfg, mesh))
        real = dist.batch_isend_irecv
        if name.endswith("_coalesced"):
            dist.batch_isend_irecv = nccl_shaped(real)
        try:
            new, loss = PD.make_pipelined_loss(cfg, mesh, tcfg, stages)(args, bt)
        finally:
            dist.batch_isend_irecv = real
        want, want_loss = ref
        want = dict(want, blocks=local_stages(want["blocks"], pcfg, mesh))
        pairs = list(zip(PT.leaves(new), PT.leaves(want)))
        report[f"{name}_loss_bitwise"] = bool(torch.equal(full(loss), full(want_loss)))
        report[f"{name}_leaves"] = len(pairs)
        report[f"{name}_leaves_bitwise"] = sum(
            bool(torch.equal(local(a), local(b))) for a, b in pairs)
        report[f"{name}_dtensors"] = sum(SH.is_dtensor(a) for a, _ in pairs)
        report[f"{name}_local_blocks"] = [int(local(t).shape[0]) for t in
                                          PT.leaves(new["blocks"])][:1]
        report[f"{name}_loss"] = float(full(loss))

    dist.barrier()
    dist.destroy_process_group()
    np.savez(os.path.join(d, f"out{rank}.npz"),
             **{k: v.detach().numpy() for k, v in out.items()})
    with open(os.path.join(d, f"report{rank}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
