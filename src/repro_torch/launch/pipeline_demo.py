"""Multi-pod STREAM-FUTURE mode: a layer pipeline across the ``pod`` axis.

Port of ``repro.launch.pipeline_demo``: the paper's technique as the
production cross-pod schedule (the reference's DESIGN §4 mode (b)).
The stages are contiguous spans of a real architecture's layer groups,
one span a ``pod`` rank (``PIPE_INTERLEAVE`` spans a rank, interleaved);
the items are microbatches; the activations hop between pod ranks as a
:func:`~repro_torch.core.future.ring_hop_future`-style p2p hand-off
(``FutureEvaluator`` across ranks).  Inside a stage FSDP x TP stays
automatic: the stage's blocks are DTensors on the rank's ``(data,
model)`` sub-mesh, laid out by ``TRAIN_RULES`` with ``batch="data"``,
and the model's hooks constrain onto that sub-mesh (the reference's
partial-manual ``shard_map``: ``pod`` manual, the rest automatic).
Autograd through the schedule gives the backward pipeline (GPipe by
autodiff), or the combined plan's B units under ``PIPE_BACKWARD=
planned``; each stage's block leaves stay on their rank, and every rank
ends with the same loss and the same ``embed``, ``final_norm`` and
``head`` (each rank computes the head and the loss on the broadcast
outputs, so their gradients are whole on every rank, as GSPMD's
replicated computation makes them).

    PYTHONPATH=src python -m repro_torch.launch.pipeline_demo

writes the record of qwen3-32b x ``train_4k`` on the 2x16x16 mesh with
the stages over ``pod`` (``PIPE_SMALL=1``: a 2x2x2 mesh, 16 x 512
tokens), analytically, as ``launch/dryrun.py`` does: argument bytes per
chip from the shards' local shapes, the analytic FLOPs, the schedule's
bubble and stash bound; what the reference reads from XLA's compiled
module (``compile_seconds``, ``temp_size_gib``, every ``hlo_analysis``
field) is ``null``.  It needs no process group.  The step itself runs
wherever ``torch.distributed`` has a group: ``tests/
test_torch_pipeline_demo.py`` runs it on four gloo ranks, ``chip_smoke.py``
step 13 on a one-rank NCCL group.

The step and the record are in fp32, as the reference's: it lowers in
fp32 to get round an XLA:CPU failure on bf16 cotangents inside a
partial-manual ``shard_map``, and the port keeps the dtype so that its
step and record hold to the reference's.

The knobs are the reference's environment variables, read at import:
``PIPE_ARCH`` (qwen3-32b), ``PIPE_ATTN`` (chunked), ``PIPE_SCHEDULE``
(gpipe | one_f_one_b | interleaved), ``PIPE_INTERLEAVE`` (1),
``PIPE_STAGES`` (the stage groups: pod size x interleave, 2 x
``PIPE_INTERLEAVE`` by default), ``PIPE_BACKWARD`` (autodiff | planned),
``PIPE_REMAT`` (1) and ``PIPE_SMALL`` (0).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import torch

from repro_torch import pytree as PT
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.core.pipeline import pipeline_apply
from repro_torch.launch import specs as SP
from repro_torch.launch.dryrun import ARTIFACT_DIR
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import abstract_params
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.sharding import AbstractMesh
from repro_torch.roofline import analytic as AN
from repro_torch.train.train_step import TrainConfig

PyTree = Any

NUM_MICRO = 8
SMALL = os.environ.get("PIPE_SMALL", "0") == "1"
ARCH = os.environ.get("PIPE_ARCH", "qwen3-32b")
ATTN = os.environ.get("PIPE_ATTN", "chunked")
SHAPE = "train_4k"
REMAT = os.environ.get("PIPE_REMAT", "1") == "1"
# Pipeline schedule knobs (see repro_torch.core.schedules): gpipe (default),
# one_f_one_b, or interleaved with PIPE_INTERLEAVE groups per rank.
# PIPE_STAGES is the number of stage groups of the model; it must be
# (pod axis size x PIPE_INTERLEAVE).  PIPE_BACKWARD: "autodiff" (autograd
# through the forward plan) or "planned" (the combined plan's B units).
SCHEDULE = os.environ.get("PIPE_SCHEDULE", "gpipe")
INTERLEAVE = int(os.environ.get("PIPE_INTERLEAVE", "1"))
NUM_STAGES = int(os.environ.get("PIPE_STAGES", str(2 * INTERLEAVE)))
BACKWARD = os.environ.get("PIPE_BACKWARD", "autodiff")
LEARNING_RATE = 1e-3  # the SGD-style apply keeps the demo on the pipeline schedule

# The demo's rules: pod is the pipeline axis, so the batch shards over data only.
RULES = dict(SH.TRAIN_RULES, batch="data")


def _train_config(**overrides) -> TrainConfig:
    knobs = dict(num_microbatches=NUM_MICRO, remat=REMAT, pipeline_schedule=SCHEDULE,
                 pipeline_interleave=INTERLEAVE, pipeline_backward=BACKWARD)
    return TrainConfig(**{**knobs, **overrides})


def staged_blocks_abstract(cfg, rules, mesh, num_stages: int = NUM_STAGES) -> PyTree:
    """Abstract params (:class:`~repro_torch.launch.specs.ShardedStruct`
    leaves) with the block leaves reshaped ``(G, ...) -> (stages, G/S,
    ...)`` and the stage axis sharded over ``pod``; ``embed``,
    ``final_norm`` and ``head`` as their rules lay them out."""
    layout = T.model_layout(cfg)
    a = abstract_params(layout)
    specs = SH.param_pspecs(layout, rules, mesh)

    def stage_leaf(meta, spec):
        groups = meta.shape[0]
        if groups % num_stages:
            raise ValueError(f"{groups} layer groups do not split into {num_stages} stages")
        shape = (num_stages, groups // num_stages) + tuple(meta.shape[1:])
        pspec = SH.fit_spec(SH.PartitionSpec("pod", *spec), shape, mesh)
        return SP.ShardedStruct(torch.empty(shape, dtype=meta.dtype, device="meta"), pspec, mesh)

    def leaf(meta, spec):
        return SP.ShardedStruct(meta, SH.fit_spec(spec, tuple(meta.shape), mesh), mesh)

    out = {"blocks": PT.tree_map(stage_leaf, a["blocks"], specs["blocks"])}
    for key in ("embed", "final_norm", "head"):
        if key in a:
            out[key] = PT.tree_map(leaf, a[key], specs[key])
    return out


def stage_params(blocks: PyTree, num_stages: int) -> PyTree:
    """Block leaves ``(G, ...)`` as ``(stages, G/S, ...)``."""
    return PT.tree_map(lambda t: t.reshape((num_stages, -1) + tuple(t.shape[1:])), blocks)


def stage_mesh(mesh):
    """The ``(data, model)`` sub-mesh a stage's DTensors live on (the mesh
    axes other than ``pod``), or None where ``pod`` is the only axis."""
    if mesh is None:
        return None
    rest = tuple(a for a in mesh.mesh_dim_names if a != "pod")
    return mesh[rest] if rest else None


def make_pipelined_loss(cfg, mesh, tcfg: TrainConfig | None = None,
                        num_stages: int = NUM_STAGES, lazy: bool = False):
    """``train_step(params, batch) -> (params, loss)`` of the pipelined
    demo: the embedding (before the first stage), ``pipeline_apply`` over
    ``pod`` (each stage ``_apply_group`` over its layer groups under
    ``q_chunk=512, kv_chunk=1024``), the final norm and head, the
    logsumexp loss, and the SGD-style apply at 1e-3.

    ``params["blocks"]`` holds stage-shaped leaves (:func:`stage_params`):
    all ``num_stages`` without a mesh (the Lazy evaluator runs), this
    rank's stages with one (:func:`~repro_torch.core.pipeline.
    local_stages`; the Future evaluator runs across the ``pod`` ranks).
    On a mesh with ``data``/``model`` axes beside ``pod`` the params and
    the batch are DTensors on :func:`stage_mesh`, and the step runs under
    it.  ``tcfg`` overrides the environment's schedule knobs.  ``lazy``
    runs the Lazy evaluator on a mesh too (all the stages on every rank,
    the sub-mesh kept): the step the pipelined one is held to."""
    tcfg = tcfg or _train_config()
    plans = T.block_plans(cfg)
    pcfg = tcfg.pipeline_config(num_stages, axis_name="pod")
    sub = stage_mesh(mesh)

    def stage_fn(stage, x):
        # a stage's input laid out as the residual stream, whichever rank
        # or stage it came from (a no-op without a mesh)
        x = L.constrain_res(x)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for g in range(PT.leaves(stage)[0].shape[0]):
            x, _, _ = T._apply_group(
                T._group(stage, g), x, cfg, plans, positions=positions,
                attn_impl=ATTN, q_chunk=512, kv_chunk=1024,
            )
        return x

    def loss_fn(params, batch):
        x = L.embed_lookup(params["embed"]["embedding"], batch["tokens"])
        x = pipeline_apply(stage_fn, params["blocks"], x, pcfg, mesh=None if lazy else mesh)
        # the residual's layout, whichever evaluator ran
        x = L.constrain_res(x)
        x = T._norm(cfg, params.get("final_norm"), x)
        logits = L.logits(params["head"], params["embed"], x, cfg)
        lse = torch.logsumexp(logits, dim=-1)
        labels = batch["labels"].long()
        vocab_iota = torch.arange(logits.shape[-1], device=labels.device)
        gold = torch.sum(torch.where(vocab_iota == labels[..., None], logits, 0.0), dim=-1)
        return torch.mean(lse - gold)

    def train_step(params, batch):
        flat, treedef = PT.flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        with SH.set_mesh(sub), SH.replicate_plain_tensors(), torch.enable_grad():
            loss = loss_fn(PT.unflatten(treedef, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        new = [p.detach() if g is None else (p - LEARNING_RATE * g.float()).to(p.dtype).detach()
               for p, g in zip(leaves, grads)]
        return PT.unflatten(treedef, new), loss.detach()

    return train_step


def record(arch: str = ARCH, small: bool = SMALL, tcfg: TrainConfig | None = None,
           num_stages: int = NUM_STAGES) -> dict:
    """The demo cell's record, analytically (see the module docstring)."""
    mesh = (AbstractMesh((2, 2, 2), ("pod", "data", "model")) if small
            else make_production_mesh(multi_pod=True))
    tcfg = tcfg or _train_config()
    cfg = get_config(arch).with_overrides(dtype=torch.float32)
    shape = SHAPES[SHAPE]
    if small:
        shape = dataclasses.replace(shape, global_batch=16, seq_len=512)
    a_params = staged_blocks_abstract(cfg, RULES, mesh, num_stages)
    bs, ba = SP.batch_struct(cfg, shape)
    a_batch = SP.sharded(bs, ba, RULES, mesh)
    analytic = AN.step_flops(cfg, shape, remat=True, causal_skip=True)
    pcfg = tcfg.pipeline_config(num_stages)
    autodiff_stash = dataclasses.replace(pcfg, backward="autodiff").peak_stash_items
    m_ = tcfg.num_microbatches
    return {
        "cell": f"{arch}×{SHAPE}×multipod-PIPELINE",
        "mode": f"stream-future pipeline: stages={num_stages} over 'pod', "
                f"microbatches={m_}, schedule={pcfg.schedule}"
                f"x{pcfg.interleave}, backward={pcfg.backward}, bubble="
                f"{pcfg.bubble_fraction:.3f}, peak_stash={pcfg.peak_stash_items}/{m_}",
        "bubble_fraction": pcfg.bubble_fraction,
        "peak_stash_items": pcfg.peak_stash_items,
        "autodiff_peak_stash_items": autodiff_stash,
        "compile_seconds": None,
        "memory_analysis": {
            "argument_size_gib": (SP.local_bytes(a_params) + SP.local_bytes(a_batch)) / 2**30,
            "temp_size_gib": None,
        },
        "hlo_analysis": {
            "hbm_traffic_gib": None,
            "collective_weighted_gib": None,
            "collective_bytes_by_kind": None,
            "top_collectives": None,
        },
        "analytic_flops": analytic["total"],
    }


def main() -> dict:
    rec = record()
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    with open(os.path.join(ARTIFACT_DIR, f"{ARCH}_{SHAPE}_pipeline.json"), "w") as f:
        json.dump(rec, f, indent=2)
    m_ = NUM_MICRO
    print(json.dumps(rec["hlo_analysis"]["collective_bytes_by_kind"], indent=1))
    print(f"pipeline dry run laid out analytically (no compiled module: compile time, "
          f"collective and hbm bytes null); arguments "
          f"{rec['memory_analysis']['argument_size_gib']:.3f} GiB per chip, "
          f"{rec['analytic_flops']:.4e} FLOPs a step")
    print(f"schedule {SCHEDULE}x{INTERLEAVE} backward={BACKWARD}: "
          f"combined-plan stash bound {rec['peak_stash_items']}/{m_} "
          f"microbatches per device "
          f"(autodiff keeps {rec['autodiff_peak_stash_items']}/{m_} live; the bound "
          f"is proven by the plan's stash/release columns and realized "
          f"by a fused executor — see schedules.CombinedPlan)")
    return rec


if __name__ == "__main__":
    main()
