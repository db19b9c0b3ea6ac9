"""Layer-pipeline parallelism as a Stream-with-Future program (PyTorch).

Port of ``repro.core.pipeline``.  A transformer's layer stack *is* a
stream: cell = group of layers, item = microbatch of activations.  Run
under :class:`~repro_torch.core.stream.FutureEvaluator`, microbatches
pipeline over D stages of one device -- on a card, D CUDA streams --
under a pluggable schedule:

* ``gpipe`` -- fill/drain, bubble ``h(S-1)/(M + h(S-1))``;
* ``one_f_one_b`` -- 1F1B: under ``backward="planned"`` the combined
  plan interleaves F and B units and bounds the stash at ``min(S, M)``
  microbatches instead of ``M``;
* ``interleaved`` -- each stage owns ``interleave`` non-contiguous layer
  groups, bubble ``h(S-1)/(V·M + h(S-1))``.

The backward is pluggable too (``PipelineConfig.backward``): with
``"autodiff"`` autograd differentiates the eager tick loop, with
per-(cell, item) recomputation when ``remat=True``; with ``"planned"``
the backward is the combined plan's B units, replayed on the same stage
streams (bitwise-equal gradients; group-level recomputation is
inherent).

Two placements of the stages: ``stages=D`` runs the Future evaluator on
D stage streams of one device, as the port's ``StreamEngine`` does;
``mesh=`` (a ``DeviceMesh``, the reference's argument) runs it across
the ranks of the mesh axis ``config.axis_name``, each rank holding only
its own stages (its virtual stages ``v*D + d`` back to back, see
:func:`local_stages`) and the hops crossing ranks by p2p.  With neither,
the Lazy evaluator runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch import pytree as P
from repro_torch.core import chunking
from repro_torch.core.graph import Stream
from repro_torch.core.stream import FutureEvaluator, LazyEvaluator

PyTree = Any
StageFn = Callable[[PyTree, PyTree], PyTree]  # (stage_params, x) -> y


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    num_stages: int = 1
    num_microbatches: int = 1
    axis_name: str = "pod"
    remat: bool = True
    # Pipeline schedule: "gpipe", "one_f_one_b", or "interleaved".  With
    # "interleaved", each stage owns `interleave` non-contiguous stage
    # groups; num_stages must stay divisible by (stages * interleave).
    schedule: str = "gpipe"
    interleave: int = 1
    # How gradients flow through the pipeline: "autodiff" differentiates
    # the forward tick loop; "planned" runs the combined plan's B units
    # as scheduled work (bitwise-equal gradients) -- see
    # repro_torch.core.schedules.build_combined_plan.
    backward: str = "autodiff"

    def __post_init__(self):
        from repro_torch.core.schedules import validate_backward, validate_schedule

        validate_schedule(self.schedule, self.interleave)
        validate_backward(self.backward)
        if self.num_stages % self.interleave != 0:
            raise ValueError(
                f"num_stages={self.num_stages} not divisible by "
                f"interleave={self.interleave}"
            )

    @property
    def bubble_fraction(self) -> float:
        """Modelled bubble under this config's schedule (``num_stages``
        used as the stage count, a synchronous h=1 hand-off: the classic
        figure; the evaluator's plan is the ground truth:
        ``FutureEvaluator.plan_for(M).bubble_fraction``)."""
        return chunking.schedule_bubble_fraction(
            self.schedule,
            self.num_stages // self.interleave,
            self.num_microbatches,
            self.interleave,
            handoff=1,
        )

    @property
    def peak_stash_items(self) -> int:
        """Peak concurrently-stashed activations (in microbatches) per
        stage under this config's backward mode: the combined plan's own
        stash bound for "planned", the ``V*M`` that differentiating the
        forward ticks keeps for "autodiff"."""
        return chunking.schedule_peak_items(
            self.schedule,
            self.num_stages // self.interleave,
            self.num_microbatches,
            self.interleave,
            backward=self.backward,
        )


def pipeline_evaluator(
    config: PipelineConfig, stages: int | None = None, mesh=None, **kwargs
) -> LazyEvaluator | FutureEvaluator:
    """The evaluator :func:`pipeline_apply` runs: Lazy for ``stages``
    and ``mesh`` None (or one stage), else the Future evaluator on
    ``stages`` stage streams, or across the ranks of ``mesh``'s axis
    ``config.axis_name``, under the config's schedule and backward
    (``kwargs``, e.g. ``time_units=True``, go to it)."""
    if (stages is None and mesh is None) or config.num_stages == 1:
        return LazyEvaluator()
    return FutureEvaluator(
        stages,
        config.axis_name,
        schedule=config.schedule,
        interleave=config.interleave,
        backward=config.backward,
        mesh=mesh,
        local_cells=mesh is not None,
        **kwargs,
    )


def pipeline_apply(
    stage_fn: StageFn,
    stage_params: PyTree,
    x: PyTree,
    config: PipelineConfig,
    stages: int | None = None,
    evaluator: LazyEvaluator | FutureEvaluator | None = None,
    mesh=None,
) -> PyTree:
    """Run ``x`` through ``num_stages`` stages of ``stage_fn``.

    ``stage_params`` leaves have leading axis ``num_stages``.  ``x``
    leaves have leading axis global-batch, chunked into
    ``num_microbatches`` items.  With ``stages`` given, the stages are
    pipelined over that many stage streams under ``config.schedule``
    (Future); with ``mesh`` given, over the ranks of its axis
    ``config.axis_name``, and ``stage_params`` are then this rank's
    stages only (leading axis ``num_stages / D``, :func:`local_stages`);
    otherwise evaluated sequentially (Lazy).  Results are identical for
    every schedule and backward, on every rank.  ``evaluator`` (one
    :func:`pipeline_evaluator` made, to read its unit times) replaces
    the one ``stages`` and ``mesh`` name.

    Routed through the StreamGraph IR: the stage stack is one algebra
    segment, so model code composes with ``map``/``zip``-built streams.
    """
    items = chunking.chunk_axis(x, config.num_microbatches)
    if evaluator is None:
        evaluator = pipeline_evaluator(config, stages, mesh)
    ranked = getattr(evaluator, "mesh", None) is not None
    if ranked and not evaluator.local_cells:
        raise ValueError("pipeline_apply across ranks takes this rank's stages: its evaluator "
                         "needs local_cells=True (pipeline_evaluator gives it)")
    stream = Stream.source(items).through(
        lambda params, xb: (params, stage_fn(params, xb)),
        stage_params,
        num_cells=config.num_stages // evaluator.num_stages if ranked else config.num_stages,
        mutable_state=False,
        remat=config.remat,
    )
    out = stream.collect(evaluator).items
    return chunking.unchunk_axis(out)


def local_stages(stage_params: PyTree, config: PipelineConfig, mesh) -> PyTree:
    """This rank's stages of ``stage_params`` (leading axis
    ``num_stages``) for :func:`pipeline_apply` across ``mesh``'s axis
    ``config.axis_name``: rank d's virtual stages ``v*D + d``, ``v <
    interleave``, back to back (for ``interleave`` 1, its contiguous
    share of the stage axis)."""
    return FutureEvaluator(axis_name=config.axis_name, schedule=config.schedule,
                           interleave=config.interleave, mesh=mesh,
                           local_cells=True).local_rows(stage_params)


def split_stages(layer_params: PyTree, num_layers: int, num_stages: int) -> PyTree:
    """Regroup per-layer stacked params (L, ...) into (num_stages, L/S, ...)."""
    if num_layers % num_stages != 0:
        raise ValueError(f"{num_layers=} not divisible by {num_stages=}")
    per = num_layers // num_stages

    def _split(p):
        return p.reshape((num_stages, per) + tuple(p.shape[1:]))

    return P.tree_map(_split, layer_params)


def merge_stages(stage_params: PyTree) -> PyTree:
    """Inverse of :func:`split_stages`."""
    return P.tree_map(lambda p: p.reshape((-1,) + tuple(p.shape[2:])), stage_params)
