"""Core: the paper's Stream-with-Future construct, in PyTorch.

Public API (the ported part of ``repro.core``):
  Stream, StreamResult — the combinator algebra front door:
    Stream.source(items).map(f).through(cell_fn, states)
          .zip(other, combine).concat(other).mask(pred)
          .collect(evaluator)
    Stream.feedback(init, n, emit) — the unfold combinator: item b
          re-enters as emit(item b - lag)
  LazyEvaluator, FutureEvaluator, evaluate — the monad substitution:
    sequential, or pipelined over stages (CUDA streams on a card)
  StreamGraph IR internals (repro_torch.core.graph): lower_chain,
    ChainProgram, run_chain_sequential
  StreamProgram — deprecated single-chain adapter
  Future, defer, HostFuture, ppermute_future — futures on a side CUDA
    stream, and the pipeline's ring hand-off
  SchedulePlan, build_plan, CombinedPlan, build_combined_plan,
    build_backward_plan — the schedule zoo's tick tables
  PipelineConfig, pipeline_apply, pipeline_evaluator, split_stages,
    merge_stages — layer pipelining: a stack of stages as one Stream
    segment, Lazy or Future (stage streams), autodiff or planned backward
  ChunkPolicy, ScheduleChoice, bubble_fraction, optimal_num_chunks,
    optimal_schedule and the rest of the paper's chunk-size model;
    chunk_axis, unchunk_axis
"""
from repro_torch.core.chunking import (
    ChunkPolicy,
    ScheduleChoice,
    bubble_fraction,
    chunk_axis,
    feed_peak_items,
    optimal_num_chunks,
    optimal_schedule,
    pipeline_step_time,
    schedule_bubble_fraction,
    schedule_peak_items,
    schedule_ticks,
    unchunk_axis,
)
from repro_torch.core.future import Future, HostFuture, defer, ppermute_future
from repro_torch.core.graph import (
    ChainProgram,
    Stream,
    StreamResult,
    lower_chain,
    run_chain_sequential,
)
from repro_torch.core.pipeline import (
    PipelineConfig,
    merge_stages,
    pipeline_apply,
    pipeline_evaluator,
    split_stages,
)
from repro_torch.core.schedules import (
    BACKWARD_MODES,
    SCHEDULES,
    CombinedPlan,
    SchedulePlan,
    build_backward_plan,
    build_combined_plan,
    build_plan,
)
from repro_torch.core.stream import (
    FutureEvaluator,
    LazyEvaluator,
    StreamProgram,
    evaluate,
)

__all__ = [
    "BACKWARD_MODES",
    "ChainProgram",
    "ChunkPolicy",
    "CombinedPlan",
    "Future",
    "FutureEvaluator",
    "HostFuture",
    "LazyEvaluator",
    "PipelineConfig",
    "SCHEDULES",
    "ScheduleChoice",
    "SchedulePlan",
    "Stream",
    "StreamProgram",
    "StreamResult",
    "build_backward_plan",
    "build_combined_plan",
    "bubble_fraction",
    "build_plan",
    "chunk_axis",
    "defer",
    "evaluate",
    "feed_peak_items",
    "lower_chain",
    "optimal_num_chunks",
    "optimal_schedule",
    "merge_stages",
    "pipeline_apply",
    "pipeline_evaluator",
    "pipeline_step_time",
    "ppermute_future",
    "run_chain_sequential",
    "schedule_bubble_fraction",
    "schedule_peak_items",
    "schedule_ticks",
    "split_stages",
    "unchunk_axis",
]
