"""Elastic scaling: re-mesh, re-plan the schedule, re-shard on change.

Port of ``repro.train.elastic``.  When a pod is cordoned (hardware
fault) or capacity is added, the job resumes on a different device
count.  Because checkpoints are stored as logical (unsharded) arrays and
shardings are *derived* from the mesh via the logical-axis rules,
elasticity is: build the new mesh -> derive new shardings -> distribute
the restored state.  No resharding code is specific to any topology.

``choose_mesh_shape`` picks the largest (data, model) factorization that
(a) keeps ``model`` a divisor of the preferred TP width and (b) uses every
remaining device for data parallelism; global batch is kept constant by
adjusting ``num_microbatches`` (the stream chunk count -- the paper's
knob again) so per-device microbatch size stays fixed.

``choose_elastic_plan`` goes further for pipelined jobs: the pipeline
schedule is mesh-shape-dependent -- schedule, M and V all move with the
pipeline axis size -- so on node loss it re-runs
:func:`repro_torch.core.chunking.optimal_schedule` against the shrunken
axis instead of only re-deriving the mesh.
"""
from __future__ import annotations

import dataclasses

from repro_torch import pytree as P
from repro_torch.core import chunking
from repro_torch.core.chunking import ScheduleChoice
from repro_torch.parallel import sharding as SH


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    num_microbatches: int
    # Joint (schedule, M, V) re-plan for the pipeline axis; None when the
    # job is not pipelined (pipeline axis of 1).
    schedule: ScheduleChoice | None = None


def choose_mesh_shape(
    num_devices: int, preferred_model: int = 16, global_batch: int = 256,
    per_device_micro_tokens: int | None = None,
) -> ElasticPlan:
    model = preferred_model
    while model > 1 and num_devices % model != 0:
        model //= 2
    data = num_devices // model
    # Keep per-device microbatch constant: more data shards => fewer chunks.
    num_micro = max(1, global_batch // max(data, 1) // 4)
    # num_microbatches must divide the global batch.
    while global_batch % (num_micro) != 0:
        num_micro -= 1
    return ElasticPlan((data, model), ("data", "model"), num_micro)


def choose_elastic_plan(
    num_devices: int,
    *,
    preferred_model: int = 16,
    preferred_pipeline: int = 1,
    global_batch: int = 256,
    work_per_item: float = 1.0,
    per_tick_overhead: float = 1e-4,
    memory_budget_items: float | None = None,
    num_sources: int = 1,
    backward: str = "autodiff",
) -> ElasticPlan:
    """Mesh factorization *and* schedule re-plan for the new device count.

    The pipeline axis shrinks to the largest power-of-two divisor of
    ``num_devices`` at most ``preferred_pipeline``; the remaining devices
    factor into (data, model) as :func:`choose_mesh_shape` does.  With a
    pipeline axis > 1 the (schedule, M, V) triple is re-derived by
    :func:`repro_torch.core.chunking.optimal_schedule` -- on a pod loss
    the optimum genuinely moves, so re-deriving only the mesh silently
    runs the wrong schedule.  ``num_sources`` forwards multi-injection
    feed costs into the memory budget; ``backward`` scores the stash for
    the job's backward mode and defaults to ``"autodiff"`` (``TrainConfig``'s
    default): a job training with the autodiff backward cannot buy memory
    with 1F1B.  Pass ``backward="planned"`` to let the re-plan use the
    combined plans' schedule-level stash bounds.
    """
    pipe = 1
    while pipe * 2 <= preferred_pipeline and num_devices % (pipe * 2) == 0:
        pipe *= 2
    rest = num_devices // pipe
    base = choose_mesh_shape(rest, preferred_model, global_batch)
    if pipe <= 1:
        return ElasticPlan(
            base.mesh_shape + (1,),
            base.axis_names + ("pipe",),
            base.num_microbatches,
            schedule=None,
        )
    # M is constrained to divide the global batch *inside* the search, so
    # the returned choice's modeled time and budget check describe the M
    # the plan actually runs.
    choice = chunking.optimal_schedule(
        work_per_item,
        pipe,
        per_tick_overhead,
        max_chunks=global_batch,
        memory_budget_items=memory_budget_items,
        num_sources=num_sources,
        chunks_divide=global_batch,
        backward=backward,
    )
    return ElasticPlan(
        base.mesh_shape + (pipe,),
        base.axis_names + ("pipe",),
        choice.num_chunks,
        schedule=choice,
    )


def remesh_state(state, layout, rules, new_mesh):
    """Re-shard a (restored) state pytree onto a new mesh: every leaf a
    DTensor laid out by ``param_shardings(layout, rules, new_mesh)``.

    A leaf may be a plain tensor every rank holds whole (a restored
    checkpoint) or a DTensor on another mesh, which is gathered whole
    first (a collective over its own mesh)."""
    shardings = SH.param_shardings(layout, rules, new_mesh)

    def one(x, sharding):
        if SH.is_dtensor(x):
            x = x.full_tensor()
        device = new_mesh.device_type
        return SH.distribute(x.to(device), sharding.mesh, sharding.placements)

    return P.tree_map(one, state, shardings)
