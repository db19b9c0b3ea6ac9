"""Chunk-size policy -- the paper's §7 proposal, implemented (PyTorch port
of ``repro.core.chunking``).

The paper's evaluation found that fine-grained stream cells do not scale
("the minimum size of elementary computations seems to be a key factor")
and proposed *grouping these in bigger chunks* as future work.  On a
pipeline the trade-off is exact:

* With S stages and M chunks (microbatches), the fill/drain bubble wastes
  ``(S-1)/(M+S-1)`` of the schedule -- more chunks amortize it.
* Each chunk pays a fixed per-cell overhead ``c`` (on a GPU the host's
  kernel launches, which dominate the port's decode rounds); fewer,
  bigger chunks amortize *that*.
* Per-stage memory holds ``O(chunk_bytes)`` in-flight buffers, bounding
  chunk size from above.

``optimal_num_chunks`` minimizes the modeled step time.  The model is
schedule-aware (see :mod:`repro_torch.core.schedules`): tick counts,
bubble fractions and peak in-flight memory are parameterized by
(schedule, interleave, handoff), and :func:`optimal_schedule` picks the
(schedule, M, V) triple jointly under an optional memory budget.  The
closed-form tick count

    T = (V - 1) * max(M, h*S) + M + h*(S - 1)

is exact against the plans ``schedules.build_plan`` emits; ``h`` is the
hand-off latency -- 1 for a textbook synchronous pipeline, 2 for the
evaluator's issue-early/force-late ring.

Every function is host arithmetic, the reference's closed form number
for number (the feed and stash terms model the reference's mesh
executors; on one card the port's ``FutureEvaluator`` reads a source
item directly and keeps no carousel).  Also the reshapes the paper's
algorithms use to cut a stream into items: :func:`chunk_axis` /
:func:`unchunk_axis`.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch import pytree as P
from repro_torch.core.schedules import (
    DEFAULT_HANDOFF,
    feed_items_per_source,
    peak_inflight_items,
    validate_schedule,
)


def bubble_fraction(num_stages: int, num_chunks: int) -> float:
    """Fill/drain bubble fraction of a linear pipeline (GPipe forward)."""
    if num_stages <= 1:
        return 0.0
    return (num_stages - 1) / (num_chunks + num_stages - 1)


def schedule_ticks(
    schedule: str,
    num_stages: int,
    num_chunks: int,
    interleave: int = 1,
    handoff: int = DEFAULT_HANDOFF,
) -> int:
    """Tick count of ``schedule`` — matches ``build_plan(...).num_ticks``.

    ``num_stages`` is the *device* count S of the pipeline axis; the
    interleaved schedule runs S*V virtual stages.  Exact for S >= 2 (and
    for V == 1 always); the degenerate S == 1, V > 1 self-ring is not
    modeled.
    """
    v = validate_schedule(schedule, interleave)
    s, m, h = num_stages, num_chunks, handoff
    if s <= 1:
        return v * m
    return (v - 1) * max(m, h * s) + m + h * (s - 1)


def schedule_bubble_fraction(
    schedule: str,
    num_stages: int,
    num_chunks: int,
    interleave: int = 1,
    handoff: int = DEFAULT_HANDOFF,
) -> float:
    """Idle fraction of the (ticks x stages) grid under ``schedule``.

    Interleaving divides per-tick work by V while fill/drain stays
    ``h*(S-1)`` ticks, so the bubble falls from ``h(S-1)/(M + h(S-1))``
    to ``h(S-1)/(V*M + h(S-1))`` — the engine's reason to exist.
    """
    v = validate_schedule(schedule, interleave)
    if num_stages <= 1:
        return 0.0
    ticks = schedule_ticks(schedule, num_stages, num_chunks, interleave, handoff)
    return 1.0 - (v * num_chunks) / ticks


def schedule_peak_items(
    schedule: str,
    num_stages: int,
    num_chunks: int,
    interleave: int = 1,
    num_sources: int = 1,
    backward: str = "planned",
) -> int:
    """Peak per-device activation stash (in microbatches) — the
    schedule's memory term (delegates to the single definition in
    :mod:`repro_torch.core.schedules`).

    ``backward="planned"`` (default) is the combined plan's own peak —
    the *schedule-level* bound proven by its stash/release columns
    (:class:`repro_torch.core.schedules.CombinedPlan`; the planned
    backward, ``FutureEvaluator(backward="planned")``, realises
    ``V*M`` at its phase boundary, as the reference's does);
    ``backward="autodiff"`` charges the ``V*M`` that differentiating the
    forward ticks keeps live for *every* schedule.  ``num_sources >
    1`` adds the extra sources' feed storage (multi-injection plans:
    one round-robin shard plus one carousel register per extra
    source)."""
    return peak_inflight_items(
        schedule, num_stages, num_chunks, interleave, num_sources, backward
    )


def feed_peak_items(
    num_stages: int, num_chunks: int, num_sources: int = 1
) -> int:
    """Per-device item-feed storage of a multi-injection plan, in items.

    Each source keeps its local round-robin shard (``ceil(M/S)`` items)
    plus the one in-flight carousel register that rotates on the reverse
    ring.  Tick count and bubble are *unchanged* by extra injections —
    the plan tables are position-oblivious (tested against
    ``build_plan(..., inject_positions=...)``); feeds are the only term
    that scales with source count.
    """
    if num_sources < 1 or num_stages < 1 or num_chunks < 1:
        raise ValueError(
            f"need num_sources/num_stages/num_chunks >= 1, got "
            f"{num_sources}/{num_stages}/{num_chunks}"
        )
    return num_sources * feed_items_per_source(num_stages, num_chunks)


def pipeline_step_time(
    work_per_item: float,
    num_stages: int,
    num_chunks: int,
    per_tick_overhead: float,
    schedule: str = "gpipe",
    interleave: int = 1,
    handoff: int = 1,
    per_tick_copy: float = 0.0,
) -> float:
    """Modeled wall time of pipelining `work_per_item` split into chunks.

    ``work_per_item`` is the total serial compute time of one full item
    through all stages; each tick costs the slowest stage's group compute
    (``work / (S*M*V)``) plus a fixed overhead.  The default
    (gpipe, V=1, h=1) reproduces the classic ``(M+S-1)(W/(S M) + c)``;
    pass ``handoff=schedules.DEFAULT_HANDOFF`` to model the Future
    engine's overlapped ring (whose per-tick overhead is what is left
    after the permute hides under the cell scan).

    ``per_tick_copy`` is the mutable-state traffic term: the time a tick
    spends writing per-cell state back (KV-cache updates for a serving
    chain — see :func:`copy_time_per_tick` for the bytes→time
    conversion).  It is kept separate from ``per_tick_overhead`` because
    it scales with the *state update scheme* (a whole-slab write-back
    per microbatch is ``max_len``× a row-level scatter), which is how
    the model distinguishes the two serving hot paths.
    """
    v = validate_schedule(schedule, interleave)
    ticks = schedule_ticks(schedule, num_stages, num_chunks, interleave, handoff)
    per_tick_compute = work_per_item / (num_stages * num_chunks * v)
    return ticks * (per_tick_compute + per_tick_overhead + per_tick_copy)


def copy_time_per_tick(
    copy_bytes_per_tick: float, copy_bytes_per_second: float
) -> float:
    """Bytes a tick writes back into mutable per-cell state → seconds.

    The single conversion site for the copy-bytes term: callers (the
    serving engine's :func:`repro_torch.serve.engine.decode_copy_bytes_per_tick`)
    supply measured/modeled bytes and the device's effective write
    bandwidth.
    """
    if copy_bytes_per_second <= 0:
        raise ValueError(
            f"copy_bytes_per_second must be > 0, got {copy_bytes_per_second}"
        )
    return copy_bytes_per_tick / copy_bytes_per_second


def optimal_num_chunks(
    work_per_item: float,
    num_stages: int,
    per_tick_overhead: float,
    max_chunks: int = 4096,
    schedule: str = "gpipe",
    interleave: int = 1,
    handoff: int = 1,
    per_tick_copy: float = 0.0,
) -> int:
    """Minimize modeled step time over the number of chunks M.

    Closed form of d/dM [ (VM + h(S-1))(W/(S·M·V) + c) ] = 0:
        M* = sqrt( h W (S-1) / (S c) ) / V
    (gpipe, h=1 reduces to the paper-era ``sqrt(W(S-1)/(S c))``),
    refined by evaluating integer neighbors so the kink at M = h*S in
    the interleaved tick count is respected.  Clipped to
    [1, max_chunks].  When overhead dominates (paper's primes case)
    M* -> 1: don't pipeline fine-grained work.  ``per_tick_copy`` joins
    ``c`` in the closed form (both are fixed per-tick costs), so heavy
    state write-back pushes toward fewer, bigger chunks — and shrinking
    it (the row-scatter path) buys chunks back.
    """
    v = validate_schedule(schedule, interleave)
    per_tick_fixed = per_tick_overhead + per_tick_copy
    if num_stages <= 1 or per_tick_fixed <= 0:
        return max_chunks
    m_star = (
        math.sqrt(
            handoff
            * work_per_item
            * (num_stages - 1)
            / (num_stages * per_tick_fixed)
        )
        / v
    )
    candidates = {
        max(1, min(max_chunks, m))
        for m in (
            math.floor(m_star),
            math.ceil(m_star),
            handoff * num_stages,
            1,
            max_chunks,
        )
        if m >= 1
    }
    return min(
        candidates,
        key=lambda m: (
            pipeline_step_time(
                work_per_item,
                num_stages,
                m,
                per_tick_overhead,
                schedule,
                interleave,
                handoff,
                per_tick_copy,
            ),
            m,
        ),
    )


@dataclasses.dataclass(frozen=True)
class ScheduleChoice:
    """Joint (schedule, M, V) decision from :func:`optimal_schedule`."""

    schedule: str
    num_chunks: int
    interleave: int
    modeled_time: float
    bubble: float
    peak_items: int


def optimal_schedule(
    work_per_item: float,
    num_stages: int,
    per_tick_overhead: float,
    *,
    max_chunks: int = 4096,
    interleave_options: tuple[int, ...] = (1, 2, 4),
    memory_budget_items: float | None = None,
    handoff: int = DEFAULT_HANDOFF,
    num_sources: int = 1,
    chunks_divide: int | None = None,
    backward: str = "autodiff",
    per_tick_copy: float = 0.0,
) -> ScheduleChoice:
    """Pick (schedule, M, V) jointly: minimize modeled step time subject
    to a peak-activation budget.

    ``per_tick_copy`` is the per-tick mutable-state write-back time (see
    :func:`pipeline_step_time` / :func:`copy_time_per_tick`) — the
    serving engines' copy-bytes term.  Because it is a fixed tick cost,
    it penalizes exactly the schedules that multiply tick count
    (interleaving's V× ticks buy less when every tick pays the copy),
    which is why the joint pick must see it.

    ``memory_budget_items`` caps ``schedule_peak_items(...) / M`` — peak
    stash measured in units of the *whole* item's activation footprint
    (gpipe always costs exactly 1.0; 1F1B costs S/M once M > S, which is
    how it buys bigger M under a budget).  ``None`` means unconstrained.
    ``backward`` selects whose stash is scored, and must match the
    job's actual execution mode.  ``"autodiff"`` (default) charges
    every schedule the full ``V*M`` that
    differentiating the forward ticks keeps live, under which no
    schedule buys memory and a tight budget is simply infeasible — the
    honest answer for a default-configured job.  ``"planned"`` scores
    each schedule's combined-plan peak — 1F1B's ``min(S, M)`` advantage,
    the plan's bound under ``FutureEvaluator(backward="planned")``
    (whose two-phase realisation still holds ``V*M`` at the phase
    boundary, as the reference's does).  (The *descriptive*
    :func:`schedule_peak_items` keeps ``"planned"`` as its default: it
    characterizes the schedule itself; this function makes a decision
    against a budget, so it defaults conservative.)
    ``num_sources > 1`` charges multi-injection feed storage against the
    same budget (more sources push toward schedules that stash less).
    ``chunks_divide`` restricts M to divisors of it (a global batch must
    chunk evenly) — the constraint belongs *inside* the search, so the
    returned choice's M, modeled time and budget check all describe the
    schedule that actually runs.
    """
    grid: list[tuple[str, int]] = [("gpipe", 1), ("one_f_one_b", 1)]
    grid += [("interleaved", v) for v in interleave_options if v > 1]
    divisors = None
    if chunks_divide is not None:
        divisors = [
            d
            for d in range(1, min(chunks_divide, max_chunks) + 1)
            if chunks_divide % d == 0
        ]
    best: ScheduleChoice | None = None
    for name, v in grid:
        m0 = optimal_num_chunks(
            work_per_item, num_stages, per_tick_overhead, max_chunks, name, v,
            handoff, per_tick_copy,
        )
        # scan a neighborhood: the memory constraint may push M up past
        # the unconstrained optimum (more, smaller chunks stash less).
        seen = sorted(
            {
                max(1, min(max_chunks, m))
                for m in (
                    m0,
                    m0 // 2,
                    m0 * 2,
                    num_stages,
                    handoff * num_stages,
                    max_chunks,
                )
            }
        )
        if divisors is not None:
            # snap every candidate to its neighboring divisors
            snapped = set()
            for m in seen:
                snapped.add(max((d for d in divisors if d <= m), default=1))
                snapped.add(min((d for d in divisors if d >= m), default=divisors[-1]))
            seen = sorted(snapped)
        for m in seen:
            if memory_budget_items is not None:
                peak = (
                    schedule_peak_items(
                        name, num_stages, m, v, num_sources, backward
                    )
                    / m
                )
                if peak > memory_budget_items:
                    continue
            t = pipeline_step_time(
                work_per_item, num_stages, m, per_tick_overhead, name, v,
                handoff, per_tick_copy,
            )
            cand = ScheduleChoice(
                schedule=name,
                num_chunks=m,
                interleave=v,
                modeled_time=t,
                bubble=schedule_bubble_fraction(name, num_stages, m, v, handoff),
                peak_items=schedule_peak_items(
                    name, num_stages, m, v, num_sources, backward
                ),
            )
            if best is None or cand.modeled_time < best.modeled_time:
                best = cand
    if best is None:
        raise ValueError(
            "no (schedule, M) fits memory_budget_items="
            f"{memory_budget_items} at num_stages={num_stages}"
        )
    return best


@dataclasses.dataclass(frozen=True)
class ChunkPolicy:
    """Static chunking decision for a stream axis (items or sequence)."""

    num_chunks: int
    chunk_size: int

    @staticmethod
    def for_axis(axis_len: int, num_chunks: int) -> "ChunkPolicy":
        if axis_len % num_chunks != 0:
            raise ValueError(f"{axis_len=} not divisible by {num_chunks=}")
        return ChunkPolicy(num_chunks, axis_len // num_chunks)


def _replicated_on(x, dims):
    """``x`` with any DTensor placement that shards one of ``dims``
    replaced by a replica (exact data movement); other tensors as they
    are."""
    from repro_torch.parallel.sharding import is_dtensor

    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    pl = [Replicate() if isinstance(p, Shard) and p.dim in dims else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)


def chunk_axis(tree, num_chunks: int, axis: int = 0):
    """Reshape leading `axis` of every leaf into (num_chunks, chunk, ...)."""

    def _chunk(x):
        if x.shape[axis] % num_chunks != 0:
            raise ValueError(
                f"axis {axis} of shape {tuple(x.shape)} not divisible by {num_chunks}"
            )
        new_shape = (
            tuple(x.shape[:axis])
            + (num_chunks, x.shape[axis] // num_chunks)
            + tuple(x.shape[axis + 1 :])
        )
        x = x.reshape(new_shape)
        if axis != 0:
            x = x.movedim(axis, 0)
        return x

    return P.tree_map(_chunk, tree)


def unchunk_axis(tree, axis: int = 0):
    """Inverse of :func:`chunk_axis`.  A DTensor sharded on either of the
    two dims merged is replicated on it first: the merged dim's shards
    would interleave, and DTensor (torch 2.11) refuses that view."""

    def _unchunk(x):
        if axis != 0:
            x = x.movedim(0, axis)
        x = _replicated_on(x, (axis, axis + 1))
        new_shape = tuple(x.shape[:axis]) + (-1,) + tuple(x.shape[axis + 2 :])
        return x.reshape(new_shape)

    return P.tree_map(_unchunk, tree)
