"""Pipeline schedules as data: per-tick (stage, microbatch, group) plans.

A numpy-only copy of ``repro.core.schedules`` (the port imports nothing
of the JAX package): the same functions give the same tables, array for
array.  The text below names the JAX package's executor
(``FutureEvaluator``, its ``lax.scan`` over ticks and ``ppermute``
ring), whose port executes these plans.


The Future evaluator (:mod:`repro.core.stream`) is a plan *executor*: it
runs a ``lax.scan`` whose per-tick behaviour — which microbatch each
device works on, which of its local cell groups it applies, where its
input comes from (fresh injection vs. a received in-flight buffer slot),
and whether its output is a final result — is read from host-built int32
tables.  A :class:`SchedulePlan` is those tables plus the buffer-slot and
item-feed bookkeeping the executor needs.  Building plans on the host
keeps the device program schedule-oblivious: new schedules are new table
functions, not new evaluators.

Three schedules ship:

``gpipe``
    Fill/drain.  Stage ``s`` runs microbatch ``m`` at tick
    ``h*s + m`` where ``h`` is the hand-off latency (2 for the
    issue-early/force-late ring used by the evaluator).  Peak in-flight
    activation stash under autodiff training: all ``M`` microbatches.

``one_f_one_b``
    1F1B.  The *executed forward* plan is tick-identical to GPipe (the
    backward is derived by ``jax.grad``, which reverses the forward
    scan; true interleaved F/B execution would need a hand-written VJP
    pipeline — an open item).  What differs is the modeled training
    schedule: steady-state activation stash is ``min(S, M)``
    microbatches instead of ``M``, which is what
    :func:`repro.core.chunking.optimal_schedule` uses to admit larger
    ``M`` under a memory budget.

``interleaved``
    Each device owns ``V`` non-contiguous cell groups (virtual stages;
    global virtual stage ``p`` lives on device ``p % D``).  Per-tick
    work shrinks by ``V`` while the fill/drain tick count stays
    ``h*(D-1)``, cutting the bubble from ``h(D-1)/(M + h(D-1))`` to
    ``h(D-1)/(V*M + h(D-1))`` — Megatron-style interleaving expressed
    as a stream-of-futures plan.  The hand-off stays a single ring
    ``ppermute`` because consecutive virtual stages always sit on
    ring-adjacent devices (``p+1`` lives on ``(d+1) % D``).

Plans are built by a greedy list scheduler (priority: lowest microbatch,
then deepest virtual stage) under two constraints: a device runs one
unit per tick, and unit ``(p, m)`` may start ``handoff`` ticks after
``(p-1, m)`` finished.  For ``M >= D`` this achieves the closed-form
tick counts above; the plan's own ``num_ticks``/``bubble_fraction`` are
always the ground truth (and are tested against the analytic model).

**Feedback (persistent) plans** — ``feedback_lag=L`` adds the unfold
combinator's dependency: item ``b``'s entry unit ``(0, b)`` (for
``b >= L``) becomes ready only ``handoff`` ticks after the *last*
virtual stage finished item ``b - L``.  Only the first ``L`` items are
fed from the primary source's carousel; every later item re-enters from
its own output, carried by the same one-hop ring (the last virtual
stage always lives on device D-1, whose ring successor is device 0) and
parked in the same interval-colored in-flight buffers until its entry
tick.  The resulting plan is *persistent*: after the initial fill it
reaches a steady state with no per-step fill/drain — the serving
engine's continuous-batching decode, where the feed carousel keeps
admitting the stream's own next steps (and, via an entry-zip overlay
source, freshly prefilled requests into retired slots) tick after tick.
With ``L >= handoff * D`` (e.g. 8 in-flight microbatches on 4 devices)
the steady state is bubble-free.

**Combined (training) plans** — :func:`build_combined_plan` schedules
the backward pass as first-class units in the *same* tick table instead
of leaving it to whatever ``jax.grad`` derives from the forward plan.
Unit kinds are ``F`` (forward), ``B`` (backward) and — with
``split_backward=True`` — ``W`` (weight grad, the zero-bubble 3-way
split; see ``UNIT_F``/``UNIT_B``/``UNIT_W``).  Under ``one_f_one_b``
``build_combined_plan`` interleaves F and B in true 1F1B order by capping each
device's live activation stash, so the plan's own stash/release columns
bound peak concurrently-stashed activations at ``V * min(S, M)`` items
(``min(S, M)`` for the plain V=1 schedule) versus ``M`` for gpipe's
fill-then-drain.  The executed realization is
``FutureEvaluator(..., backward="planned")`` — see
:class:`CombinedPlan` for how the plan's combined schedule relates to
the custom-VJP two-phase execution.

The tick-plan column contract
=============================

This section is the single normative description of the tables a
:class:`SchedulePlan` hands to the executor
(:class:`repro.core.stream.FutureEvaluator`); the executor's and
chunking model's docstrings refer here instead of restating it.
All tables have shape ``(num_ticks, num_stages)`` and are consumed as
``lax.scan`` xs rows, except the feed columns, which are tick-indexed
(``(num_sources, num_ticks)``).

Per-device unit columns
    ``microbatch[t, d]`` is the item device ``d`` advances at tick
    ``t`` (-1 = idle; idle ticks still run the ring send, and their
    outputs are never stored or collected).  ``group[t, d]`` selects
    which of the device's ``V`` local cell groups applies (virtual
    stage ``group * D + d``).  ``collect[t, d]`` marks final-position
    units: the produced item is a result (written to the last device's
    output block) and, under feedback, also the value that re-enters
    the chain.

Hand-off columns (the in-flight ring buffers)
    A value computed at tick ``t`` on device ``d`` is ppermute'd during
    tick ``t+1`` (overlapping that tick's compute — the Future) and is
    consumable on device ``(d+1) % D`` at ``t+2`` (= ``handoff``).
    ``recv_slot[t, d]`` says where the value *arriving* at tick ``t``
    is parked (-1 = discard); ``read_slot[t, d]`` says which parked
    slot this tick's unit consumes (-1 = the input is a fresh
    injection from the feed registers instead).  Slots are per-device
    interval-graph colors (:func:`_allocate_slots`), so ``num_slots``
    is exactly the peak number of concurrently in-flight hand-offs.

Feed columns (one carousel per source)
    Source ``s`` is round-robin sharded over the stage axis with
    rotation offset ``inject_devices[s]`` and circulates one register
    per device on the reverse ring.  ``src_feed_reload[s, t]`` = load
    the local shard row ``src_feed_idx[s, t]`` into the register;
    ``src_feed_advance[s, t]`` = rotate the ring one hop after this
    tick; ``src_consume[s, t]`` = the register on device
    ``inject_devices[s]`` is merged into the flow this tick (for the
    primary source that *is* the unit input; for zip sources it is
    combined in).  Reloads happen every D-th consumption.

Feedback arcs
    Under ``feedback_lag=L`` the final position's output is itself a
    hand-off: it rides the same one-hop ring (device D-1 → 0) into a
    device-0 slot recorded in ``recv_slot``, and the entry unit
    ``(0, m)`` for ``m >= L`` has ``read_slot >= 0`` — a fed-back
    entry — instead of a carousel consume.

Emit placement (feedback plans only)
    ``emit[t, d]`` marks the units whose produced item must pass
    through the feedback ``emit`` (final-norm → logits → sample →
    re-embed for a decode chain) before being collected and handed
    back on the ring.  It equals ``collect`` on feedback plans and is
    all-zero otherwise, but is a separate column on purpose: emit
    placement is part of the plan contract, and ``build_plan`` guarantees
    ``emit`` is nonzero **only on the device owning the final virtual
    stage** (device D-1 — virtual stage ``D*V - 1`` lives there).
    That is the plan-level half of the last-stage-only emit split: the
    executor keys the emit region off this column, so the LM head is
    structurally confined to one device's conditional region and the
    other D-1 devices' tick bodies never execute it (HLO-asserted in
    the serving tests).

Stash/release columns (combined plans only)
    :class:`CombinedPlan` adds ``stash_slot[t, d]`` (the per-device
    stash color an F unit's input activation is saved into; -1
    elsewhere) and ``release_slot[t, d]`` (the color freed once the
    matching B — or W, when split — unit has consumed it).  Colors are
    the same smallest-free interval allocation as the hand-off slots,
    so ``num_stash_slots`` equals the peak number of concurrently
    stashed activations; :meth:`CombinedPlan.peak_stash_items` recomputes
    that peak directly from the columns.
"""
from __future__ import annotations

import dataclasses

import numpy as np

SCHEDULES = ("gpipe", "one_f_one_b", "interleaved")

# How the training backward pass is executed against a forward plan:
# "autodiff" lets jax.grad transpose the forward tick scan (every
# schedule then stashes all V*M unit inputs per device); "planned" runs
# the combined plan's B units through the custom-VJP executor
# (FutureEvaluator(backward="planned")), whose schedule-level stash is
# the combined plan's own peak.  Canonical home of the mode names —
# configs.base re-exports them.
BACKWARD_MODES = ("autodiff", "planned")

# Unit kinds of a combined plan's tick table.
UNIT_F, UNIT_B, UNIT_W = 0, 1, 2


def validate_backward(mode: str) -> str:
    if mode not in BACKWARD_MODES:
        raise ValueError(
            f"unknown backward mode {mode!r}; expected one of {BACKWARD_MODES}"
        )
    return mode

# Hand-off latency of the evaluator's issue-early/force-late ring: an
# output computed at tick t is ppermute'd *during* tick t+1 (overlapping
# that tick's compute) and consumable at tick t+2.
DEFAULT_HANDOFF = 2


@dataclasses.dataclass(frozen=True)
class SchedulePlan:
    """Host-built tick tables for one (schedule, D, M, V) instance.

    Column semantics are defined once, in "The tick-plan column
    contract" section of this module's docstring — per-device unit
    columns (``microbatch``/``group``/``collect``), hand-off slots
    (``read_slot``/``recv_slot``/``num_slots``), per-source feed
    carousels (``src_feed_reload``/``src_feed_idx``/
    ``src_feed_advance``/``src_consume``, with ``inject``/``feed_*``
    aliasing source 0), and feedback arcs.  ``inject_positions`` /
    ``inject_devices`` give each source's virtual-stage position and
    consuming device.
    """

    name: str
    num_stages: int
    num_microbatches: int
    interleave: int
    handoff: int
    num_ticks: int
    microbatch: np.ndarray
    group: np.ndarray
    read_slot: np.ndarray
    recv_slot: np.ndarray
    collect: np.ndarray
    inject: np.ndarray
    feed_reload: np.ndarray
    feed_idx: np.ndarray
    feed_advance: np.ndarray
    num_slots: int
    inject_positions: tuple[int, ...] = (0,)
    inject_devices: tuple[int, ...] = (0,)
    src_feed_reload: np.ndarray | None = None
    src_feed_idx: np.ndarray | None = None
    src_feed_advance: np.ndarray | None = None
    src_consume: np.ndarray | None = None
    # Unfold/feedback plans: item b >= feedback_lag re-enters from item
    # b - feedback_lag's final output; only the first feedback_lag items
    # are primary-source fed.  None = ordinary feed-forward plan.
    feedback_lag: int | None = None
    # Emit placement (see the column contract): == collect on feedback
    # plans, all-zero otherwise; nonzero only on the final-stage device.
    emit: np.ndarray | None = None

    @property
    def num_sources(self) -> int:
        return len(self.inject_positions)

    @property
    def bubble_fraction(self) -> float:
        """Idle fraction of the (ticks x devices) grid — measured, not modeled."""
        busy = int((self.microbatch >= 0).sum())
        return 1.0 - busy / (self.num_ticks * self.num_stages)

    @property
    def peak_inflight_items(self) -> int:
        """Modeled peak per-device activation stash (microbatches) under
        the schedule's own (planned-backward) combined plan — the
        schedule's memory term; see :func:`peak_inflight_items` for the
        autodiff-mode variant."""
        return peak_inflight_items(
            self.name,
            self.num_stages,
            self.num_microbatches,
            self.interleave,
            num_sources=self.num_sources,
        )


def peak_inflight_items(
    name: str,
    num_stages: int,
    num_microbatches: int,
    interleave: int = 1,
    num_sources: int = 1,
    backward: str = "planned",
) -> int:
    """Peak per-device activation stash (microbatches) under training.
    Single source of truth — chunking.schedule_peak_items and
    SchedulePlan.peak_inflight_items both delegate here.

    ``backward="planned"`` scores the schedule's *own* combined plan
    (:func:`build_combined_plan`): gpipe fill-then-drain stashes every
    unit input (``V*M``); 1F1B's interleaved F/B steady state holds at
    most ``min(S, M)``; interleaved holds ``V * min(S, M)``.  These
    closed forms are exact against the combined plans' stash/release
    columns (tested over the grid).  ``backward="autodiff"`` is the
    degraded truth of letting ``jax.grad`` transpose the forward scan:
    the fwd/bwd phase boundary keeps **all** ``V*M`` unit inputs live
    regardless of schedule name — before the planned backward existed,
    1F1B's ``min(S, M)`` was a modeling assumption the execution never
    realized.

    Every source past the first adds its feed storage — a local
    round-robin shard of ceil(M/S) items plus the one-item carousel
    register — measured in the same whole-item unit (the primary
    source's feed predates this model and is treated as part of the
    input batch, not the schedule's stash).
    """
    v = validate_schedule(name, interleave)
    validate_backward(backward)
    feed = (num_sources - 1) * feed_items_per_source(num_stages, num_microbatches)
    if backward == "autodiff":
        return v * num_microbatches + feed
    if name == "one_f_one_b":
        return min(num_microbatches, num_stages) + feed
    if name == "interleaved":
        return min(v * num_microbatches, num_stages * v) + feed
    return num_microbatches + feed


def feed_items_per_source(num_stages: int, num_microbatches: int) -> int:
    """Per-device feed storage of ONE source, in items: its local
    round-robin shard (``ceil(M/D)``) plus the in-flight carousel
    register.  The single formula site — ``peak_inflight_items`` and
    ``chunking.feed_peak_items`` both delegate here."""
    return -(-num_microbatches // max(num_stages, 1)) + 1


def _allocate_slots(work, finish, num_stages: int, num_positions: int,
                    feedback_lag: int | None = None, num_items: int = 0):
    """Interval-graph coloring of in-flight hand-offs via smallest-free.

    (p, m) computed at tick tau on dev(p) is ppermute'd during tick
    tau+1 and lands on dev(p+1) = (dev+1) % D, where it occupies a slot
    until (p+1, m) reads it.  Under feedback the last position's output
    is a hand-off too: it rides the same ring hop (device D-1's
    successor is device 0) and occupies a device-0 slot until the entry
    unit ``(0, m + lag)`` reads it.
    Returns (recv_slot, read_slot, num_slots).
    """
    num_ticks = len(work)
    d_ = num_stages
    read_slot = np.full((num_ticks, d_), -1, np.int32)
    recv_slot = np.full((num_ticks, d_), -1, np.int32)
    free: list[list[int]] = [[] for _ in range(d_)]
    next_slot = [0] * d_
    release: dict[tuple[int, int], list[int]] = {}
    for tt in range(num_ticks):
        for dev in range(d_):
            for slot in release.pop((tt, dev), []):
                free[dev].append(slot)
        for dev in range(d_):
            unit = work[tt][dev]
            if unit is None:
                continue
            p, m = unit
            if p == num_positions - 1:
                if feedback_lag is None or m + feedback_lag >= num_items:
                    continue  # final output: collected, arrival discarded
                consume = finish[(0, m + feedback_lag)]
            else:
                consume = finish[(p + 1, m)]
            rdev = (dev + 1) % d_
            if free[rdev]:
                slot = min(free[rdev])
                free[rdev].remove(slot)
            else:
                slot = next_slot[rdev]
                next_slot[rdev] += 1
            recv_slot[tt + 1, rdev] = slot
            read_slot[consume, rdev] = slot
            release.setdefault((consume + 1, rdev), []).append(slot)
    return recv_slot, read_slot, max(1, max(next_slot))


def validate_schedule(name: str, interleave: int = 1) -> int:
    """Check (schedule, interleave) and return the effective V.

    Single validation shared by ``build_plan``, the evaluator, and the
    chunking model so a configuration the executor rejects can never
    yield a plausible modeled number.
    """
    if name not in SCHEDULES:
        raise ValueError(f"unknown schedule {name!r}; expected one of {SCHEDULES}")
    if name == "interleaved":
        if interleave < 1:
            raise ValueError(f"interleave must be >= 1, got {interleave}")
        return interleave
    if interleave != 1:
        raise ValueError(f"schedule {name!r} requires interleave=1, got {interleave}")
    return 1


def _validate(name: str, num_stages: int, num_microbatches: int, interleave: int):
    validate_schedule(name, interleave)
    if num_stages < 1 or num_microbatches < 1:
        raise ValueError("num_stages and num_microbatches must be >= 1")


def build_plan(
    name: str,
    num_stages: int,
    num_microbatches: int,
    interleave: int = 1,
    handoff: int = DEFAULT_HANDOFF,
    inject_positions: tuple[int, ...] = (0,),
    feedback_lag: int | None = None,
) -> SchedulePlan:
    """Greedy list-schedule of all (virtual stage, microbatch) units.

    Two unit priorities are tried and the best plan kept, comparing
    (makespan, in-flight buffer depth): microbatch-major ``(m, -p)``
    keeps the buffer depth O(V) and matches the closed-form makespan
    whenever D | M; chunk-major ``(p // D, m)`` can shave ticks on
    ragged M at the cost of deeper buffers.

    ``inject_positions`` generalizes the item-feed carousel to
    multi-source streams: one virtual-stage position per source (the
    first must be 0 — the chain entry).  Each source gets its own
    round-robin feed ring and reload/advance/consume columns; the tick
    tables themselves are position-oblivious, so injections never change
    the makespan — source s's item m is simply due on device
    ``p_s % D`` the tick unit ``(p_s, m)`` starts.

    ``feedback_lag=L`` builds a persistent (unfold) plan: entry unit
    ``(0, b)`` for ``b >= L`` becomes ready ``handoff`` ticks after the
    final position finished item ``b - L``, and only items ``b < L``
    are primary-source fed.  Feedback plans use the microbatch-major
    priority only — the chunk-major candidate's out-of-order finals
    would deadlock against the feedback dependency chain.
    """
    _validate(name, num_stages, num_microbatches, interleave)
    d_, m_, v_ = num_stages, num_microbatches, interleave
    num_positions = d_ * v_  # global virtual stages
    if feedback_lag is not None and not 1 <= feedback_lag <= m_:
        raise ValueError(
            f"feedback_lag must be in [1, num_microbatches={m_}], got "
            f"{feedback_lag}"
        )
    if not inject_positions or inject_positions[0] != 0:
        raise ValueError(
            f"inject_positions must start with the chain entry 0, got "
            f"{inject_positions}"
        )
    for p in inject_positions:
        if not 0 <= p < num_positions:
            raise ValueError(
                f"inject position {p} outside [0, {num_positions}) "
                f"(D={d_} x V={v_} virtual stages; post-pipeline merges "
                f"are applied by the evaluator, not the plan)"
            )

    # -- greedy simulation -------------------------------------------------
    def _greedy(priority):
        """Incremental list scheduling: units enter a per-device ready
        heap the tick their dependency clears (O(U log U) total — the
        naive rescan-all-pending version is O(M^2 D) and stalls tracing
        for thousand-microbatch streams)."""
        import heapq

        finish: dict[tuple[int, int], int] = {}  # (p, m) -> tick computed
        ready: list[list] = [[] for _ in range(d_)]  # per-device heaps
        becomes_ready: dict[int, list[tuple[int, int]]] = {}
        first_wave = m_ if feedback_lag is None else min(feedback_lag, m_)
        for m in range(first_wave):
            heapq.heappush(ready[0], (priority((0, m)), (0, m)))
        work: list[list[tuple[int, int] | None]] = []  # work[t][d] = (p, m)
        remaining = num_positions * m_
        t = 0
        while remaining:
            for unit in becomes_ready.pop(t, ()):
                heapq.heappush(ready[unit[0] % d_], (priority(unit), unit))
            row: list[tuple[int, int] | None] = [None] * d_
            for dev in range(d_):
                if ready[dev]:
                    row[dev] = heapq.heappop(ready[dev])[1]
            # successors become consumable `handoff` ticks after commit
            for unit in row:
                if unit is not None:
                    finish[unit] = t
                    remaining -= 1
                    p, m = unit
                    if p + 1 < num_positions:
                        becomes_ready.setdefault(t + handoff, []).append(
                            (p + 1, m)
                        )
                    elif feedback_lag is not None and m + feedback_lag < m_:
                        # The unfold edge: item m's final output is the
                        # entry input of item m + lag, one ring hop away.
                        becomes_ready.setdefault(t + handoff, []).append(
                            (0, m + feedback_lag)
                        )
            work.append(row)
            t += 1
            limit = (m_ + handoff) * (num_positions + 1) + 8
            if feedback_lag is not None:
                # Feedback serializes chains of m_/lag items end to end.
                limit += (handoff * num_positions + handoff) * (
                    m_ // max(feedback_lag, 1) + 1
                ) * max(1, m_)
            if t > limit:  # pragma: no cover
                raise RuntimeError(f"schedule {name} did not converge")
        return work, finish

    # Pick by (makespan, buffer depth): chunk-major can shave ticks on
    # ragged M but lets wraparound hand-offs pile up (K ~ O(M)), which
    # is exactly the memory blowup interleaved schedules exist to avoid.
    # Each candidate is slot-allocated exactly once; the winner's tables
    # are reused directly.
    priorities = [
        lambda u: (u[1], -u[0]),  # microbatch-major: K stays O(V)
    ]
    if feedback_lag is None:
        priorities.append(lambda u: (u[0] // d_, u[1]))  # chunk-major
    candidates = []
    for priority in priorities:
        work, finish = _greedy(priority)
        recv_slot, read_slot, num_slots = _allocate_slots(
            work, finish, d_, num_positions, feedback_lag, m_
        )
        candidates.append(
            (len(work), num_slots, work, finish, recv_slot, read_slot)
        )
    num_ticks, num_slots, work, finish, recv_slot, read_slot = min(
        candidates, key=lambda c: (c[0], c[1])
    )

    # -- tick tables -------------------------------------------------------
    microbatch = np.full((num_ticks, d_), -1, np.int32)
    group = np.zeros((num_ticks, d_), np.int32)
    collect = np.zeros((num_ticks, d_), np.int32)
    for tt, row in enumerate(work):
        for dev, unit in enumerate(row):
            if unit is None:
                continue
            p, m = unit
            microbatch[tt, dev] = m
            group[tt, dev] = p // d_
            if p == num_positions - 1:
                collect[tt, dev] = 1
    # Emit placement: under feedback, exactly the final-position units
    # (what collect marks); the final virtual stage D*V-1 lives on device
    # D-1, so emit is last-stage-only by construction — asserted here so
    # the executor may key its only head region off this column.
    emit = collect.copy() if feedback_lag is not None else np.zeros_like(collect)
    assert emit[:, : d_ - 1].sum() == 0, "emit must be last-stage-only"

    # -- item-feed carousels (one per source) ------------------------------
    # Source s's items are round-robin sharded with offset dev_s =
    # inject_positions[s] % D: item i lives on device (i + dev_s) % D, so
    # after j reverse-ring advances since a reload, device dev_s holds
    # exactly item base + j.  A per-source single-item register circulates
    # on the reverse ring (d -> d-1); every D consumptions every device
    # reloads from its local shard.  Stalls freeze the whole ring (the
    # advance flag is tick-uniform).  Consumption tick of source s's item
    # m is the start of unit (p_s, m) on device dev_s — the greedy
    # scheduler runs a position's units in microbatch order (asserted).
    num_src = len(inject_positions)
    inject_devices = tuple(p % d_ for p in inject_positions)
    src_feed_reload = np.zeros((num_src, num_ticks), np.int32)
    src_feed_idx = np.zeros((num_src, num_ticks), np.int32)
    src_consume = np.zeros((num_src, num_ticks), np.int32)
    for s, (p_s, dev_s) in enumerate(zip(inject_positions, inject_devices)):
        # Under feedback the primary source holds only the first `lag`
        # items; later entries re-enter from the in-flight buffers.
        # Every *other* source (entry-zip overlays, interior zips) still
        # delivers one item per stream position.
        feed_total = m_
        if s == 0 and feedback_lag is not None:
            feed_total = min(feedback_lag, m_)
        consumed = 0
        for tt in range(num_ticks):
            unit = work[tt][dev_s]
            if unit is not None and unit[0] == p_s:
                if s == 0 and unit[1] >= feed_total:
                    continue  # fed back, not carousel-fed
                assert unit[1] == consumed, (
                    f"source {s} consumed out of order at position {p_s}"
                )
                src_consume[s, tt] = 1
                if consumed % d_ == 0:
                    src_feed_reload[s, tt] = 1
                    src_feed_idx[s, tt] = consumed // d_
                consumed += 1
        assert consumed == feed_total
    src_feed_advance = src_consume.copy()

    # Primary-source injections are the units that read no slot;
    # fed-back entries are the units at position 0 that *do* read one.
    for tt in range(num_ticks):
        if src_consume[0, tt]:
            assert read_slot[tt, 0] == -1
        unit = work[tt][0]
        if (
            feedback_lag is not None
            and unit is not None
            and unit[0] == 0
            and unit[1] >= feedback_lag
        ):
            assert read_slot[tt, 0] >= 0, (
                f"feedback item {unit[1]} has no buffered input at tick {tt}"
            )

    return SchedulePlan(
        name=name,
        num_stages=d_,
        num_microbatches=m_,
        interleave=v_,
        handoff=handoff,
        num_ticks=num_ticks,
        microbatch=microbatch,
        group=group,
        read_slot=read_slot,
        recv_slot=recv_slot,
        collect=collect,
        inject=src_consume[0].copy(),
        feed_reload=src_feed_reload[0],
        feed_idx=src_feed_idx[0],
        feed_advance=src_feed_advance[0],
        num_slots=num_slots,
        inject_positions=tuple(inject_positions),
        inject_devices=inject_devices,
        src_feed_reload=src_feed_reload,
        src_feed_idx=src_feed_idx,
        src_feed_advance=src_feed_advance,
        src_consume=src_consume,
        feedback_lag=feedback_lag,
        emit=emit,
    )


# ---------------------------------------------------------------------------
# Combined forward+backward plans (true 1F1B; ZB 3-way groundwork)
# ---------------------------------------------------------------------------


def build_backward_plan(
    name: str,
    num_stages: int,
    num_microbatches: int,
    interleave: int = 1,
    handoff: int = DEFAULT_HANDOFF,
) -> SchedulePlan:
    """The B-phase execution tables: a forward plan, mirrored.

    The backward pipeline is the forward one reflected through the ring:
    B unit ``(p, m)`` runs on the same device as F unit ``(p, m)`` and
    depends on ``(p+1, m)`` one *reverse*-ring hop away, so relabelling
    positions ``r = P-1-p`` and devices ``d -> D-1-d`` turns the B-unit
    dependency graph into exactly the forward one.  We therefore reuse
    :func:`build_plan` and flip its device columns, reinterpreting the
    tables for the executor's backward scan:

    * ``microbatch[t, d]`` / ``group[t, d]`` — the B unit ``(group*D+d,
      m)`` device d transposes at tick t (cotangent in, cotangent +
      weight-grad contribution out);
    * ``read_slot`` — the in-flight *cotangent* slot consumed (-1 at
      the last position, whose seed ``d_out[m]`` arrives by carousel);
    * ``recv_slot`` — where the cotangent arriving on the ring from
      device ``(d+1) % D`` is parked (the mirror of the forward hop:
      sends travel the reverse ring);
    * ``collect`` — marks entry units ``(0, m)`` on device 0, whose
      produced cotangent is the source-item gradient ``d_items[m]``;
    * feed columns — the ``d_out`` seed carousel.  Seeds are sharded
      with the *flipped* round-robin layout (device d holds items
      ``j*D + (D-1-d)``) and circulate on the forward ring so seed m
      reaches device D-1 at its m-th consumption.

    The unit ordering equals the B-unit subsequence of
    :func:`build_combined_plan` (each position's units run in
    microbatch order in both); the combined table is the schedule
    artifact, this is what the custom-VJP bwd phase executes.
    """
    fwd = build_plan(name, num_stages, num_microbatches, interleave, handoff)
    flip = lambda a: np.ascontiguousarray(a[:, ::-1])
    return dataclasses.replace(
        fwd,
        microbatch=flip(fwd.microbatch),
        group=flip((fwd.interleave - 1) - fwd.group),
        read_slot=flip(fwd.read_slot),
        recv_slot=flip(fwd.recv_slot),
        collect=flip(fwd.collect),
        emit=flip(fwd.emit),
        inject_devices=(num_stages - 1,),
    )


@dataclasses.dataclass(frozen=True)
class CombinedPlan:
    """One tick table scheduling forward *and* backward units.

    This is the schedule artifact of training under a hand-written
    (planned) backward: every device runs at most one unit per tick, a
    unit is ``(kind, position, microbatch)`` with kind ``UNIT_F`` /
    ``UNIT_B`` / ``UNIT_W``, and the stash/release columns (see the
    column contract in the module docstring) prove the peak number of
    concurrently live activation stashes from the table itself —
    ``min(S, M)`` per device for ``one_f_one_b`` (the 1F1B memory
    bound, now a plan property instead of a modeling assumption) vs
    ``M`` for gpipe's fill-then-drain.

    Execution: :class:`repro.core.stream.FutureEvaluator` with
    ``backward="planned"`` realizes the combined plan under XLA's
    two-phase autodiff protocol — ``jax.custom_vjp`` runs all F units
    (the ``forward`` plan, identical tables to :func:`build_plan`)
    before any B unit (the ``backward`` plan, same unit order as this
    table's B subsequence).  At that phase boundary all ``V*M`` stashes
    are live regardless of schedule, so the executed stash buffers are
    indexed ``group * M + m``; the interleaved stash/release coloring
    here is what a fused runtime (loss computed in-pipeline, B units
    issued as seeds arrive — the ZB executor follow-on) realizes, and
    is what :func:`repro.core.chunking.schedule_peak_items` scores
    under ``backward="planned"``.

    Attributes (all ``(num_ticks, num_stages)`` unless noted):
      kind: unit kind at (tick, device); -1 = idle.
      microbatch: the unit's item; -1 = idle.
      position: the unit's global virtual stage in ``[0, D*V)``.
      stash_slot: per-device stash color written by an F unit; -1 else.
      release_slot: stash color freed after this unit (the B unit, or
        the W unit when ``split_backward``); -1 else.
      num_stash_slots: interval-coloring count == peak live stashes.
      forward / backward: the two phase-execution table sets.
    """

    name: str
    num_stages: int
    num_microbatches: int
    interleave: int
    handoff: int
    split_backward: bool
    num_ticks: int
    kind: np.ndarray
    microbatch: np.ndarray
    position: np.ndarray
    stash_slot: np.ndarray
    release_slot: np.ndarray
    num_stash_slots: int
    forward: SchedulePlan
    backward: SchedulePlan

    @property
    def peak_stash_items(self) -> int:
        """Peak concurrently-stashed activations (in items), recomputed
        from the stash/release columns: a stash is live from its F tick
        through its releasing unit's tick inclusive."""
        peak = 0
        for dev in range(self.num_stages):
            live = 0
            for t in range(self.num_ticks):
                if self.stash_slot[t, dev] >= 0:
                    live += 1
                peak = max(peak, live)
                if self.release_slot[t, dev] >= 0:
                    live -= 1
        return peak

    @property
    def bubble_fraction(self) -> float:
        """Idle fraction of the combined (ticks x devices) grid."""
        busy = int((self.kind >= 0).sum())
        return 1.0 - busy / (self.num_ticks * self.num_stages)


def build_combined_plan(
    name: str,
    num_stages: int,
    num_microbatches: int,
    interleave: int = 1,
    handoff: int = DEFAULT_HANDOFF,
    split_backward: bool = False,
) -> CombinedPlan:
    """Greedy list-schedule of F, B (and optionally W) units jointly.

    Dependencies: ``F(p, m)`` is consumable ``handoff`` ticks after
    ``F(p-1, m)``; ``B(P-1, m)`` one tick after ``F(P-1, m)`` (the
    local loss turnaround — no ring hop); ``B(p, m)`` ``handoff`` ticks
    after ``B(p+1, m)``; ``W(p, m)`` one tick after ``B(p, m)`` (same
    device, any later tick — the ZB-H1 bubble filler).

    Schedule semantics:

    * ``gpipe`` — phase-gated: no B unit starts until every F unit has
      run (fill then drain), so every device's stash peaks at its full
      ``V*M`` unit inputs.
    * ``one_f_one_b`` / ``interleaved`` — B units take priority over F
      the moment their cotangent is available, and a device may not
      start a new F unit while ``V * min(S, M)`` stashes are live (the
      1F1B in-flight cap).  The steady state is the classic 1F1B
      alternation and the stash bound is realized *by construction* —
      asserted from the plan columns in the tier-1 tests, not modeled.

    ``split_backward=True`` emits the 3-way unit split: B units carry
    only the activation grad, W units the weight grad, and the stash is
    released at W (both consume it).  The executor does not run split
    plans yet (ZB-H1 is a follow-on plan *consumer*, not a new
    plan function); the tables are the groundwork.
    """
    import heapq

    _validate(name, num_stages, num_microbatches, interleave)
    d_, m_, v_ = num_stages, num_microbatches, interleave
    num_positions = d_ * v_
    p_last = num_positions - 1
    kinds = (UNIT_F, UNIT_B, UNIT_W) if split_backward else (UNIT_F, UNIT_B)
    # 1F1B live-stash cap: min(S, M) items per (device, local group) —
    # per-group rather than per-device so a shallow group saturating its
    # stash can never starve the deeper groups its own drain depends on
    # (a flat per-device cap deadlocks interleaved plans).  Per-device
    # total: V * min(S, M).
    cap = min(d_, m_)
    gpipe_gated = name == "gpipe"
    release_kind = UNIT_W if split_backward else UNIT_B

    def dev_of(p):
        return p % d_

    def priority(unit):
        kind, p, m = unit
        # B drains stashes first; F fills; W mops up bubbles.  Within a
        # kind, lowest microbatch first, F deepest-position first (the
        # forward plan's microbatch-major key), B shallowest first.
        rank = {UNIT_B: 0, UNIT_F: 1, UNIT_W: 2}[kind]
        return (rank, m, -p if kind == UNIT_F else p)

    finish: dict[tuple[int, int, int], int] = {}
    ready: list[list] = [[] for _ in range(d_)]
    becomes_ready: dict[int, list[tuple[int, int, int]]] = {}
    deferred_b: list[tuple[int, int, int]] = []  # gpipe phase gate
    for m in range(m_):
        heapq.heappush(ready[0], (priority((UNIT_F, 0, m)), (UNIT_F, 0, m)))
    live = [[0] * v_ for _ in range(d_)]
    remaining = num_positions * m_ * len(kinds)
    remaining_f = num_positions * m_
    work: list[list[tuple[int, int, int] | None]] = []
    t = 0
    limit = (len(kinds) * (m_ + handoff) * (num_positions + 1) + 8) * (
        2 + 2 * handoff
    )
    while remaining:
        for unit in becomes_ready.pop(t, ()):
            if gpipe_gated and unit[0] != UNIT_F and remaining_f:
                deferred_b.append(unit)
            else:
                heapq.heappush(ready[dev_of(unit[1])], (priority(unit), unit))
        row: list[tuple[int, int, int] | None] = [None] * d_
        for dev in range(d_):
            skipped = []
            unit = None
            while ready[dev]:
                cand = heapq.heappop(ready[dev])
                if (
                    cand[1][0] == UNIT_F
                    and not gpipe_gated
                    and live[dev][cand[1][1] // d_] >= cap
                ):
                    skipped.append(cand)
                    continue
                unit = cand[1]
                break
            for c in skipped:
                heapq.heappush(ready[dev], c)
            row[dev] = unit
        for dev, unit in enumerate(row):
            if unit is None:
                continue
            kind, p, m = unit
            finish[unit] = t
            remaining -= 1
            if kind == UNIT_F:
                remaining_f -= 1
                live[dev][p // d_] += 1
                if p < p_last:
                    becomes_ready.setdefault(t + handoff, []).append(
                        (UNIT_F, p + 1, m)
                    )
                else:
                    becomes_ready.setdefault(t + 1, []).append((UNIT_B, p, m))
            elif kind == UNIT_B:
                if p > 0:
                    becomes_ready.setdefault(t + handoff, []).append(
                        (UNIT_B, p - 1, m)
                    )
                if split_backward:
                    becomes_ready.setdefault(t + 1, []).append((UNIT_W, p, m))
                else:
                    live[dev][p // d_] -= 1
            else:  # UNIT_W
                live[dev][p // d_] -= 1
        if gpipe_gated and remaining_f == 0 and deferred_b:
            for unit in deferred_b:
                becomes_ready.setdefault(t + 1, []).append(unit)
            deferred_b = []
        work.append(row)
        t += 1
        if t > limit:  # pragma: no cover
            raise RuntimeError(f"combined schedule {name} did not converge")

    num_ticks = len(work)
    kind_tab = np.full((num_ticks, d_), -1, np.int32)
    microbatch = np.full((num_ticks, d_), -1, np.int32)
    position = np.zeros((num_ticks, d_), np.int32)
    for tt, row in enumerate(work):
        for dev, unit in enumerate(row):
            if unit is None:
                continue
            k, p, m = unit
            kind_tab[tt, dev] = k
            microbatch[tt, dev] = m
            position[tt, dev] = p

    # Stash coloring: the activation stashed by F(p, m) on dev(p) is
    # live through the tick its releasing unit (B, or W when split)
    # consumes it.  Same smallest-free interval allocation as the
    # hand-off slots, so the color count is exactly the peak.
    stash_slot = np.full((num_ticks, d_), -1, np.int32)
    release_slot = np.full((num_ticks, d_), -1, np.int32)
    free: list[list[int]] = [[] for _ in range(d_)]
    next_slot = [0] * d_
    freed: dict[tuple[int, int], list[int]] = {}
    slot_of: dict[tuple[int, int], int] = {}
    for tt, row in enumerate(work):
        for dev in range(d_):
            for slot in freed.pop((tt, dev), []):
                free[dev].append(slot)
        for dev, unit in enumerate(row):
            if unit is None:
                continue
            k, p, m = unit
            if k == UNIT_F:
                if free[dev]:
                    slot = min(free[dev])
                    free[dev].remove(slot)
                else:
                    slot = next_slot[dev]
                    next_slot[dev] += 1
                stash_slot[tt, dev] = slot
                slot_of[(p, m)] = slot
            elif k == release_kind:
                slot = slot_of.pop((p, m))
                release_slot[tt, dev] = slot
                freed.setdefault((tt + 1, dev), []).append(slot)

    return CombinedPlan(
        name=name,
        num_stages=d_,
        num_microbatches=m_,
        interleave=v_,
        handoff=handoff,
        split_backward=split_backward,
        num_ticks=num_ticks,
        kind=kind_tab,
        microbatch=microbatch,
        position=position,
        stash_slot=stash_slot,
        release_slot=release_slot,
        num_stash_slots=max(next_slot) if max(next_slot) else 0,
        forward=build_plan(name, d_, m_, v_, handoff),
        backward=build_backward_plan(name, d_, m_, v_, handoff),
    )
