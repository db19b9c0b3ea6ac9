"""Stream re-interpreted with a substitutable evaluation monad (PyTorch).

The port of ``repro.core.stream``'s program, adapter and Lazy monad:

    class Cons(hd: A, tl: Future[Stream[A]]) extends Stream[A]

**The front door is the combinator algebra** (:mod:`repro_torch.core.graph`)::

    from repro_torch.core import Stream

    Stream.source(items)                 # M items, leading axis = stream
          .map(f)                        # stateless per-item transform
          .through(cell_fn, states)      # chain segment of dependent cells
          .zip(other, combine)           # multi-source item-by-item merge
          .concat(other)                 # sequential composition
          .mask(pred)                    # bounded-stream validity tagging
          .collect(evaluator)            # run -> StreamResult(items, states)

A chain segment's cell owns mutable per-cell state and transforms the
item flowing through it::

    cell_fn : (state_s, item) -> (state_s', item')

The semantics are fixed and evaluator-independent:

    item b reaches cell s only after item b-1 has left cell s, and after
    item b has left cell s-1; item b of ``x.zip(y, f)`` is
    ``f(x[b], y[b])`` — source order, never arrival order.

Two evaluators implement these semantics -- the paper's Lazy/Future
monad substitution:

* :class:`LazyEvaluator` -- sequential, on the device the items and
  states lie on: the paper's Lazy monad.
* :class:`FutureEvaluator` -- the schedule-pluggable pipeline: the
  graph is lowered to a chain of cells, the cells are split into D
  stages, and a host-built tick plan (:mod:`repro_torch.core.schedules`)
  says which item each stage advances at each tick.  On a CUDA device
  every stage issues its work on a stream of its own, and an item
  crosses from one stage to the next as a :func:`~repro_torch.core.
  future.ppermute_future`; on the CPU the stages run in tick order.

Both run every cell through one loop (:func:`repro_torch.core.graph.
scan_cells`), so the op sequence of each (cell, item) is the same under
both, and so are the bits.

Streams are bounded, with ``.mask`` validity where needed: the paper
itself bounds the stream in its Future version.

**Migration note** — :class:`StreamProgram` survives as a thin
deprecated adapter over a one-segment graph::

    evaluate(StreamProgram(cell, states, n), items, ev)   # still works
    Stream.from_program(program, items).collect(ev)       # same thing
    Stream.source(items).through(cell, states).collect(ev)  # the new way
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch

from repro_torch import pytree as P
from repro_torch import resolve_device
from repro_torch.core import graph as G
from repro_torch.core.future import ppermute_future, stage_stream
from repro_torch.core.graph import Stream, StreamResult
from repro_torch.core.schedules import SchedulePlan, build_plan, validate_backward

PyTree = Any
CellFn = Callable[[PyTree, PyTree], tuple[PyTree, PyTree]]


# ---------------------------------------------------------------------------
# Program (deprecated adapter)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamProgram:
    """A bounded stream of ``num_cells`` dependent cells.

    .. deprecated::
        The combinator algebra (:class:`repro_torch.core.graph.Stream`) is
        the public front door; ``StreamProgram`` remains as an adapter for
        a one-segment chain (``Stream.from_program``).

    Attributes:
      cell_fn: ``(state, item) -> (new_state, out_item)``.  Pure.  Applied
        once per (cell, item) pair.  The cell index, if needed, should be
        carried inside ``state`` (see :func:`indexed_states`).
      init_state: per-cell state, every leaf stacked with leading axis
        ``num_cells``.
      num_cells: chain length (the paper's stream length).
    """

    cell_fn: CellFn
    init_state: PyTree
    num_cells: int
    # False => cells never mutate their state (e.g. the state is layer
    # parameters); the evaluator then keeps the state as it was.
    mutable_state: bool = True
    # Recompute cell_fn on the backward pass (activation checkpointing
    # per (cell, item) pair).
    remat: bool = False

    def __post_init__(self):
        for leaf in P.leaves(self.init_state):
            if hasattr(leaf, "shape") and tuple(leaf.shape[:1]) != (self.num_cells,):
                raise ValueError(
                    f"init_state leaves must have leading axis num_cells="
                    f"{self.num_cells}, got shape {tuple(leaf.shape)}"
                )


def indexed_states(state: PyTree, num_cells: int) -> PyTree:
    """Attach a cell-index leaf to per-cell state (helper), on the
    device of the state's first leaf."""
    first = next(iter(P.leaves(state)), None)
    device = first.device if isinstance(first, torch.Tensor) else None
    return {"index": torch.arange(num_cells, device=device), "state": state}


def _check_program(program, items) -> bool:
    """Shared Stream/StreamProgram dispatch + item validation.

    Returns True for the legacy StreamProgram form (items validated),
    False for a Stream (which carries its own sources).
    """
    if isinstance(program, Stream):
        if items is not None:
            raise ValueError(
                "a Stream carries its own sources; do not pass items"
            )
        return False
    if isinstance(program, StreamProgram):
        G.leading_axis_size(items, "items")
        return True
    raise TypeError(
        f"expected Stream or StreamProgram, got {type(program).__name__}"
    )


def _as_chain(program, items) -> tuple[G.ChainProgram, bool]:
    """Normalize (StreamProgram, items) | Stream into a ChainProgram.

    Returns ``(chain, legacy)`` -- legacy callers get the single
    segment's states back un-tupled.
    """
    if _check_program(program, items):
        stream = Stream.source(items).through(
            program.cell_fn,
            program.init_state,
            num_cells=program.num_cells,
            mutable_state=program.mutable_state,
            remat=program.remat,
        )
        return stream.lower(), True
    return program.lower(), False


# ---------------------------------------------------------------------------
# Lazy evaluator — the Lazy monad (sequential, memoized)
# ---------------------------------------------------------------------------


class LazyEvaluator:
    """Sequential evaluation: topological scan composition of the IR.

    Equivalent to the paper's ``Future(value: => A)`` with ``lazy val``
    memoization — every tail is evaluated exactly once, on demand, on the
    calling thread.  Runs any well-formed graph, including those the
    pipeline lowering rejects (zips of two stateful pipelines).  Ops are
    issued on the device the items and states lie on.
    """

    name = "lazy"

    def run_graph(self, stream: Stream) -> StreamResult:
        if any(isinstance(n, G.FeedbackNode) for n in stream.nodes()):
            # Feedback has no node-local order; run the lowered chain
            # sequentially.
            states, outs = G.run_chain_sequential(stream.lower())
            return StreamResult(items=outs, states=states)
        outs, states = G.lazy_eval_graph(stream.node)
        return StreamResult(items=outs, states=states)

    def __call__(self, program, items: PyTree = None) -> tuple[PyTree, PyTree]:
        """Run ``items`` (leading axis = stream of M items) through the chain.

        Returns ``(final_states, out_items)`` with ``out_items`` leading
        axis M (item b after all cells).  ``program`` may be a deprecated
        :class:`StreamProgram` (with ``items``) or a :class:`Stream`
        (whose sources carry the items; final states are a tuple, one per
        segment).
        """
        if not _check_program(program, items):
            result = self.run_graph(program)
            return result.states, result.items

        cell_fn = G._const_cell(program.cell_fn, False)
        if program.remat:
            cell_fn = G._checkpoint(cell_fn)
        index = iter(range(G.leading_axis_size(items)))

        def item_step(states, item):
            out, new_states = G.scan_cells(
                cell_fn, program.mutable_state, item, None, states, item=next(index)
            )
            return new_states, out

        return G.scan(item_step, program.init_state, items)


# ---------------------------------------------------------------------------
# Future evaluator -- the schedule-pluggable pipeline engine
# ---------------------------------------------------------------------------


class FutureEvaluator:
    """Pipelined evaluation over ``num_stages`` stages of one device.

    The program (a :class:`Stream` or deprecated :class:`StreamProgram`)
    is lowered to a :class:`~repro_torch.core.graph.ChainProgram` -- a
    spine of fused chain segments plus one injection point per source.
    The total cell count must be divisible by ``num_stages * interleave``
    and every interior injection (``zip``) must fall on a virtual-stage
    boundary, as in the reference.  Virtual stage ``p`` owns the
    contiguous cells ``[p * c, (p + 1) * c)``; stage ``d`` runs virtual
    stages ``v * D + d`` (one for ``interleave == 1``).

    The tick loop executes a :class:`~repro_torch.core.schedules.
    SchedulePlan` built on the host, and every per-tick choice the
    reference makes on the device (a ``take`` of the plan row, the
    idle-tick ``cond``, the emit on the last stage only, the output
    write at the last virtual stage) is a host ``if`` here:

    * at tick t each busy stage takes its input -- a fresh item of the
      primary source (merged with the entry zips' items), or the value
      its predecessor handed it, parked in the slot the plan gives --
      merges the zips the plan consumes there, and advances it through
      its cell group (:func:`repro_torch.core.graph.scan_cells`, the
      same loop the Lazy executors run);
    * what a stage produced at tick t reaches its successor at the end
      of tick t+1 (the plan's hand-off of 2), as a
      :func:`~repro_torch.core.future.ppermute_future`;
    * a source's item m is read directly at the tick the plan consumes
      it.  One device holds every source, so the reference's
      round-robin carousel (which moves items over a mesh) has no
      counterpart, and neither has its mesh machinery (``shard_map``,
      ``pcast``).

    On a CUDA device stage d issues on :func:`~repro_torch.core.future.
    stage_stream` ``(device, d)``.  Every stage stream first waits on the
    caller's stream (which made the inputs); a value crossing stages is
    forced by the consumer's stream through an event and marked with
    ``record_stream``; the caller's stream waits on every stage stream
    before the results are handed back, and also when a cell raises, so
    that nothing the caller issues after the exception (a supervisor's
    restore) is overtaken by units still running on a stage stream.  Each cell's state rows are
    written only by the stream of the stage that owns them.  Nothing in
    the loop syncs the host with the card.  On the CPU the stages run
    as logical stages in tick order, with no streams and no events.

    ``backward="autodiff"`` lets autograd differentiate the eager ops;
    ``"planned"`` (the combined-plan backward) is not ported
    (ROADMAP A10).  ``time_units=True`` records a pair of timing events
    around every unit on its stage's stream (:meth:`unit_times`).
    """

    name = "future"

    def __init__(
        self,
        num_stages: int,
        axis_name: str = "pod",
        schedule: str = "gpipe",
        interleave: int = 1,
        backward: str = "autodiff",
        device: str | torch.device | None = None,
        time_units: bool = False,
    ):
        if num_stages < 1:
            raise ValueError(f"num_stages must be >= 1, got {num_stages}")
        if schedule != "interleaved" and interleave != 1:
            raise ValueError(f"{schedule=} requires interleave=1, got {interleave}")
        if validate_backward(backward) == "planned":
            raise NotImplementedError(
                "backward='planned' (the combined-plan backward) is not ported "
                "yet: ROADMAP A10"
            )
        self.num_stages = num_stages
        self.axis_name = axis_name
        self.schedule = schedule
        self.interleave = interleave
        self.device = None if device is None else resolve_device(device)
        self.time_units = time_units
        self._unit_events: list[tuple[int, int, Any, Any]] = []

    def plan_for(
        self,
        num_microbatches: int,
        inject_positions: tuple[int, ...] = (0,),
        feedback_lag: int | None = None,
    ) -> SchedulePlan:
        """The tick plan this evaluator would run for M microbatches."""
        return build_plan(
            self.schedule,
            self.num_stages,
            num_microbatches,
            self.interleave,
            inject_positions=inject_positions,
            feedback_lag=feedback_lag,
        )

    def run_graph(self, stream: Stream) -> StreamResult:
        states, outs = self._run_chain(stream.lower())
        return StreamResult(items=outs, states=states)

    def __call__(self, program, items: PyTree = None) -> tuple[PyTree, PyTree]:
        chain, legacy = _as_chain(program, items)
        states, outs = self._run_chain(chain)
        if legacy:
            return states[0], outs
        return states, outs

    def unit_times(self) -> list[tuple[int, int, float, float]]:
        """``(stage, tick, start_ms, end_ms)`` of every unit of the last
        run with ``time_units``, from the first unit's start; call after
        the card finished the run (``torch.cuda.synchronize()``)."""
        if not self._unit_events:
            return []
        ref = self._unit_events[0][2]
        times = [(d, t, ref.elapsed_time(a), ref.elapsed_time(b))
                 for d, t, a, b in self._unit_events]
        t0 = min(u[2] for u in times)
        return [(d, t, a - t0, b - t0) for d, t, a, b in times]

    # -- chain execution ---------------------------------------------------

    def _run_chain(self, chain: G.ChainProgram) -> tuple[tuple, PyTree]:
        d_, v_ = self.num_stages, self.interleave
        m_ = chain.num_items
        fb = chain.feedback

        # Segment-free program: pure data plumbing, no pipeline.
        if chain.num_cells == 0:
            if fb is not None:
                raise ValueError(
                    "a segment-free feedback chain has nothing to "
                    "pipeline; run it with LazyEvaluator"
                )
            feeds = [inj.materialize() for inj in chain.injections]
            outs = feeds[0]
            for inj, feed in zip(chain.injections[1:], feeds[1:]):
                outs = G.apply_per_item(lambda ab, _c=inj.combine: _c(*ab), (outs, feed))
            if chain.finalize is not None:
                outs = G.apply_per_item(chain.finalize, outs)
            return (), outs

        if chain.num_cells % (d_ * v_) != 0:
            raise ValueError(
                f"num_cells={chain.num_cells} not divisible by axis "
                f"'{self.axis_name}' size {d_} x interleave {v_}"
            )
        per_group = chain.num_cells // (d_ * v_)

        # Every zip lands on a virtual-stage boundary; post-pipeline
        # merges (cell_index == num_cells) apply after the loop.
        pipelined: list[G.ChainInjection] = []
        tail: list[G.ChainInjection] = []
        positions: list[int] = []
        for inj in chain.injections:
            if inj.cell_index >= chain.num_cells and inj.combine is not None:
                tail.append(inj)
                continue
            if inj.cell_index % per_group != 0:
                raise ValueError(
                    f"zip injection at cell {inj.cell_index} does not fall "
                    f"on a virtual-stage boundary (cells_per_group="
                    f"{per_group}, D={d_}, V={v_}); move the zip or change "
                    f"the stage split"
                )
            pipelined.append(inj)
            positions.append(inj.cell_index // per_group)

        plan = self.plan_for(m_, tuple(positions), feedback_lag=fb.lag if fb else None)
        sources = [inj.materialize() for inj in pipelined]
        for s, src in enumerate(sources):
            G.leading_axis_size(src, f"source {s} items")
        combines = [inj.combine for inj in pipelined]
        entry = [s for s in range(1, len(sources)) if positions[s] == 0]
        interior = [s for s in range(1, len(sources)) if positions[s] != 0]

        cell_fn, init_state, const_state, mutable, split_states = (
            G._chain_cell_machinery(chain)
        )
        # Each virtual stage's rows: views of the chain's state.
        cuts = [(p * per_group, (p + 1) * per_group) for p in range(d_ * v_)]
        rows_in = [P.tree_map(lambda l, a=a, b=b: l[a:b], init_state) for a, b in cuts]
        consts = [P.tree_map(lambda l, a=a, b=b: l[a:b], const_state) for a, b in cuts]
        rows = list(rows_in)

        device = self.device or _device_of((sources, init_state))
        if device.type == "cuda":
            caller = torch.cuda.current_stream(device)
            streams = [stage_stream(device, d) for d in range(d_)]
            for st in streams:
                st.wait_stream(caller)
        else:
            caller, streams = None, [None] * d_
        self._unit_events = []

        def item(src, m):
            return P.tree_map(lambda x: x[m], src)

        buf = [[None] * plan.num_slots for _ in range(d_)]
        outs: list[PyTree] = [None] * m_
        sent: list = [None] * d_  # what each stage produced last tick
        try:
            for t in range(plan.num_ticks):
                made: list = [None] * d_
                for d in range(d_):
                    m = int(plan.microbatch[t, d])
                    if m < 0:  # idle: no scan, no state touched
                        continue
                    p = int(plan.group[t, d]) * d_ + d
                    with _on(streams[d]):
                        if self.time_units and streams[d] is not None:
                            start = torch.cuda.Event(enable_timing=True)
                            start.record(streams[d])
                        slot = int(plan.read_slot[t, d])
                        if slot < 0:  # a fresh item of the primary source
                            inp = item(sources[0], m)
                            if fb is None:
                                for s in entry:
                                    inp = combines[s](inp, item(sources[s], m))
                        else:  # a hand-off, or under feedback item m - lag's output
                            if buf[d][slot] is None:
                                raise RuntimeError(
                                    f"plan fault: stage {d} reads an empty slot {slot} at tick {t}"
                                )
                            inp, buf[d][slot] = buf[d][slot].force(), None
                        for s in (entry if fb is not None else []) + interior:
                            if plan.src_consume[s, t] and d == plan.inject_devices[s]:
                                merged = combines[s](inp, item(sources[s], m))
                                if (fb is not None and s in entry
                                        and not G.structures_match(inp, merged)):
                                    raise ValueError(
                                        "entry zips on a feedback chain must preserve the "
                                        "primary item structure (the fed-back item re-enters "
                                        "through the same combines)"
                                    )
                                inp = merged
                        out, rows[p] = G.scan_cells(
                            cell_fn, mutable, inp, consts[p], rows[p], item=m
                        )
                        if fb is not None and plan.emit[t, d]:
                            emitted = fb.emit(out)
                            G._check_emit_structure(out, emitted)
                            out = emitted
                        if plan.collect[t, d]:
                            outs[m] = out
                        if self.time_units and streams[d] is not None:
                            end = torch.cuda.Event(enable_timing=True)
                            end.record(streams[d])
                            self._unit_events.append((d, t, start, end))
                    made[d] = ppermute_future(out, streams[d])
                # The hop of last tick's outputs lands now, after this tick's
                # reads (a slot read at t may be refilled at t).
                for d in range(d_):
                    slot = int(plan.recv_slot[t, d])
                    if slot >= 0:
                        buf[d][slot] = sent[(d - 1) % d_]
                sent = made
        finally:
            # Joined on every exit: a cell that raises mid-plan leaves the
            # units issued before it running on their stage streams, and
            # work the caller issues next (a restore of the state) must
            # not be overtaken by their writes.
            if caller is not None:
                for st in streams:
                    caller.wait_stream(st)

        if caller is not None:
            for leaf in P.leaves((outs, rows)):
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                    leaf.record_stream(caller)
        final = G.join_parts(init_state, rows_in, rows)
        outs = G._stack(outs)
        # Post-pipeline merges (zips past the last cell) and fused tail
        # maps apply per item after the pipeline.
        for inj in tail:
            outs = G.apply_per_item(
                lambda ab, _c=inj.combine: _c(*ab), (outs, inj.materialize())
            )
        if chain.finalize is not None:
            outs = G.apply_per_item(chain.finalize, outs)
        return split_states(final), outs


def _device_of(tree: PyTree) -> torch.device:
    """The device of the first tensor of ``tree`` (the CPU if none)."""
    for leaf in P.leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def _on(stream: torch.cuda.Stream | None):
    """Issue on ``stream``; a no-op context on the CPU."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def evaluate(
    program,
    items: PyTree = None,
    evaluator: LazyEvaluator | FutureEvaluator | None = None,
) -> tuple[PyTree, PyTree]:
    """Monad-substitution entry point: same program, pluggable evaluator.

    ``program`` is a :class:`Stream` (preferred; carries its own sources)
    or a deprecated :class:`StreamProgram` with ``items``.
    """
    evaluator = evaluator or LazyEvaluator()
    return evaluator(program, items)
