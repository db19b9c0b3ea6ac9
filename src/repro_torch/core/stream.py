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
from repro_torch.core.future import (
    Future,
    P2PBatch,
    axis_group,
    hop_tag,
    like_local,
    p2p,
    ppermute_future,
    ring_peers,
    stage_stream,
    to_local,
)
from repro_torch.core.graph import Stream, StreamResult
from repro_torch.core.schedules import (
    SchedulePlan,
    build_backward_plan,
    build_plan,
    validate_backward,
)

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
    """Pipelined evaluation over ``num_stages`` stages of one device, or
    over the ranks of a mesh axis (``mesh=``).

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

    ``backward="autodiff"`` lets autograd differentiate the eager ops.
    ``"planned"`` runs the backward as scheduled work, the port of the
    reference's custom VJP: a ``torch.autograd.Function`` whose forward
    runs the plan's F units and stashes each unit's input, and whose
    backward replays :func:`~repro_torch.core.schedules.
    build_backward_plan`'s B units on the same stage streams (see
    :meth:`_run_chain_planned`); its gradients are bitwise those of
    ``"autodiff"``.  ``time_units=True`` records a pair of timing events
    around every unit on its stage's stream (:meth:`unit_times`).

    **Across ranks** (``mesh=``, a ``DeviceMesh``): the stages are the
    ranks of the mesh axis ``axis_name``, as in the reference, and D is
    its size.  Every rank builds the same plan and runs only its own
    virtual stages ``v * D + d``, and a unit's output crosses to the next
    rank by p2p (see :meth:`_run_chain_ranked`); every chain the one-device
    loop runs runs so: mutable and read-only state, zips, feedback.  Every
    rank holds the source items, gets the outputs (broadcast from the
    last rank) and returns its own cells' final states.  By default every
    rank is given the whole chain, as the reference's evaluator is, and
    keeps only its cells' rows (views); with ``local_cells=True`` the
    chain a rank is given holds only its own cells, its V groups back to
    back in the reference's device-major layout (:meth:`local_rows`
    makes them: a decode cache shard, ``pipeline.local_stages``'s stage
    params), so that no rank allocates another's.  :meth:`gather_states`
    assembles the whole chain's states on every rank.
    """

    name = "future"

    def __init__(
        self,
        num_stages: int | None = None,
        axis_name: str = "pod",
        schedule: str = "gpipe",
        interleave: int = 1,
        backward: str = "autodiff",
        device: str | torch.device | None = None,
        time_units: bool = False,
        mesh=None,
        local_cells: bool = False,
    ):
        if local_cells and mesh is None:
            raise ValueError("local_cells=True is a mode of the ranked evaluator: give a mesh")
        if mesh is not None:
            from repro_torch.parallel.sharding import mesh_axes

            size = mesh_axes(mesh)[axis_name]
            if num_stages not in (None, size):
                raise ValueError(f"num_stages={num_stages}, but axis {axis_name!r} of the "
                                 f"mesh has {size} ranks")
            num_stages = size
        if num_stages is None or num_stages < 1:
            raise ValueError(f"num_stages must be >= 1 (or give a mesh), got {num_stages}")
        self.mesh = mesh
        if schedule != "interleaved" and interleave != 1:
            raise ValueError(f"{schedule=} requires interleave=1, got {interleave}")
        self.backward = validate_backward(backward)
        self.num_stages = num_stages
        self.axis_name = axis_name
        self.schedule = schedule
        self.interleave = interleave
        self.device = None if device is None else resolve_device(device)
        self.time_units = time_units
        self.local_cells = local_cells
        self._unit_events: list[tuple[int, int, Any, Any]] = []
        # (segment sizes, cells a virtual stage, local_cells) of the last ranked run
        self._ranked_layout: tuple | None = None

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
        states, outs = self._execute(stream.lower())
        return StreamResult(items=outs, states=states)

    def __call__(self, program, items: PyTree = None) -> tuple[PyTree, PyTree]:
        chain, legacy = _as_chain(program, items)
        states, outs = self._execute(chain)
        if legacy:
            return states[0], outs
        return states, outs

    def unit_times(self) -> list[tuple[int, int, float, float]]:
        """``(stage, tick, start_ms, end_ms)`` of every unit of the last
        run with ``time_units``, from the first unit's start; call after
        the card finished the run (``torch.cuda.synchronize()``).  A
        planned backward's B units follow the F units, their ticks
        numbered on from the forward plan's last."""
        if not self._unit_events:
            return []
        ref = self._unit_events[0][2]
        times = [(d, t, ref.elapsed_time(a), ref.elapsed_time(b))
                 for d, t, a, b in self._unit_events]
        t0 = min(u[2] for u in times)
        return [(d, t, a - t0, b - t0) for d, t, a, b in times]

    # -- across ranks: this rank's rows, and the whole chain's ---------------

    def _rank_cells(self, rank: int, per_group: int) -> list[int]:
        """The chain cells of ``rank`` in device-major order: virtual
        stages ``v * D + rank``, ``v < interleave``, back to back."""
        d_ = self.num_stages
        return [(v * d_ + rank) * per_group + i
                for v in range(self.interleave) for i in range(per_group)]

    def local_rows(self, tree: PyTree) -> PyTree:
        """This rank's rows of ``tree`` (leaves stacked over a chain's
        cells) for a ``local_cells`` chain: its V groups back to back, a
        view for ``interleave`` 1 (one slice), a copy otherwise."""
        d_, v_ = self.num_stages, self.interleave
        d = self.mesh.get_local_rank(self.axis_name)

        def rows(leaf):
            if leaf.shape[0] % (d_ * v_):
                raise ValueError(f"{leaf.shape[0]} cells do not split over {d_} ranks x "
                                 f"interleave {v_}")
            c = leaf.shape[0] // (d_ * v_)
            parts = [leaf[(v * d_ + d) * c:(v * d_ + d + 1) * c] for v in range(v_)]
            return parts[0] if v_ == 1 else torch.cat(parts)

        return P.tree_map(rows, tree)

    def gather_states(self, states: tuple) -> tuple:
        """The whole chain's final states (one per segment) on every rank,
        from the rows of its own cells each rank's last run returned: an
        all-gather over the axis.  Off a mesh, ``states`` itself."""
        if self.mesh is None:
            return states
        import torch.distributed as dist

        if self._ranked_layout is None:
            raise ValueError("gather_states follows a run of this evaluator across ranks")
        sizes, c, local = self._ranked_layout
        d_ = self.num_stages
        if local:
            if len(sizes) != 1:
                raise ValueError("gather_states takes a local_cells chain of one segment")
            sizes = [sizes[0] * d_]
        group = axis_group(self.axis_name, self.mesh)
        out, off = [], 0
        for n, state in zip(sizes, states):
            idx = [[g - off for g in self._rank_cells(r, c) if off <= g < off + n]
                   for r in range(d_)]
            k = max(len(i) for i in idx)

            def whole(leaf, idx=idx, k=k, n=n):
                pad = leaf.new_zeros((k,) + tuple(leaf.shape[1:]))
                pad[: leaf.shape[0]] = leaf
                bufs = [torch.empty_like(pad) for _ in range(d_)]
                dist.all_gather(bufs, pad, group=group)
                full = leaf.new_empty((n,) + tuple(leaf.shape[1:]))
                for r in range(d_):  # slices, no index tensor: no host copy
                    at = 0
                    for a, count in G.row_runs(idx[r]):
                        full[a:a + count] = bufs[r][at:at + count]
                        at += count
                return full

            out.append(P.tree_map(whole, state))
            off += n
        return tuple(out)

    # -- chain execution ---------------------------------------------------

    def _execute(self, chain: G.ChainProgram) -> tuple[tuple, PyTree]:
        if self.mesh is not None:
            return self._run_chain_ranked(chain)
        if self.backward == "planned":
            return self._run_chain_planned(chain)
        return self._run_chain(chain)

    def _streams(self, device: torch.device):
        """(caller's stream, stage streams) on a card, every stage stream
        ordered after the caller's work; (None, [None] * D) elsewhere."""
        if device.type != "cuda":
            return None, [None] * self.num_stages
        caller = torch.cuda.current_stream(device)
        streams = [stage_stream(device, d) for d in range(self.num_stages)]
        for st in streams:
            st.wait_stream(caller)
        return caller, streams

    def _start_unit(self, stream):
        if not (self.time_units and stream is not None):
            return None
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        return start

    def _end_unit(self, stream, start, d: int, t: int) -> None:
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            self._unit_events.append((d, t, start, end))

    def _run_chain(self, chain: G.ChainProgram, stash: dict | None = None,
                   machinery=None) -> tuple[tuple, PyTree]:
        """The forward tick loop.  ``stash`` (the planned backward's
        residuals), when given, receives every unit's input under the
        key ``(virtual stage, item)``; ``machinery`` is a chain's
        :func:`~repro_torch.core.graph._chain_cell_machinery`, when the
        caller already made it."""
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
            machinery or G._chain_cell_machinery(chain)
        )
        # Each virtual stage's rows: views of the chain's state.
        cuts = [(p * per_group, (p + 1) * per_group) for p in range(d_ * v_)]
        rows_in = [P.tree_map(lambda l, a=a, b=b: l[a:b], init_state) for a, b in cuts]
        consts = [P.tree_map(lambda l, a=a, b=b: l[a:b], const_state) for a, b in cuts]
        rows = list(rows_in)

        device = self.device or _device_of((sources, init_state))
        caller, streams = self._streams(device)
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
                        start = self._start_unit(streams[d])
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
                        if stash is not None:
                            stash[p, m] = inp
                        out, rows[p] = G.scan_cells(
                            cell_fn, mutable, inp, consts[p], rows[p], item=m
                        )
                        if fb is not None and plan.emit[t, d]:
                            emitted = fb.emit(out)
                            G._check_emit_structure(out, emitted)
                            out = emitted
                        if plan.collect[t, d]:
                            outs[m] = out
                        self._end_unit(streams[d], start, d, t)
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


    # -- planned backward (1F1B B units as scheduled work) -----------------

    def _run_chain_planned(self, chain: G.ChainProgram) -> tuple[tuple, PyTree]:
        """Execute the chain with the backward pass as scheduled B units.

        The port of the reference's custom VJP, as a
        ``torch.autograd.Function`` (:class:`_Planned`):

        * **forward** runs the plan's F units (:meth:`_run_chain`, the
          same tick loop ``"autodiff"`` runs) and stashes every unit's
          input under ``(virtual stage, item)``: all ``V*M`` of a stage
          are live at the boundary between the two phases, as in the
          reference (see :class:`~repro_torch.core.schedules.
          CombinedPlan`).
        * **backward** replays :func:`~repro_torch.core.schedules.
          build_backward_plan`'s B units in its tick order, each on the
          stage stream of the stage that ran its F unit: the unit
          recomputes its cell group under ``torch.enable_grad()`` at the
          stashed input (group-level rematerialisation, so a segment's
          ``remat`` is moot inside it) and calls ``torch.autograd.grad``;
          the input cotangent goes one hop down the reverse ring as a
          :func:`~repro_torch.core.future.ppermute_future`, forced on
          the consumer's stage stream.  Entry units give the source
          items' gradients.

        Weight-gradient contributions are staged per (virtual stage,
        item) and summed per stage with the item descending, as the
        reference does: the order in which autograd accumulates a leaf
        used once per item in the forward tick loop, so the gradients are
        bitwise those of ``backward="autodiff"``.  The staging holds M
        times a stage's weight gradients.

        The reference's constraints hold: one source, immutable cell
        state, no ``const_state``, floating-point items, no feedback.
        Without autograd recording (or with no input that requires
        grad) the chain runs as under ``"autodiff"``, with no stash.
        """
        d_, v_ = self.num_stages, self.interleave
        if chain.feedback is not None:
            raise ValueError(
                "backward='planned' does not support feedback chains "
                "(decode loops do not train); use backward='autodiff'"
            )
        if len(chain.injections) != 1:
            raise ValueError(
                "backward='planned' supports single-source chains only "
                "(the training shape: one stream of microbatches); use "
                "backward='autodiff' for zip/multi-source programs"
            )
        if chain.num_cells % (d_ * v_) != 0:
            raise ValueError(
                f"num_cells={chain.num_cells} not divisible by axis "
                f"'{self.axis_name}' size {d_} x interleave {v_}"
            )
        machinery = G._chain_cell_machinery(chain)
        _, init_state, const_state, mutable, split_states = machinery
        if mutable:
            raise ValueError(
                "backward='planned' requires immutable cell state "
                "(mutable_state=False): the 1F1B backward runs items in "
                "ascending order, which is only a valid transpose when "
                "cells do not mutate state across items; use "
                "backward='autodiff'"
            )
        if const_state is not None:
            raise ValueError(
                "backward='planned' does not support const_state segments "
                "(const leaves are excluded from differentiation by "
                "construction); put read-only differentiable state in an "
                "ordinary mutable_state=False segment, or use "
                "backward='autodiff'"
            )
        src = chain.injections[0].materialize()
        for leaf in P.leaves(src):
            if not (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()):
                raise ValueError(
                    "backward='planned' requires floating-point source "
                    "items (cotangents ride the same ring buffers)"
                )
        G.leading_axis_size(src, "items")
        if chain.num_cells == 0:
            return self._run_chain(chain)
        fed = dataclasses.replace(
            chain, finalize=None,
            injections=(dataclasses.replace(chain.injections[0], materialize=lambda: src),),
        )
        s_leaves, s_def = P.flatten(init_state)
        x_leaves, x_def = P.flatten(src)
        if not (torch.is_grad_enabled()
                and any(t.requires_grad for t in s_leaves + x_leaves
                        if isinstance(t, torch.Tensor))):
            _, outs = self._run_chain(fed, machinery=machinery)
        else:
            run = _PlannedRun(self, fed, machinery, len(s_leaves))
            out_leaves = _Planned.apply(run, *s_leaves, *x_leaves)
            outs = P.unflatten(run.out_def, out_leaves)
        if chain.finalize is not None:
            outs = G.apply_per_item(chain.finalize, outs)
        return split_states(init_state), outs


    # -- across the ranks of a mesh axis -----------------------------------

    def _run_chain_ranked(self, chain: G.ChainProgram) -> tuple[tuple, PyTree]:
        """The pipeline with its stages on the ranks of the mesh axis.

        Rank d runs the plan's units of its virtual stages on its own
        device, in tick order, and hands each output to rank d+1 (the
        last rank's outputs of virtual stage ``v*D + D-1`` to rank 0
        under ``interleave > 1``).  At each tick a rank issues, as one
        batch (:func:`~repro_torch.core.future.p2p`), the send of what
        it made and the receive of what rank d-1 made at the same tick
        -- which every rank reads off the shared plan -- so the two ends
        of every pair issue their messages in one order, as NCCL needs
        (it matches by order; gloo by the tags, one for each
        ``(virtual stage, item, direction)``).  A received value is
        forced at the tick that consumes it, two or more ticks later (the
        plan's hand-off of 2).  A hop carries each leaf of the flowing
        item (its local shard, laid out as the first item's leaf is: a
        DTensor unit output is redistributed to that layout first,
        inside the unit's graph).  On an axis of size 1 a hop is the
        value itself.

        Every chain the one-device loop runs runs here, from one plan
        (the zips' positions and the feedback lag in it):

        * mutable cell state: a unit advances this rank's rows of its
          virtual stage in place (:func:`~repro_torch.core.graph.
          scan_cells`); an idle tick runs no cell and writes nothing, and
          no tick copies a state;
        * ``const_state``: this rank's rows, read per cell, never part of
          a hop or a write-back;
        * sources: every rank holds every source.  An entry zip merges
          where virtual stage 0 runs (rank 0), an interior zip on the
          rank that owns its virtual stage (the plan's
          ``inject_devices``), at the ticks the plan consumes it; under
          feedback the entry zips gate on that column too, so that they
          overlay fed-back items.  Tail zips and ``finalize`` apply after
          the loop, on every rank;
        * feedback: ``emit`` runs on the rank of the last virtual stage,
          at the plan's ``emit`` ticks; the emitted item is collected
          there and crosses to rank 0 as the entry input of item
          ``m + lag``, in the same per-tick batch as every forward hop.

        The outputs are broadcast from the last rank, so every rank
        returns them; each rank returns its own cells' final states (per
        segment, in cell order).

        The backward is one autograd node over the whole run
        (:class:`_Ranked`): its B units run in tick order, never in the
        autograd engine's, each cotangent crossing to rank d-1 in the
        same per-tick batches -- under ``"autodiff"`` the forward plan's
        units in reverse tick order on the graphs the forward recorded,
        under ``"planned"`` :func:`~repro_torch.core.schedules.
        build_backward_plan`'s units recomputed from the stashed inputs.
        Weight gradients are summed per virtual stage with the item
        descending, as on one device, so both are bitwise the Lazy
        evaluator's.  The ranks compute the same function of the
        broadcast outputs (a loss replicated over the axis): the last
        rank's cotangent of the outputs seeds the backward, and the
        source items' gradient is broadcast from rank 0, which runs
        virtual stage 0.  Its scope is the training shape of
        :func:`~repro_torch.core.pipeline.pipeline_apply`: a
        ``local_cells`` chain of one source, immutable cell state, no
        ``const_state``, no feedback; autograd through any other chain
        across ranks raises ``ValueError``.
        """
        if chain.num_cells == 0:  # data plumbing, the same on every rank
            return self._run_chain(chain)
        run = _RankRun(self, chain, G._chain_cell_machinery(chain))
        if run.needs_grad():
            run.check_backward_scope()
            outs = P.unflatten(run.out_def, _Ranked.apply(run, *run.s_leaves, *run.x_leaves))
        else:
            outs = P.unflatten(run.out_def, run.forward())
        for inj in run.tail:
            outs = G.apply_per_item(
                lambda ab, _c=inj.combine: _c(*ab), (outs, inj.materialize())
            )
        if chain.finalize is not None:
            outs = G.apply_per_item(chain.finalize, outs)
        return run.final_states(), outs


class _RankRun:
    """One run of the pipeline across ranks (:meth:`FutureEvaluator.
    _run_chain_ranked`): this rank's rows and units, the hops, and what
    the backward needs from the forward."""

    def __init__(self, ev: FutureEvaluator, chain: G.ChainProgram, machinery):
        self.ev, self.chain = ev, chain
        d_, v_ = ev.num_stages, ev.interleave
        self.d_, self.v_, self.m_ = d_, v_, chain.num_items
        self.fb = chain.feedback
        (self.cell_fn, self.init_state, self.const_state, self.mutable,
         self.split_states) = machinery
        self.local = ev.local_cells
        self.group = axis_group(ev.axis_name, ev.mesh)
        _, self.rank, self.next, self.prev = ring_peers(self.group)

        if self.local and chain.num_cells % v_:
            raise ValueError(f"this rank's num_cells={chain.num_cells} must be a multiple of "
                             f"interleave {v_} (its {v_} virtual stages)")
        if not self.local and chain.num_cells % (d_ * v_):
            raise ValueError(f"num_cells={chain.num_cells} not divisible by axis "
                             f"'{ev.axis_name}' size {d_} x interleave {v_}")
        c = chain.num_cells // (v_ if self.local else d_ * v_)  # cells a virtual stage

        # The zips: every one on a virtual-stage boundary, post-pipeline
        # merges after the loop.  A chain of this rank's cells names no
        # other rank's boundary, so it takes zips at its entry only.
        pipelined, self.tail, positions = [], [], []
        for inj in chain.injections:
            if inj.cell_index >= chain.num_cells and inj.combine is not None:
                self.tail.append(inj)
            elif self.local and inj.cell_index != 0:
                raise ValueError(
                    "a local_cells chain holds only this rank's cells, so it takes zips at its "
                    "entry or after its last cell; give every rank the whole chain for an "
                    "interior zip")
            elif inj.cell_index % c:
                raise ValueError(
                    f"zip injection at cell {inj.cell_index} does not fall on a virtual-stage "
                    f"boundary (cells_per_group={c}, D={d_}, V={v_}); move the zip or change "
                    f"the stage split")
            else:
                pipelined.append(inj)
                positions.append(inj.cell_index // c)
        self.plan = ev.plan_for(self.m_, tuple(positions),
                                feedback_lag=self.fb.lag if self.fb else None)
        self.sources = [inj.materialize() for inj in pipelined]
        for s, src in enumerate(self.sources):
            G.leading_axis_size(src, f"source {s} items")
        self.combines = [inj.combine for inj in pipelined]
        self.entry = [s for s in range(1, len(self.sources)) if positions[s] == 0]
        self.interior = [s for s in range(1, len(self.sources)) if positions[s] != 0]

        # This rank's rows of each of its virtual stages: views.
        d = self.rank
        self.cells = ev._rank_cells(d, c)
        starts = [v * c for v in range(v_)] if self.local else self.cells[::c]
        self.rows_in = [P.tree_map(lambda l, a=a: l[a:a + c], self.init_state) for a in starts]
        self.consts = [P.tree_map(lambda l, a=a: l[a:a + c], self.const_state) for a in starts]
        self.rows = list(self.rows_in)
        ev._ranked_layout = (tuple(s.num_cells for s in chain.segments), c, self.local)

        # The flowing item: what the entry zips make of a source item
        # (under feedback they must keep the primary item's structure).
        first = self._item(0, 0)
        if self.fb is None:
            for s in self.entry:
                first = self.combines[s](first, self._item(s, 0))
        self.template, self.out_def = P.flatten(first)
        self.s_leaves, self.s_def = P.flatten(self.init_state)
        self.x_leaves, self.x_def = P.flatten(self.sources[0])
        self.units: dict = {}  # (p, m) -> what the unit's backward reads
        self.sends: list = []  # the batches in flight and the tensors they send

    def _item(self, s: int, m: int) -> PyTree:
        return P.tree_map(lambda x: x[m], self.sources[s])

    def needs_grad(self) -> bool:
        """Whether autograd records the run: grad mode on and a state,
        const or source leaf that requires grad."""
        leaves = P.leaves((self.init_state, self.const_state, self.sources))
        return torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in leaves)

    def check_backward_scope(self) -> None:
        if not (self.local and len(self.sources) == 1 and not self.tail and self.fb is None
                and not self.mutable and self.const_state is None):
            raise ValueError(
                "autograd through a FutureEvaluator across ranks runs local_cells chains of "
                "one source with immutable cell state (mutable_state=False), no const_state "
                "and no feedback (the training shape: one stream of microbatches, each rank "
                "its own stages); run this chain under torch.no_grad() or with the "
                "LazyEvaluator")

    def final_states(self) -> tuple:
        """This rank's cells' final states, one per segment."""
        if self.local:
            return self.split_states(G.join_parts(self.init_state, self.rows_in, self.rows))
        mine = P.tree_map(lambda *parts: parts[0] if len(parts) == 1 else torch.cat(parts),
                          *self.rows)
        return G.split_rows(self.chain, mine, self.cells)

    # -- hops --------------------------------------------------------------

    def _layout(self, tree) -> PyTree:
        """``tree``'s leaves laid out as the flowing item's (a DTensor
        redistributed to the item leaf's placements, a partial sum
        reduced; autograd-aware)."""
        from repro_torch.parallel.sharding import is_dtensor

        leaves = P.leaves(tree)
        if len(leaves) != len(self.template):
            raise ValueError("a unit's output must have the flowing item's structure")
        return P.unflatten(self.out_def, [
            x.redistribute(t.device_mesh, t.placements)
            if is_dtensor(x) and tuple(x.placements) != tuple(t.placements) else x
            for x, t in zip(leaves, self.template)])

    def _received(self, bufs: list) -> PyTree:
        return P.unflatten(self.out_def, [like_local(b, t) for b, t in zip(bufs, self.template)])

    def _hop(self, sends, recvs, got: dict, backward: bool) -> None:
        """One tick's batch: ``sends`` ``[(key, value)]`` to the next
        rank (the previous one ``backward``), ``recvs`` ``[key]`` from
        the other side, each received value a :class:`Future` in
        ``got[key]``; a key is the ``(virtual stage, item)`` of the unit
        that reads the value.  On an axis of size 1 a sent value is
        received at once."""
        if self.d_ == 1:
            for key, value in sends:
                got[key] = Future(value)
            return
        to, frm = (self.prev, self.next) if backward else (self.next, self.prev)
        ops, held = [], []
        for (p, m), value in sends:
            locs = [to_local(x).detach().contiguous() for x in P.leaves(self._layout(value))]
            held += locs
            ops += [(t, to, hop_tag(p * self.m_ + m, i, backward)) for i, t in enumerate(locs)]
        bufs = {key: [torch.empty_like(to_local(t)) for t in self.template] for key in recvs}
        rops = [(b, frm, hop_tag(p * self.m_ + m, i, backward))
                for (p, m) in recvs for i, b in enumerate(bufs[p, m])]
        # NCCL coalesces a batch into one work (gloo gives one an op), so a
        # value received waits on the whole batch
        batch = P2PBatch(p2p(ops, rops, self.group))
        self.sends.append((batch, held))
        for key in recvs:
            got[key] = Future(self._received(bufs[key]), False, _works=[batch])

    def _drain(self) -> None:
        """Wait on every batch in flight (a rank that timed out raises)."""
        for batch, _ in self.sends:
            batch.wait()
        self.sends = []

    def _broadcast(self, values: list, owner: int) -> list:
        """Every item of ``values`` (given on axis index ``owner``, None
        elsewhere) on every rank, laid out as the flowing item: one
        broadcast a leaf, of the items stacked."""
        import torch.distributed as dist

        if self.d_ == 1:
            return values
        src = dist.get_global_rank(self.group, owner)
        if self.rank == owner:
            values = [self._layout(v) for v in values]
            cols = [torch.stack([to_local(x).detach() for x in col])
                    for col in zip(*[P.leaves(v) for v in values])]
        else:
            cols = [torch.empty((len(values),) + tuple(to_local(t).shape),
                                dtype=t.dtype, device=to_local(t).device) for t in self.template]
        for col in cols:
            dist.broadcast(col, src=src, group=self.group)
        if self.rank == owner:
            return values
        return [self._received([col[i] for col in cols]) for i in range(len(values))]

    # -- forward -------------------------------------------------------------

    def _rows(self, v: int, grad: list[bool]) -> list:
        """Virtual stage ``v``'s state rows, as leaves of their own where
        ``grad`` asks for their gradient."""
        return [leaf.detach().requires_grad_(True) if g else leaf
                for leaf, g in zip(P.leaves(self.rows_in[v]), grad)]

    def _apply(self, m: int, inp, rows) -> PyTree:
        out, _ = G.scan_cells(self.cell_fn, False, inp, None,
                              P.unflatten(self.s_def, rows), item=m)
        return self._layout(out)

    def _join(self) -> None:
        """One collective over the axis before the run's first p2p batch:
        NCCL needs every rank of a group in the group's first call, and a
        tick's batch holds only the ranks that send or receive then."""
        import torch.distributed as dist

        if self.d_ > 1:
            dist.all_reduce(torch.zeros(1, device=to_local(self.template[0]).device),
                            group=self.group)

    def _next(self, p: int, m: int):
        """The unit that reads what unit ``(p, m)`` makes: the next
        virtual stage's, or under feedback, from the last virtual stage,
        stage 0's of item ``m + lag``; None for an output that goes no
        further."""
        if p < self.d_ * self.v_ - 1:
            return (p + 1, m)
        if self.fb is not None and m + self.fb.lag < self.m_:
            return (0, m + self.fb.lag)
        return None

    def _input(self, t: int, p: int, m: int, got: dict) -> PyTree:
        """Unit ``(p, m)``'s input at tick ``t``: a fresh item of the
        primary source (merged with the entry zips' items), or what the
        previous unit handed over; then merged with the zips the plan
        consumes here."""
        plan, d = self.plan, self.rank
        if plan.read_slot[t, d] < 0:
            inp = self._item(0, m)
            if self.fb is None:
                for s in self.entry:
                    inp = self.combines[s](inp, self._item(s, m))
        else:
            inp = got.pop((p, m)).force()
        for s in (self.entry if self.fb is not None else []) + self.interior:
            if plan.src_consume[s, t] and d == plan.inject_devices[s]:
                merged = self.combines[s](inp, self._item(s, m))
                if (self.fb is not None and s in self.entry
                        and not G.structures_match(inp, merged)):
                    raise ValueError(
                        "entry zips on a feedback chain must preserve the primary item "
                        "structure (the fed-back item re-enters through the same combines)")
                inp = merged
        return inp

    def forward(self, record: str | None = None) -> list:
        """The F units in tick order; returns the outputs' leaves (every
        collected item, broadcast from the last rank).  ``record``
        (the backward's scope only): ``"graph"`` keeps each unit's graph,
        ``"stash"`` its input."""
        self._join()
        d, d_, plan = self.rank, self.d_, self.plan
        want_w = [t.requires_grad and t.is_floating_point() for t in self.s_leaves]
        want_x = any(t.requires_grad for t in self.x_leaves)
        got: dict = {}
        outs: list = [None] * self.m_
        for t in range(plan.num_ticks):
            sends, recvs = [], []
            m = int(plan.microbatch[t, d])
            if m >= 0:  # an idle tick runs no cell and writes nothing
                v = int(plan.group[t, d])
                p = v * d_ + d
                inp = self._input(t, p, m, got)
                if record == "graph":
                    rows = self._rows(v, want_w)
                    xs = [x.detach().requires_grad_(p > 0 or want_x) for x in P.leaves(inp)]
                    with torch.enable_grad():
                        out = self._apply(m, P.unflatten(self.x_def, xs), rows)
                    self.units[p, m] = (out, rows, xs)
                    out = P.tree_map(lambda x: x.detach(), out)
                elif record == "stash":
                    self.units[p, m] = inp
                    out = self._apply(m, inp, self._rows(v, [False] * len(want_w)))
                else:
                    out, self.rows[v] = G.scan_cells(
                        self.cell_fn, self.mutable, inp, self.consts[v], self.rows[v], item=m)
                    out = self._layout(out)
                if self.fb is not None and plan.emit[t, d]:
                    emitted = self.fb.emit(out)
                    G._check_emit_structure(out, emitted)
                    out = emitted
                if plan.collect[t, d]:
                    outs[m] = out
                key = self._next(p, m)
                if key is not None:
                    sends.append((key, out))
            # what rank d-1 makes at this tick for a unit of this rank
            dp = (d - 1) % d_
            mp = int(plan.microbatch[t, dp])
            if mp >= 0:
                key = self._next(int(plan.group[t, dp]) * d_ + dp, mp)
                if key is not None:
                    recvs.append(key)
            self._hop(sends, recvs, got, backward=False)
        self._drain()
        owner = (d_ * self.v_ - 1) % d_
        outs = self._broadcast(outs if d == owner else [None] * self.m_, owner)
        return P.leaves(G._stack(outs))

    # -- backward ------------------------------------------------------------

    def _bticks(self) -> list[list]:
        """Each backward tick's B unit ``(v, m)`` of every rank (None when
        idle): the forward plan in reverse tick order under
        ``"autodiff"``, the backward plan under ``"planned"``."""
        ev, d_ = self.ev, self.d_
        if ev.backward == "planned":
            plan = build_backward_plan(ev.schedule, d_, self.m_, self.v_, self.plan.handoff)
            ticks = range(plan.num_ticks)
        else:
            plan = self.plan
            ticks = range(plan.num_ticks - 1, -1, -1)
        return [[(int(plan.group[t, d]), int(plan.microbatch[t, d]))
                 if plan.microbatch[t, d] >= 0 else None for d in range(d_)] for t in ticks]

    def _recompute(self, v: int, m: int, inp, grad: list[bool], want_dx: bool):
        """A unit's forward again under autograd, from its stashed input,
        with no inner recomputation: (output, weight rows, input leaves)."""
        rows = self._rows(v, grad)
        xs = [x.detach().requires_grad_(want_dx) for x in P.leaves(inp)]
        token = G._NO_REMAT.set(True)
        try:
            with torch.enable_grad():
                out = self._apply(m, P.unflatten(self.x_def, xs), rows)
        finally:
            G._NO_REMAT.reset(token)
        return out, rows, xs

    def backward(self, d_outs: list, needs) -> tuple[list, list]:
        """The B units; returns the gradients of the state leaves and of
        the source leaves (None where none is needed).

        Each virtual stage's weight gradient is the sum of its items'
        contributions with the item descending -- autograd's order over
        the forward tick loop, so the gradients are bitwise the Lazy
        evaluator's -- summed as they come, so that no more than the
        running sum and one contribution are held.  Under ``"autodiff"``
        the reversed forward plan brings each stage's items in that
        order.  The backward plan brings them ascending, so under
        ``"planned"`` the B units compute the input cotangents only and
        keep their own; the weight contributions follow, a stage at a
        time with the item descending (W units after the B units, as
        ZB-H1 splits them), each recomputing its unit once more."""
        d, d_, v_, m_ = self.rank, self.d_, self.v_, self.m_
        last = d_ * v_ - 1
        n_s = len(self.s_leaves)
        need_s, need_x = needs[:n_s], needs[n_s:]
        diff = [i for i, leaf in enumerate(self.s_leaves)
                if need_s[i] and leaf.is_floating_point()]
        grad = [i in diff for i in range(n_s)]
        want_src = any(need_x)
        seeds = P.unflatten(self.out_def, d_outs)
        planned = self.ev.backward == "planned"
        got: dict = {}
        cots: dict = {}  # planned: (v, m) -> the unit's output cotangent
        sums: list = [None] * v_
        pending: dict = {}
        turn = [m_ - 1] * v_

        def add(v: int, m: int, dw: list) -> None:
            pending[v, m] = dw
            while turn[v] >= 0 and (v, turn[v]) in pending:
                part = pending.pop((v, turn[v]))
                sums[v] = part if sums[v] is None else [a + b for a, b in zip(sums[v], part)]
                turn[v] -= 1

        d_items: list = [None] * m_
        for row in self._bticks():
            sends, recvs = [], []
            if row[d] is not None:
                v, m = row[d]
                p = v * d_ + d
                g = (self._layout(P.tree_map(lambda c: c[m], seeds)) if p == last
                     else got.pop((p, m)).force())
                want_dx = p > 0 or want_src
                if planned:
                    cots[v, m] = g
                    dx = []
                    if want_dx:
                        out, _, xs = self._recompute(v, m, self.units[p, m],
                                                     [False] * n_s, True)
                        _, dx = _unit_grads(out, [], xs, g)
                else:
                    out, rows, xs = self.units.pop((p, m))
                    dw, dx = _unit_grads(out, [rows[i] for i in diff],
                                         xs if want_dx else [], g)
                    add(v, m, dw)
                if p > 0:
                    sends.append(((p - 1, m), P.unflatten(self.x_def, dx)))
                elif want_src:
                    d_items[m] = P.unflatten(self.x_def, dx)
            nd = (d + 1) % d_
            if row[nd] is not None and row[nd][0] * d_ + nd > 0:
                recvs.append((row[nd][0] * d_ + nd - 1, row[nd][1]))
            self._hop(sends, recvs, got, backward=True)
        self._drain()
        if planned and diff:
            for v in range(v_):
                for m in range(m_ - 1, -1, -1):
                    out, rows, _ = self._recompute(v, m, self.units.pop((v * d_ + d, m)),
                                                   grad, False)
                    dw, _ = _unit_grads(out, [rows[i] for i in diff], [], cots.pop((v, m)))
                    add(v, m, dw)

        d_state: list = [None] * n_s
        for j, i in enumerate(diff):
            parts = [sums[v][j] for v in range(v_)]
            d_state[i] = parts[0] if v_ == 1 else torch.cat(parts, dim=0)
        d_src = [None] * len(self.x_leaves)
        if want_src:
            d_items = self._broadcast(d_items if d == 0 else [None] * m_, 0)
            cols = [P.leaves(dx) for dx in d_items]
            d_src = [torch.stack([c[j] for c in cols]) if need_x[j] else None
                     for j in range(len(self.x_leaves))]
        return d_state, d_src


def _unit_grads(out, weights: list, xs: list, g) -> tuple[list, list]:
    """``torch.autograd.grad`` of one unit's ``out`` at cotangent ``g``
    with respect to its weight rows and its input leaves (zeros where
    unused)."""
    pairs = [(o, c) for o, c in zip(P.leaves(out), P.leaves(g))
             if isinstance(o, torch.Tensor) and o.requires_grad]
    inputs = weights + xs
    grads = [None] * len(inputs)
    if pairs and inputs:
        grads = list(torch.autograd.grad(
            [o for o, _ in pairs], inputs, [c for _, c in pairs], allow_unused=True))
    grads = [torch.zeros_like(t) if gr is None else gr for t, gr in zip(inputs, grads)]
    return grads[: len(weights)], grads[len(weights):]


class _Ranked(torch.autograd.Function):
    """The autograd node of a pipeline across ranks: the F units forward,
    the B units backward, both in tick order (:meth:`FutureEvaluator.
    _run_chain_ranked`)."""

    @staticmethod
    def forward(ctx, run: _RankRun, *flat):
        ctx.run = run
        return tuple(run.forward("stash" if run.ev.backward == "planned" else "graph"))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *d_outs):
        run = ctx.run
        ctx.run = None
        d_state, d_src = run.backward(list(d_outs), ctx.needs_input_grad[1:])
        return (None, *d_state, *d_src)


class _PlannedRun:
    """One planned run: the chain, its cell machinery and what the
    backward needs from the forward."""

    def __init__(self, ev: FutureEvaluator, chain: G.ChainProgram, machinery, num_state: int):
        self.ev, self.chain, self.machinery = ev, chain, machinery
        self.num_state = num_state
        self.out_def = None

    def forward(self, stash: dict) -> list:
        _, outs = self.ev._run_chain(self.chain, stash=stash, machinery=self.machinery)
        leaves, self.out_def = P.flatten(outs)
        return leaves

    def backward(self, stash: dict, d_outs, needs) -> tuple[list, list]:
        """The B units; returns the gradients of the state leaves and of
        the source leaves (None where none is needed)."""
        ev, chain = self.ev, self.chain
        d_, v_, m_ = ev.num_stages, ev.interleave, chain.num_items
        per_group = chain.num_cells // (d_ * v_)
        cell_fn, init_state, _, _, _ = self.machinery
        s_leaves, s_def = P.flatten(init_state)
        src = chain.injections[0].materialize()
        x_leaves, x_def = P.flatten(src)
        need_s, need_x = needs[: self.num_state], needs[self.num_state :]
        diff = [i for i, leaf in enumerate(s_leaves)
                if need_s[i] and leaf.is_floating_point()]
        want_src = any(need_x)
        bplan = build_backward_plan(ev.schedule, d_, m_, v_, ev.plan_for(m_).handoff)
        fwd_ticks = ev.plan_for(m_).num_ticks
        seeds = P.unflatten(self.out_def, d_outs)

        caller, streams = ev._streams(_device_of((d_outs, s_leaves)))
        if caller is not None:
            for st in streams:
                for t in _cuda_leaves(seeds):
                    t.record_stream(st)

        def unit(p: int, m: int, x, g, want_dx: bool):
            a, b = p * per_group, (p + 1) * per_group
            rows = [leaf[a:b].detach().requires_grad_(i in diff) if i in diff else leaf[a:b]
                    for i, leaf in enumerate(s_leaves)]
            xs = [leaf.detach().requires_grad_(want_dx) for leaf in P.leaves(x)]
            token = G._NO_REMAT.set(True)
            try:
                with torch.enable_grad():
                    out, _ = G.scan_cells(cell_fn, False, P.unflatten(x_def, xs), None,
                                          P.unflatten(s_def, rows), item=m)
            finally:
                G._NO_REMAT.reset(token)
            pairs = [(o, c) for o, c in zip(P.leaves(out), P.leaves(g))
                     if isinstance(o, torch.Tensor) and o.requires_grad]
            inputs = [rows[i] for i in diff] + (xs if want_dx else [])
            grads = [None] * len(inputs)
            if pairs and inputs:
                grads = list(torch.autograd.grad(
                    [o for o, _ in pairs], inputs, [c for _, c in pairs], allow_unused=True))
            grads = [torch.zeros_like(t) if gr is None else gr for t, gr in zip(inputs, grads)]
            dw = grads[: len(diff)]
            dx = P.unflatten(x_def, grads[len(diff):]) if want_dx else None
            return dw, dx

        dbuf = [[None] * bplan.num_slots for _ in range(d_)]
        staged: dict[tuple[int, int], list] = {}
        d_items: list = [None] * m_
        sent: list = [None] * d_
        try:
            for t in range(bplan.num_ticks):
                made: list = [None] * d_
                for d in range(d_):
                    m = int(bplan.microbatch[t, d])
                    if m < 0:
                        continue
                    p = int(bplan.group[t, d]) * d_ + d
                    with _on(streams[d]):
                        start = ev._start_unit(streams[d])
                        slot = int(bplan.read_slot[t, d])
                        if slot < 0:  # the last stage: the seed d_out[m]
                            g = P.tree_map(lambda c: c[m], seeds)
                        else:
                            if dbuf[d][slot] is None:
                                raise RuntimeError(
                                    f"plan fault: stage {d} reads an empty cotangent slot "
                                    f"{slot} at backward tick {t}"
                                )
                            g, dbuf[d][slot] = dbuf[d][slot].force(), None
                        dw, dx = unit(p, m, stash.pop((p, m)), g, p > 0 or want_src)
                        staged[p, m] = dw
                        if bplan.collect[t, d]:
                            d_items[m] = dx
                        ev._end_unit(streams[d], start, d, fwd_ticks + t)
                    made[d] = ppermute_future(dx, streams[d])
                # The reverse hop: a stage receives from its successor.
                for d in range(d_):
                    slot = int(bplan.recv_slot[t, d])
                    if slot >= 0:
                        dbuf[d][slot] = sent[(d + 1) % d_]
                sent = made
        finally:
            if caller is not None:
                for st in streams:
                    caller.wait_stream(st)
        if caller is not None:
            for t in _cuda_leaves((staged, d_items)):
                t.record_stream(caller)

        # Per stage, the items' contributions summed with the item
        # descending: autograd's order over the forward tick loop.
        d_state: list = [None] * len(s_leaves)
        for j, i in enumerate(diff):
            parts = []
            for p in range(d_ * v_):
                acc = staged[p, m_ - 1][j]
                for m in range(m_ - 2, -1, -1):
                    acc = acc + staged[p, m][j]
                parts.append(acc)
            d_state[i] = torch.cat(parts, dim=0)
        d_src = [None] * len(x_leaves)
        if want_src:
            cols = [P.leaves(dx) for dx in d_items]
            d_src = [torch.stack([c[j] for c in cols]) if need_x[j] else None
                     for j in range(len(x_leaves))]
        return d_state, d_src


class _Planned(torch.autograd.Function):
    """The planned backward's autograd node: the F units forward, the
    B units backward (:meth:`FutureEvaluator._run_chain_planned`)."""

    @staticmethod
    def forward(ctx, run: _PlannedRun, *flat):
        stash: dict = {}
        leaves = run.forward(stash)
        ctx.run, ctx.stash = run, stash
        return tuple(leaves)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *d_outs):
        run, stash = ctx.run, ctx.stash
        ctx.stash = None
        d_state, d_src = run.backward(stash, list(d_outs), ctx.needs_input_grad[1:])
        return (None, *d_state, *d_src)


def _cuda_leaves(tree: PyTree) -> list[torch.Tensor]:
    return [t for t in P.leaves(tree) if isinstance(t, torch.Tensor) and t.is_cuda]


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
