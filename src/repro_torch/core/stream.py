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

:class:`LazyEvaluator` implements them sequentially, on the device the
items and states lie on: the paper's Lazy monad.  The pipelined Future
evaluator of the JAX package (``FutureEvaluator``, the plan executor) is
not ported yet.

Streams are bounded, with ``.mask`` validity where needed: the paper
itself bounds the stream in its Future version.

**Migration note** — :class:`StreamProgram` survives as a thin
deprecated adapter over a one-segment graph::

    evaluate(StreamProgram(cell, states, n), items, ev)   # still works
    Stream.from_program(program, items).collect(ev)       # same thing
    Stream.source(items).through(cell, states).collect(ev)  # the new way
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import pytree as P
from repro_torch.core import graph as G
from repro_torch.core.graph import Stream, StreamResult

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

        cell_fn = (
            G._checkpoint(program.cell_fn) if program.remat else program.cell_fn
        )

        def item_step(states, item):
            def cell(flowing, state):
                new_state, out = cell_fn(state, flowing)
                if not program.mutable_state:
                    new_state = state
                return out, new_state

            out, new_states = G.scan(cell, item, states)
            return new_states, out

        return G.scan(item_step, program.init_state, items)


def evaluate(
    program,
    items: PyTree = None,
    evaluator: LazyEvaluator | None = None,
) -> tuple[PyTree, PyTree]:
    """Monad-substitution entry point: same program, pluggable evaluator.

    ``program`` is a :class:`Stream` (preferred; carries its own sources)
    or a deprecated :class:`StreamProgram` with ``items``.
    """
    evaluator = evaluator or LazyEvaluator()
    return evaluator(program, items)
