"""Stream combinator algebra and the StreamGraph IR (PyTorch).

The port of ``repro.core.graph``: the same algebra, IR, lowering and
sequential executors, run eagerly on tensors.  ``lax.scan`` becomes
:func:`scan`, a Python loop whose outputs are stacked; ``lax.map``
becomes a loop over items; ``lax.switch`` becomes an index into a tuple
of branches (the unified chain keeps its segment ids and positions on
the host); ``jax.checkpoint`` becomes ``torch.utils.checkpoint`` while
grad is enabled.  Every data-dependent choice inside a cell stays a
tensor op, so a chain on a CUDA device runs without syncing the host.

Every executor advances an item through its cells with
:func:`scan_cells`, which differs from ``lax.scan`` in two ways that
eager code needs.  A cell may update its state row in place and return
that same row: the row is then neither written back nor copied (a
decode cell's state is the KV cache).  And the index of the item in the
stream is known on the host while a cell runs (:func:`current_item`),
so a cell can pick a slice of its state without a device offset.

The paper's claim is that *any* algorithm expressible as a Stream
computation parallelizes by monad substitution.  Real Stream programs
compose — the paper's own examples are written with ``map``/``filter``/
``zip``-style combinators — so the public front door is an algebra, not a
single linear chain:

    Stream.source(items)            # a bounded stream of M items
          .map(f)                   # stateless per-item transform
          .through(cell_fn, states) # a chain segment of dependent cells
          .zip(other, combine)      # merge two streams item-by-item
          .concat(other)            # one stream after another
          .mask(pred)               # bounded-stream validity tagging
          .collect(evaluator)       # run it

    Stream.feedback(init, n, emit)  # a self-feeding (unfold) source:
          .through(cell_fn, states) # item b >= lag re-enters as
          .collect(evaluator)       # emit(item b-lag after the chain)

Combinators build a typed **StreamGraph IR** — a DAG of
:class:`SourceNode` / :class:`MapNode` / :class:`SegmentNode` /
:class:`ZipNode` / :class:`ConcatNode` / :class:`MaskNode` /
:class:`FeedbackNode` — validated at construction (item counts, state
shapes, pytree structure for ``concat``).

``Stream.feedback`` is the unfold/feedback combinator: the stream's
item ``b`` (for ``b >= lag``) is not read from a source — it is
``emit(o)`` where ``o`` is item ``b - lag``'s output *after the whole
downstream chain*.  This is what a serving decode loop is: the sampled
token re-enters as the next item, KV-cache rows ride in the chain's
per-cell state, and ``lag`` (the number of in-flight microbatches)
is what keeps a pipeline of dependent steps busy.  Feedback graphs
have no node-local evaluation order, so :func:`lazy_eval_graph`
rejects them; both evaluators run them through the lowered
:class:`ChainProgram` (:func:`run_chain_sequential` is the sequential
reference executor).
Adjacent ``map``s fuse at construction (``s.map(f).map(g)`` builds the
same one-node IR as ``s.map(g ∘ f)``), the first of the algebra's laws
tested in ``tests/test_stream_algebra.py``.

Two execution paths share the IR:

* :func:`lazy_eval_graph` — the Lazy monad: topological composition of
  scans, one per node.  Runs *any* well-formed graph, including zips
  whose both sides carry stateful segments.
* :func:`lower_chain` — compiles the graph into a :class:`ChainProgram`
  (fused chain segments + per-source injection points), the form a
  pipelined evaluator executes and :func:`run_chain_sequential` runs in
  order.  Supported graphs are those in *spine normal form*: one trunk
  of segments, where every ``zip`` merges in a stateless branch
  (source + maps).  A ``zip`` of two stateful pipelines has no
  linear-pipeline realization; lowering raises with a pointer to
  ``LazyEvaluator``.

Push-fusion of stateless stages into their consumers is the classic
stream-API optimization (Clash of the Lambdas, arXiv 1406.6631); the
deterministic merge semantics of ``zip``/``concat`` follow the
stream-ordering discipline of arXiv 2504.02975 — item *b* of a zip is
``combine(left[b], right[b])``, independent of evaluator or schedule.
"""
from __future__ import annotations

import contextvars
import dataclasses
from typing import Any, Callable

import torch
# torch.utils.checkpoint imports torch._dynamo on its first call, and that
# import keeps every frame above it alive for the life of the process:
# the first train step's parameters, activations and gradients with
# them (24 GB at full-width OLMo-1B).  Imported here, it keeps only
# module frames.
import torch._dynamo  # noqa: F401
import torch.utils.checkpoint

from repro_torch import pytree as P

PyTree = Any
CellFn = Callable[[PyTree, PyTree], tuple[PyTree, PyTree]]


# ---------------------------------------------------------------------------
# Scans (lax.scan / lax.map)
# ---------------------------------------------------------------------------


def _stack(items: list) -> PyTree:
    """Stack a list of equally structured pytrees along a new leading axis."""
    return P.tree_map(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]), *items)


def scan(f: Callable, init: PyTree, xs: PyTree, length: int | None = None):
    """``lax.scan``: ``carry, y = f(carry, x)`` over the leading axis of
    ``xs`` (``None`` with ``length`` items), returning the last carry and
    the stacked ``y``s (``None`` when ``f`` yields ``None``)."""
    n = length if length is not None else leading_axis_size(xs, "scan xs")
    if n < 1:
        raise ValueError("a scan needs >= 1 item")
    leaves, treedef = P.flatten(xs)
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, P.unflatten(treedef, [leaf[i] for leaf in leaves]))
        ys.append(y)
    return carry, (None if ys[0] is None else _stack(ys))


# ---------------------------------------------------------------------------
# Validation helpers
# ---------------------------------------------------------------------------


def leading_axis_size(items: PyTree, what: str = "items") -> int:
    """Common leading-axis length of every leaf, with clear errors.

    Raises ``ValueError`` on an empty pytree or on leaves that disagree
    about the leading axis (the stream length M must be unambiguous).
    """
    leaves = P.leaves(items)
    if not leaves:
        raise ValueError(f"{what} is an empty pytree; a stream needs >= 1 leaf")
    sizes = set()
    for leaf in leaves:
        shape = getattr(leaf, "shape", None)
        if not shape:
            raise ValueError(
                f"{what} leaves must be arrays with a leading stream axis; "
                f"got scalar leaf {leaf!r}"
            )
        sizes.add(shape[0])
    if len(sizes) != 1:
        raise ValueError(
            f"{what} leaves disagree on the leading (stream) axis: sizes "
            f"{sorted(sizes)}; every leaf must have the same number of items"
        )
    return sizes.pop()


def _tree_structure(items: PyTree):
    return P.structure(items)


def _check_concat_structures(lv: PyTree, rv: PyTree) -> None:
    if _tree_structure(lv) != _tree_structure(rv):
        raise ValueError(
            "concat requires both streams to share one item pytree "
            f"structure, got {_tree_structure(lv)} vs {_tree_structure(rv)}"
        )


def _concat_items(lv: PyTree, rv: PyTree) -> PyTree:
    """Leaf-wise leading-axis concatenation, with the one shared error."""
    _check_concat_structures(lv, rv)
    return P.tree_map(lambda a, b: torch.cat([a, b], dim=0), lv, rv)


def _item_skeleton(node: "Node") -> PyTree | None:
    """A zero-filled pytree with the node's per-item structure, when it is
    statically derivable (sources, masks, concats); ``None`` once a user
    function (map/zip/segment) whose output structure we cannot know
    intervenes."""
    if isinstance(node, SourceNode):
        return P.tree_map(lambda _: 0, node.items)
    if isinstance(node, MaskNode):
        up = _item_skeleton(node.upstream)
        return None if up is None else {"valid": 0, "value": up}
    if isinstance(node, ConcatNode):
        return _item_skeleton(node.left)  # sides validated at construction
    return None


def apply_per_item(fn: Callable[[PyTree], PyTree], items: PyTree) -> PyTree:
    """Apply a per-item ``fn`` across the leading stream axis.

    One call per item (``lax.map``), not a batched call: every executor
    applies per-item transforms with the same op sequence per item.
    """
    return scan(lambda _, item: (None, fn(item)), None, items)[1]


# ---------------------------------------------------------------------------
# IR nodes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Node:
    """Base IR node; identity (not structure) keyed, so graphs are DAGs."""


@dataclasses.dataclass(frozen=True, eq=False)
class SourceNode(Node):
    items: PyTree
    num_items: int


@dataclasses.dataclass(frozen=True, eq=False)
class MapNode(Node):
    fn: Callable[[PyTree], PyTree]
    upstream: Node


@dataclasses.dataclass(frozen=True, eq=False)
class MaskNode(Node):
    """Bounded-stream validity: item -> {"value": item, "valid": pred(item)}.

    Unbounded streams do not exist in shape-static code; validity masks are how bounded
    streams express "the tail past here is not real data".
    """

    pred: Callable[[PyTree], torch.Tensor]
    upstream: Node


@dataclasses.dataclass(frozen=True, eq=False)
class SegmentNode(Node):
    """A chain segment: ``num_cells`` dependent cells with stacked state.

    ``const_state`` holds *read-only* per-cell leaves (layer parameters,
    admission payloads — anything the cells consult but never write).
    Evaluators thread it as scan ``xs`` only: it never enters a scan
    carry, a conditional's output, or a per-tick state write-back, so it
    is never copied on the hot path.  With ``const_state`` given, the
    cell signature is ``cell_fn(const, state, item) -> (state', item')``.
    """

    cell_fn: CellFn
    init_state: PyTree
    num_cells: int
    mutable_state: bool
    remat: bool
    upstream: Node
    const_state: PyTree | None = None


@dataclasses.dataclass(frozen=True, eq=False)
class FeedbackNode(Node):
    """A self-feeding source: the unfold combinator.

    The first ``lag`` items are ``init_items``; item ``b >= lag`` is
    ``emit(out[b - lag])`` where ``out[j]`` is item ``j``'s value after
    the *entire* downstream chain.  ``emit`` must preserve the flowing
    item structure (the fed-back value travels the same shape-static
    ring buffers as every inter-cell hand-off), and the emitted item is
    also the collected output item — under feedback the stream's
    outputs *are* what re-enters it.
    """

    init_items: PyTree
    num_items: int
    lag: int
    emit: Callable[[PyTree], PyTree]


@dataclasses.dataclass(frozen=True, eq=False)
class ZipNode(Node):
    left: Node
    right: Node
    combine: Callable[[PyTree, PyTree], PyTree]


@dataclasses.dataclass(frozen=True, eq=False)
class ConcatNode(Node):
    left: Node
    right: Node


def topo_nodes(sink: Node) -> list[Node]:
    """All nodes reachable from ``sink``, dependencies first."""
    order: list[Node] = []
    seen: set[int] = set()

    def visit(node: Node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for dep in _inputs(node):
            visit(dep)
        order.append(node)

    visit(sink)
    return order


def _inputs(node: Node) -> tuple[Node, ...]:
    if isinstance(node, (MapNode, MaskNode, SegmentNode)):
        return (node.upstream,)
    if isinstance(node, (ZipNode, ConcatNode)):
        return (node.left, node.right)
    return ()


def _num_items(node: Node) -> int:
    if isinstance(node, SourceNode):
        return node.num_items
    if isinstance(node, FeedbackNode):
        return node.num_items
    if isinstance(node, (MapNode, MaskNode, SegmentNode)):
        return _num_items(node.upstream)
    if isinstance(node, ZipNode):
        return _num_items(node.left)
    if isinstance(node, ConcatNode):
        return _num_items(node.left) + _num_items(node.right)
    raise TypeError(f"unknown node {node!r}")


# ---------------------------------------------------------------------------
# The algebra
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamResult:
    """What :meth:`Stream.collect` returns.

    Attributes:
      items: the collected output items (leading axis = stream length).
      states: final per-segment states, in spine (upstream-to-downstream,
        left-to-right) order — one entry per ``.through`` in the program.
    """

    items: PyTree
    states: tuple[PyTree, ...]


class Stream:
    """A composable bounded stream — the algebra's handle onto the IR.

    Streams are immutable; every combinator returns a new ``Stream``
    sharing the upstream graph.  Nothing executes until
    :meth:`collect`.
    """

    def __init__(self, node: Node):
        self._node = node

    # -- constructors -------------------------------------------------------

    @staticmethod
    def source(items: PyTree) -> "Stream":
        """A stream of M items: every leaf's leading axis is the stream."""
        m = leading_axis_size(items, "source items")
        return Stream(SourceNode(items=items, num_items=m))

    @staticmethod
    def feedback(
        init_items: PyTree,
        num_items: int,
        emit: Callable[[PyTree], PyTree],
    ) -> "Stream":
        """A self-feeding stream (the unfold combinator).

        ``init_items`` (leading axis = ``lag``) are the first ``lag``
        inputs; item ``b >= lag`` is ``emit(out[b - lag])``, where
        ``out[j]`` is item ``j`` after the whole downstream chain.  The
        emitted item is also the collected output item, so ``emit`` must
        be structure-preserving on the flowing item.  ``lag`` is the
        feedback depth — for a pipelined decode loop, the number of
        independent in-flight microbatches that keeps the stages busy
        while each one's next step waits on its own previous output.
        """
        lag = leading_axis_size(init_items, "feedback init_items")
        if num_items < lag:
            raise ValueError(
                f"feedback num_items={num_items} must be >= lag={lag} "
                "(the init items are the first lag items of the stream)"
            )
        return Stream(
            FeedbackNode(
                init_items=init_items, num_items=num_items, lag=lag, emit=emit
            )
        )

    @staticmethod
    def from_program(program, items: PyTree) -> "Stream":
        """Adapter for the deprecated single-chain :class:`StreamProgram`.

        .. deprecated::
            Build the one-segment graph directly:
            ``Stream.source(items).through(p.cell_fn, p.init_state, ...)``.
        """
        import warnings

        warnings.warn(
            "Stream.from_program is deprecated; use "
            "Stream.source(items).through(cell_fn, init_state, ...)",
            DeprecationWarning,
            stacklevel=2,
        )
        return Stream.source(items).through(
            program.cell_fn,
            program.init_state,
            num_cells=program.num_cells,
            mutable_state=program.mutable_state,
            remat=program.remat,
        )

    # -- combinators --------------------------------------------------------

    def through(
        self,
        cell_fn: CellFn,
        init_state: PyTree,
        *,
        num_cells: int | None = None,
        mutable_state: bool = True,
        remat: bool = False,
        const_state: PyTree | None = None,
    ) -> "Stream":
        """A chain segment: ``num_cells`` dependent cells, item-ordered.

        ``cell_fn(state, item) -> (state', item')``; ``init_state`` leaves
        are stacked with leading axis ``num_cells`` (inferred when not
        given).  Segments compose back-to-back: ``s.through(f, a).through
        (g, b)`` is a longer chain, pipelined as one by a Future evaluator.

        ``const_state`` threads *read-only* per-cell leaves (leading axis
        ``num_cells``) to the cells as scan ``xs`` only — never written
        back, never carried, never copied per tick.  The cell signature
        becomes ``cell_fn(const, state, item) -> (state', item')``; final
        states returned by :meth:`collect` cover the mutable
        ``init_state`` only.  This is the read-only/mutable state split:
        layer parameters ride ``const_state``, the KV cache rides
        ``init_state``.
        """
        inferred = leading_axis_size(init_state, "init_state")
        if num_cells is None:
            num_cells = inferred
        elif inferred != num_cells:
            raise ValueError(
                f"init_state leaves must have leading axis num_cells="
                f"{num_cells}, got {inferred}"
            )
        if num_cells < 1:
            raise ValueError(f"num_cells must be >= 1, got {num_cells}")
        if const_state is not None:
            const_cells = leading_axis_size(const_state, "const_state")
            if const_cells != num_cells:
                raise ValueError(
                    f"const_state leaves must have leading axis num_cells="
                    f"{num_cells}, got {const_cells}"
                )
        return Stream(
            SegmentNode(
                cell_fn=cell_fn,
                init_state=init_state,
                num_cells=num_cells,
                mutable_state=mutable_state,
                remat=remat,
                upstream=self._node,
                const_state=const_state,
            )
        )

    def map(self, fn: Callable[[PyTree], PyTree]) -> "Stream":
        """Stateless per-item transform.  Adjacent maps fuse at
        construction: ``s.map(f).map(g)`` builds one ``MapNode`` computing
        ``g ∘ f`` — the same IR as ``s.map(lambda x: g(f(x)))``."""
        node = self._node
        if isinstance(node, MapNode):
            inner = node.fn
            fused = _compose(fn, inner)
            return Stream(MapNode(fn=fused, upstream=node.upstream))
        return Stream(MapNode(fn=fn, upstream=node))

    def mask(self, pred: Callable[[PyTree], torch.Tensor]) -> "Stream":
        """Tag each item with validity: item -> {"value", "valid"}.

        The bounded-stream concession made explicit: downstream cells see
        which lanes are real.  ``pred`` maps an item to a boolean (or
        boolean array over the item's lanes)."""
        return Stream(MaskNode(pred=pred, upstream=self._node))

    def zip(
        self,
        other: "Stream",
        combine: Callable[[PyTree, PyTree], PyTree],
    ) -> "Stream":
        """Item-by-item merge of two equal-length streams.

        Deterministic by construction: item ``b`` of the result is
        ``combine(self[b], other[b])`` under every evaluator and schedule
        — parallel sources merge in source order, never arrival order."""
        m_l, m_r = _num_items(self._node), _num_items(other._node)
        if m_l != m_r:
            raise ValueError(
                f"zip requires equal stream lengths, got {m_l} vs {m_r}"
            )
        return Stream(ZipNode(left=self._node, right=other._node, combine=combine))

    def concat(self, other: "Stream") -> "Stream":
        """This stream's items, then ``other``'s.  Associative:
        ``(a ++ b) ++ c`` and ``a ++ (b ++ c)`` produce identical items."""
        ls, rs = _item_skeleton(self._node), _item_skeleton(other._node)
        if ls is not None and rs is not None:
            _check_concat_structures(ls, rs)
        return Stream(ConcatNode(left=self._node, right=other._node))

    # -- execution ----------------------------------------------------------

    @property
    def num_items(self) -> int:
        return _num_items(self._node)

    @property
    def num_cells(self) -> int:
        """Total chain length along the spine (0 for segment-free graphs)."""
        return sum(
            n.num_cells for n in topo_nodes(self._node) if isinstance(n, SegmentNode)
        )

    @property
    def node(self) -> Node:
        return self._node

    def nodes(self) -> list[Node]:
        """The IR, dependencies first (for inspection and law tests)."""
        return topo_nodes(self._node)

    def collect(self, evaluator=None) -> StreamResult:
        """Run the program.  ``None`` → the Lazy monad (sequential)."""
        if evaluator is None:
            from repro_torch.core.stream import LazyEvaluator

            evaluator = LazyEvaluator()
        return evaluator.run_graph(self)

    def lower(self) -> "ChainProgram":
        """Compile to the linear-chain form a pipelined evaluator executes."""
        return lower_chain(self._node)


def _compose(outer, inner):
    return lambda item: outer(inner(item))


def _mask_fn(pred):
    return lambda item: {"value": item, "valid": pred(item)}


# ---------------------------------------------------------------------------
# Lazy execution: topological scan composition
# ---------------------------------------------------------------------------


# Set while a planned backward recomputes a unit: the unit is itself the
# recomputation, so a remat cell runs plainly inside it.
_NO_REMAT: contextvars.ContextVar[bool] = contextvars.ContextVar("no_remat", default=False)


def _checkpoint(fn: Callable) -> Callable:
    """``jax.checkpoint``: recompute ``fn`` on the backward pass instead
    of keeping its activations, when grad is enabled (a plain call
    otherwise, and inside a planned backward's unit)."""

    def run(*args):
        if torch.is_grad_enabled() and not _NO_REMAT.get():
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    return run


def _const_cell(cell_fn: CellFn, has_const: bool) -> CellFn:
    """Canonical 3-arg cell ``(const, state, item) -> (state', item')``.

    Segments without ``const_state`` get an adapter ignoring the (empty)
    const row, so every executor threads one signature: const rides scan
    ``xs``, state rides the carry/ys.
    """
    if has_const:
        return cell_fn
    return lambda _const, state, item: cell_fn(state, item)


def scan_cell(cell_fn: CellFn, mutable: bool):
    """The one cell body every executor uses: carry = the flowing item,
    xs = ``(const_row, state_row)``, ys = the (possibly frozen) new state
    row.  A single definition site — Lazy ≡ Future bit-equality rests on
    the per-cell op sequence being identical, so the wrapper must never
    fork per executor; :func:`scan_cells` runs it."""

    def cell(flowing, xs):
        cst, state = xs
        new_state, out = cell_fn(cst, state, flowing)
        if not mutable:
            new_state = state
        return out, new_state

    return cell


# The stream index of the item a cell call advances (None outside one).
_ITEM: contextvars.ContextVar[int | None] = contextvars.ContextVar("item", default=None)


def current_item() -> int:
    """The index in the stream of the item the running cell advances, on
    the host.  :func:`scan_cells` sets it for every cell call, under every
    executor, so a cell may use it to pick its slice of the state (the
    decode cell's microbatch) where the reference reads a device value."""
    item = _ITEM.get()
    if item is None:
        raise RuntimeError("current_item() is defined only inside a cell call")
    return item


def scan_cells(cell_fn: CellFn, mutable: bool, flowing: PyTree, const: PyTree,
               states: PyTree, item: int | None = None) -> tuple[PyTree, PyTree]:
    """Advance ``flowing`` through the cells whose rows ``states`` stacks
    (and ``const``, when not None), in order: the cell loop of every
    executor.  Returns ``(out, new_states)``.

    The rows a cell is handed are views of ``states``.  A cell that
    updates its row in place and returns that same row costs nothing
    more: where every cell returned its own row, the leaf of
    ``new_states`` is the leaf of ``states`` itself -- nothing written
    back, nothing copied.  A leaf returned as a new tensor is stacked, as
    ``lax.scan`` stacks its ys.  ``item`` (the stream index of
    ``flowing``) is what :func:`current_item` returns during each call.
    """
    cell = scan_cell(cell_fn, mutable)
    s_leaves, s_def = P.flatten(states)
    c_leaves, c_def = P.flatten(const)
    rows_out: list[list] = [[] for _ in s_leaves]
    kept = [True] * len(s_leaves)
    token = _ITEM.set(item)
    try:
        for i in range(s_leaves[0].shape[0]):
            rows = [leaf[i] for leaf in s_leaves]
            flowing, new = cell(
                flowing,
                (P.unflatten(c_def, [leaf[i] for leaf in c_leaves]), P.unflatten(s_def, rows)),
            )
            got_leaves = P.leaves(new)
            if len(got_leaves) != len(rows):
                raise ValueError(
                    f"a cell returned a state of {len(got_leaves)} leaves for a "
                    f"state of {len(rows)}; the state's structure is fixed"
                )
            for j, (row, got) in enumerate(zip(rows, got_leaves)):
                rows_out[j].append(got)
                kept[j] = kept[j] and got is row
    finally:
        _ITEM.reset(token)
    leaves = [
        leaf if same else torch.stack([torch.as_tensor(r) for r in rs])
        for leaf, same, rs in zip(s_leaves, kept, rows_out)
    ]
    return flowing, P.unflatten(s_def, leaves)


def join_parts(whole: PyTree, parts_in: list, parts_out: list) -> PyTree:
    """Reassemble a state cut into consecutive slices of its leading axis
    (``parts_in``, views of ``whole``) from what :func:`scan_cells` made
    of each (``parts_out``): a leaf that every part kept is ``whole``'s
    own leaf; any other is concatenated in order."""
    w_leaves, w_def = P.flatten(whole)
    ins = [P.leaves(p) for p in parts_in]
    outs = [P.leaves(p) for p in parts_out]
    leaves = []
    for j, leaf in enumerate(w_leaves):
        if all(o[j] is i[j] for i, o in zip(ins, outs)):
            leaves.append(leaf)
        else:
            got = [o[j] for o in outs]
            leaves.append(got[0] if len(got) == 1 else torch.cat(got, dim=0))
    return P.unflatten(w_def, leaves)


def _run_segment(node: SegmentNode, items: PyTree) -> tuple[PyTree, PyTree]:
    """The Lazy monad on one segment: scan items (outer) over cells (inner).

    ``const_state`` (when present) is delivered per cell as inner-scan
    xs alongside the mutable rows — read-only by construction (no ys, no
    carry, no write-back)."""
    cell_fn = _const_cell(node.cell_fn, node.const_state is not None)
    if node.remat:
        cell_fn = _checkpoint(cell_fn)
    const = node.const_state  # None is an empty pytree: scans thread it
    index = iter(range(leading_axis_size(items)))

    def item_step(states, item):
        out, new_states = scan_cells(
            cell_fn, node.mutable_state, item, const, states, item=next(index)
        )
        return new_states, out

    return scan(item_step, node.init_state, items)


def lazy_eval_graph(sink: Node) -> tuple[PyTree, tuple[PyTree, ...]]:
    """Execute the IR node-by-node in topological order.

    Returns ``(out_items, segment_final_states)`` with states ordered by
    the topological position of their ``SegmentNode``s.  Runs any
    well-formed graph — including zips of two stateful pipelines that the
    chain lowering rejects.
    """
    values: dict[int, PyTree] = {}
    seg_states: list[PyTree] = []
    for node in topo_nodes(sink):
        if isinstance(node, FeedbackNode):
            raise TypeError(
                "feedback graphs have no node-local evaluation order "
                "(item b depends on item b-lag through the whole chain); "
                "run them through the lowered ChainProgram — "
                "run_chain_sequential (Lazy) or FutureEvaluator"
            )
        if isinstance(node, SourceNode):
            leading_axis_size(node.items, "source items")
            values[id(node)] = node.items
        elif isinstance(node, MapNode):
            values[id(node)] = apply_per_item(node.fn, values[id(node.upstream)])
        elif isinstance(node, MaskNode):
            values[id(node)] = apply_per_item(
                _mask_fn(node.pred), values[id(node.upstream)]
            )
        elif isinstance(node, SegmentNode):
            states, outs = _run_segment(node, values[id(node.upstream)])
            seg_states.append(states)
            values[id(node)] = outs
        elif isinstance(node, ZipNode):
            pair = (values[id(node.left)], values[id(node.right)])
            values[id(node)] = apply_per_item(lambda ab: node.combine(*ab), pair)
        elif isinstance(node, ConcatNode):
            values[id(node)] = _concat_items(
                values[id(node.left)], values[id(node.right)]
            )
        else:  # pragma: no cover
            raise TypeError(f"unknown node {node!r}")
    return values[id(sink)], tuple(seg_states)


# ---------------------------------------------------------------------------
# Chain lowering: spine normal form for the pipeline engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChainSegment:
    """One fused run of dependent cells in the lowered chain."""

    cell_fn: CellFn
    init_state: PyTree
    num_cells: int
    mutable_state: bool
    remat: bool
    # Fused stateless transform applied to each item entering the segment
    # (a spine map pushed into its consumer — Clash-of-the-Lambdas-style
    # push fusion).  Must preserve the flowing item structure.
    pre_fn: Callable[[PyTree], PyTree] | None = None
    # Read-only per-cell leaves (scan xs only — see SegmentNode).
    const_state: PyTree | None = None


@dataclasses.dataclass(frozen=True)
class ChainInjection:
    """One source feeding the chain at a given cell boundary.

    ``cell_index`` 0 injects at the chain entry; interior indices merge
    into the flow via ``combine(flowing, source_item)`` right before that
    cell; ``cell_index == num_cells`` merges after the last cell
    (post-pipeline).  ``combine is None`` only for the primary source.
    ``materialize()`` returns the prepared items (source + fused maps),
    computed once — never replicated per stage.
    """

    materialize: Callable[[], PyTree]
    cell_index: int
    combine: Callable[[PyTree, PyTree], PyTree] | None


@dataclasses.dataclass(frozen=True)
class ChainFeedback:
    """Feedback closure of a lowered chain.

    ``injections[0].materialize()`` yields the ``lag`` init items; item
    ``b >= lag`` is ``emit(out[b - lag])`` — with any tail maps of the
    spine already composed *into* ``emit``, because the emitted item is
    both what re-enters the chain and what is collected.
    """

    lag: int
    emit: Callable[[PyTree], PyTree]


@dataclasses.dataclass(frozen=True)
class ChainProgram:
    """Spine-normal-form program: what a pipelined evaluator runs.

    ``injections[0]`` is the primary source (combine ``None``); every
    other injection carries the zip combine that merges it in.  The
    flowing item structure is fixed from the entry on (ring buffers are
    shape-static), so interior combines must be structure-preserving.

    With ``feedback`` set, the primary source holds only the first
    ``feedback.lag`` items; the rest of the stream unfolds from its own
    outputs (``finalize`` is always ``None`` then — tail maps fold into
    the emit).
    """

    segments: tuple[ChainSegment, ...]
    injections: tuple[ChainInjection, ...]
    finalize: Callable[[PyTree], PyTree] | None
    num_cells: int
    num_items: int
    feedback: ChainFeedback | None = None


def _pure_feed(node: Node):
    """A stateless branch (source + maps/masks/concats/zips of such):
    returns a ``materialize`` closure, or None if the branch has state."""
    if isinstance(node, SourceNode):
        return lambda: node.items
    if isinstance(node, MapNode):
        inner = _pure_feed(node.upstream)
        if inner is None:
            return None
        return lambda: apply_per_item(node.fn, inner())
    if isinstance(node, MaskNode):
        inner = _pure_feed(node.upstream)
        if inner is None:
            return None
        return lambda: apply_per_item(_mask_fn(node.pred), inner())
    if isinstance(node, ConcatNode):
        lf, rf = _pure_feed(node.left), _pure_feed(node.right)
        if lf is None or rf is None:
            return None
        return lambda: _concat_items(lf(), rf())
    if isinstance(node, ZipNode):
        lf, rf = _pure_feed(node.left), _pure_feed(node.right)
        if lf is None or rf is None:
            return None
        return lambda: apply_per_item(lambda ab: node.combine(*ab), (lf(), rf()))
    return None


def lower_chain(sink: Node) -> ChainProgram:
    """Compile a spine-normal-form graph to a :class:`ChainProgram`.

    Walks the spine from sink to root, fusing maps into their consumers:
    tail maps into ``finalize``, source-side maps into each injection's
    ``materialize``, interior spine maps into the downstream segment's
    ``pre_fn`` (or the downstream zip's combine).  A ``zip`` contributes
    an injection at the current cell boundary; its non-trunk side must be
    stateless.  Raises ``ValueError`` for graphs with no linear-pipeline
    realization (zip of two stateful pipelines) — run those under
    ``LazyEvaluator``, which executes the general DAG.
    """
    num_items = _num_items(sink)

    # Walk sink -> root (downstream to upstream), collecting spine ops in
    # reverse order.  Maps buffer in ``pending`` until the next spine op
    # up the walk reveals their producer: if the producer is the root
    # source they belong to its materialize (per-item prepare, free to
    # change structure); otherwise they fuse into the *downstream*
    # consumer recorded last (segment pre_fn / zip combine / finalize).
    rev_segments: list[ChainSegment] = []
    # (cells_after, combine, materialize), downstream-first.
    rev_injections: list[tuple[int, Callable, Callable]] = []
    finalize: Callable | None = None
    pending: list[Callable] = []  # maps since the last spine op, downstream-first
    consumer: str = "finalize"  # what the next flush attaches to
    cells_after = 0  # cells strictly downstream of the walk position

    def _composed() -> Callable:
        fns = list(pending)  # fns[0] applied last (it is the most downstream)
        g = fns[-1]
        for fn in reversed(fns[:-1]):
            g = _compose(fn, g)
        return g

    def _flush():
        nonlocal finalize, pending
        if not pending:
            return
        fn = _composed()
        if consumer == "finalize":
            # The walk leaves "finalize" after the first spine op, so this
            # flush happens at most once.
            assert finalize is None
            finalize = fn
        elif consumer == "segment":
            seg = rev_segments[-1]
            pre = fn if seg.pre_fn is None else _compose(seg.pre_fn, fn)
            rev_segments[-1] = dataclasses.replace(seg, pre_fn=pre)
        else:  # "zip": wrap the combine's flowing argument
            ca, combine, feed = rev_injections[-1]
            rev_injections[-1] = (
                ca,
                lambda flow, src, _f=fn, _c=combine: _c(_f(flow), src),
                feed,
            )
        pending = []

    node = sink
    while True:
        if isinstance(node, (MapNode, MaskNode)):
            fn = node.fn if isinstance(node, MapNode) else _mask_fn(node.pred)
            pending.append(fn)
            node = node.upstream
        elif isinstance(node, SegmentNode):
            _flush()
            rev_segments.append(
                ChainSegment(
                    cell_fn=node.cell_fn,
                    init_state=node.init_state,
                    num_cells=node.num_cells,
                    mutable_state=node.mutable_state,
                    remat=node.remat,
                    const_state=node.const_state,
                )
            )
            consumer = "segment"
            cells_after += node.num_cells
            node = node.upstream
        elif isinstance(node, ZipNode):
            _flush()
            feed, trunk, combine = _split_zip(node)
            if feed is None:
                raise ValueError(
                    "zip of two stateful pipelines has no linear-pipeline "
                    "form; evaluate this graph with LazyEvaluator instead"
                )
            rev_injections.append((cells_after, combine, feed))
            consumer = "zip"
            node = trunk
        elif isinstance(node, FeedbackNode):
            # Maps between the feedback root and the first spine op apply
            # to *every* entering item — init and fed-back alike — so they
            # fuse downstream (segment pre_fn / zip combine / finalize),
            # never into the init-items materialize.
            _flush()
            emit = node.emit
            if finalize is not None:
                # Tail maps run before the emit: the emitted item is both
                # the fed-back input and the collected output.
                tail, finalize = finalize, None
                emit = lambda x, _t=tail, _e=node.emit: _e(_t(x))
            return _finish_chain(
                rev_segments,
                rev_injections,
                finalize,
                lambda _n=node: _n.init_items,
                num_items,
                feedback=ChainFeedback(lag=node.lag, emit=emit),
            )
        elif isinstance(node, (SourceNode, ConcatNode)):
            feed = _pure_feed(node)
            if feed is None:
                raise ValueError(
                    "the spine's root must be a stateless branch (source + "
                    "maps/concats); a concat of stateful pipelines has no "
                    "linear-pipeline form — use LazyEvaluator"
                )
            if pending:  # maps directly above the root: prepare the feed
                fn = _composed()
                inner = feed
                feed = lambda _f=fn, _i=inner: apply_per_item(_f, _i())
            return _finish_chain(
                rev_segments, rev_injections, finalize, feed, num_items
            )
        else:  # pragma: no cover
            raise TypeError(f"unknown node {node!r}")


def _split_zip(node: ZipNode):
    """Pick the stateless side of a zip as the feed branch.

    Prefers ``right`` as the feed (``a.zip(b, f)`` reads "merge b into
    a"); if only ``left`` is stateless the combine's arguments flip so
    the surviving trunk stays the first argument.
    Returns ``(feed_materialize | None, trunk_node, combine)``.
    """
    right_feed = _pure_feed(node.right)
    if right_feed is not None:
        return right_feed, node.left, node.combine
    left_feed = _pure_feed(node.left)
    if left_feed is not None:
        c = node.combine
        return left_feed, node.right, (lambda flow, src, _c=c: _c(src, flow))
    return None, node, None


def _finish_chain(rev_segments, rev_injections, finalize,
                  primary_feed, num_items,
                  feedback: ChainFeedback | None = None) -> ChainProgram:
    segments = tuple(reversed(rev_segments))
    num_cells = sum(s.num_cells for s in segments)
    injections = [
        ChainInjection(materialize=primary_feed, cell_index=0, combine=None)
    ]
    # rev order = downstream-first; restore spine order (upstream-first) so
    # same-boundary combines fold in program order.
    for cells_after, combine, feed in reversed(rev_injections):
        cell_index = num_cells - cells_after
        if feedback is not None and num_cells > 0 and cell_index >= num_cells:
            raise ValueError(
                "a zip after the last cell of a feedback chain is "
                "ambiguous (the fed-back item would not see the merge); "
                "move the zip before the final segment"
            )
        injections.append(
            ChainInjection(
                materialize=feed, cell_index=cell_index, combine=combine,
            )
        )
    return ChainProgram(
        segments=segments,
        injections=tuple(injections),
        finalize=finalize,
        num_cells=num_cells,
        num_items=num_items,
        feedback=feedback,
    )


# ---------------------------------------------------------------------------
# Multi-segment state unification
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UnifiedChain:
    """One cell_fn + one stacked state for a multi-segment chain.

    The per-cell state is ``{"seg": i, "pos": k, "parts": (...,)}`` where
    ``parts[i]`` holds segment *i*'s state rows at that segment's cells
    (zeros elsewhere — the padding cost is why single-segment chains take
    the un-wrapped fast path).  ``seg`` and ``pos`` are int32 tensors on
    the host whatever the device of the parts, so dispatching on them
    never syncs with a device.  ``cell_fn`` dispatches on ``seg`` by
    indexing a tuple of branches (``lax.switch``), applying a segment's
    fused ``pre_fn`` only at its first cell, so per-cell compute stays
    one segment's cell.  ``split_states(final)`` recovers per-segment
    final states.

    ``const_state`` mirrors the same padded-parts layout for segments'
    read-only state (``None`` when no segment has any): the unified
    ``cell_fn`` is the canonical 3-arg form, with the const row arriving
    as scan xs — never carried, never written back.
    """

    cell_fn: CellFn
    init_state: PyTree
    num_cells: int
    mutable_state: bool
    remat: bool
    split_states: Callable[[PyTree], tuple[PyTree, ...]]
    const_state: PyTree | None = None


def _check_pre_fn_structure(item, got) -> None:
    """A fused pre_fn runs at a segment's first cell only (identity
    elsewhere), so it must keep the flowing item's pytree
    structure and leaf shapes/dtypes — surface that contract as a clear
    error."""
    if not structures_match(item, got):
        raise ValueError(
            "a mid-spine map/mask fused into a segment must preserve the "
            "flowing item structure (the pipeline's ring buffers are "
            f"shape-static), got {_tree_structure(got)} from "
            f"{_tree_structure(item)}; structure-changing transforms "
            "between segments have no linear-pipeline form — evaluate "
            "this graph with LazyEvaluator instead"
        )


def unify_segments(segments: tuple[ChainSegment, ...]) -> UnifiedChain:
    """Fuse heterogeneous segments into one scannable chain."""
    num_cells = sum(s.num_cells for s in segments)
    offsets = []
    off = 0
    for s in segments:
        offsets.append(off)
        off += s.num_cells

    seg_id = torch.cat(
        [torch.full((s.num_cells,), i, dtype=torch.int32) for i, s in enumerate(segments)]
    )
    pos = torch.cat(
        [torch.arange(s.num_cells, dtype=torch.int32) for s in segments]
    )

    def _pad(leaf, i):
        before = leaf.new_zeros((offsets[i],) + tuple(leaf.shape[1:]))
        after = leaf.new_zeros((num_cells - offsets[i] - leaf.shape[0],) + tuple(leaf.shape[1:]))
        return torch.cat([before, leaf, after], dim=0)

    parts = tuple(
        P.tree_map(lambda l, _i=i: _pad(l, _i), s.init_state)
        for i, s in enumerate(segments)
    )
    init_state = {"seg": seg_id, "pos": pos, "parts": parts}

    any_const = any(s.const_state is not None for s in segments)
    const_state = None
    if any_const:
        const_state = {
            "parts": tuple(
                None
                if s.const_state is None
                else P.tree_map(lambda l, _i=i: _pad(l, _i), s.const_state)
                for i, s in enumerate(segments)
            )
        }

    cell_fns = [
        _const_cell(s.cell_fn, s.const_state is not None)
        for s in segments
    ]
    cell_fns = [
        _checkpoint(fn) if s.remat else fn
        for fn, s in zip(cell_fns, segments)
    ]

    def branch(i):
        seg = segments[i]

        def run(crow, urow, item):
            it = item
            if seg.pre_fn is not None and int(urow["pos"]) == 0:
                it = seg.pre_fn(item)
            crow_i = crow["parts"][i] if any_const else None
            new_si, out = cell_fns[i](crow_i, urow["parts"][i], it)
            if not seg.mutable_state:
                new_si = urow["parts"][i]
            new_parts = urow["parts"][:i] + (new_si,) + urow["parts"][i + 1 :]
            return {**urow, "parts": new_parts}, out

        return run

    branches = tuple(branch(i) for i in range(len(segments)))
    unchecked = [s.pre_fn for s in segments if s.pre_fn is not None]

    def cell_fn(crow, urow, item):
        # Every pre_fn's structure is checked on the first call, whichever
        # branch it takes (as tracing every branch of a switch would).
        while unchecked:
            _check_pre_fn_structure(item, unchecked[0](item))
            unchecked.pop(0)
        return branches[int(urow["seg"])](crow, urow, item)

    def split_states(final_state):
        return tuple(
            P.tree_map(
                lambda l, _i=i, _s=s: l[offsets[_i] : offsets[_i] + _s.num_cells],
                final_state["parts"][i],
            )
            for i, s in enumerate(segments)
        )

    return UnifiedChain(
        cell_fn=cell_fn,
        init_state=init_state,
        num_cells=num_cells,
        mutable_state=any(s.mutable_state for s in segments),
        # remat is applied per-branch above, never re-wrapped outside.
        remat=False,
        split_states=split_states,
        const_state=const_state,
    )


# ---------------------------------------------------------------------------
# Sequential reference executor (feedback-capable)
# ---------------------------------------------------------------------------


def structures_match(ref, got) -> bool:
    """True when two pytrees agree on structure and leaf shapes/dtypes —
    the shape-static contract every ring-buffered value must satisfy.
    Single comparison site shared by the emit, pre_fn and entry-zip
    validators."""
    sig = lambda t: [
        (tuple(getattr(l, "shape", ())) if hasattr(l, "shape") else None,
         getattr(l, "dtype", None))
        for l in P.leaves(t)
    ]
    return _tree_structure(ref) == _tree_structure(got) and sig(ref) == sig(got)


def _check_emit_structure(item, emitted) -> None:
    """The feedback emit travels the same shape-static ring buffers as
    every inter-cell hand-off, so it must keep the flowing item's pytree
    structure and leaf shapes/dtypes."""
    if not structures_match(item, emitted):
        raise ValueError(
            "a feedback emit must preserve the flowing item structure "
            "(the emitted item re-enters the chain and is collected); "
            f"got {_tree_structure(emitted)} from {_tree_structure(item)}"
        )


def _chain_cell_machinery(chain: "ChainProgram"):
    """(cell_fn, init_state, const_state, mutable, split_states) for a
    lowered chain — the raw fast path for one plain segment, the
    branch-dispatched unified state otherwise.  ``cell_fn`` is always
    the canonical 3-arg form ``(const, state, item) -> (state', item')``;
    ``const_state`` is None for const-free chains (executors still pass
    it — None threads through scans as an empty pytree, so one call
    shape serves both)."""
    if not chain.segments:
        return None, (), None, False, lambda fs: ()
    if len(chain.segments) == 1 and chain.segments[0].pre_fn is None:
        seg = chain.segments[0]
        cell_fn = _const_cell(seg.cell_fn, seg.const_state is not None)
        if seg.remat:
            cell_fn = _checkpoint(cell_fn)
        return (
            cell_fn, seg.init_state, seg.const_state, seg.mutable_state,
            lambda fs: (fs,),
        )
    uni = unify_segments(chain.segments)
    return (
        uni.cell_fn, uni.init_state, uni.const_state, uni.mutable_state,
        uni.split_states,
    )


def row_runs(rows: list[int]) -> list[tuple[int, int]]:
    """``(first, count)`` of each run of consecutive values of ``rows``
    (ascending)."""
    runs: list[list[int]] = []
    for r in rows:
        if runs and runs[-1][0] + runs[-1][1] == r:
            runs[-1][1] += 1
        else:
            runs.append([r, 1])
    return [(a, n) for a, n in runs]


def take_rows(leaf: torch.Tensor, rows: list[int]) -> torch.Tensor:
    """``leaf``'s rows ``rows`` (ascending): one slice, a view, where they
    are consecutive, else the slices of each run joined -- never an index
    tensor, so never a copy from the host."""
    parts = [leaf[a:a + n] for a, n in row_runs(rows)]
    if not parts:
        return leaf[:0]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def split_rows(chain: "ChainProgram", rows: PyTree, cells: list[int]) -> tuple:
    """Per-segment states of some of a chain's cells: ``rows`` stacks the
    rows of :func:`_chain_cell_machinery`'s state at the chain cells
    ``cells`` (ascending); each segment gets its rows among them, in
    order (none where it has no cell there)."""
    if len(chain.segments) == 1 and chain.segments[0].pre_fn is None:
        return (rows,)
    out, off = [], 0
    for i, seg in enumerate(chain.segments):
        mine = [j for j, c in enumerate(cells) if off <= c < off + seg.num_cells]
        out.append(P.tree_map(lambda l, _j=mine: take_rows(l, _j), rows["parts"][i]))
        off += seg.num_cells
    return tuple(out)


def run_chain_sequential(chain: "ChainProgram") -> tuple[tuple, PyTree]:
    """Execute a lowered :class:`ChainProgram` item-by-item on one device.

    The Lazy monad over the *lowered* form: one scan over items, cells
    advanced by inner scans split only at interior injection boundaries.
    This is the executor that runs feedback chains sequentially
    (``lazy_eval_graph`` cannot — feedback has no node-local order): a
    ``lag``-deep FIFO holds the pending inputs, and each emitted item is
    both collected and pushed onto the FIFO's tail.

    Returns ``(segment_states, out_items)``, one final state per segment.
    """
    n = chain.num_items
    feeds = [inj.materialize() for inj in chain.injections]
    fb = chain.feedback
    cell_fn, init_state, const_state, mutable, split_states = (
        _chain_cell_machinery(chain)
    )

    entry = [
        i for i, inj in enumerate(chain.injections)
        if i > 0 and inj.cell_index == 0
    ]
    interior = [
        i for i, inj in enumerate(chain.injections)
        if 0 < inj.cell_index < chain.num_cells
    ]
    tail = [
        i for i, inj in enumerate(chain.injections)
        if i > 0 and chain.num_cells > 0 and inj.cell_index >= chain.num_cells
    ]
    boundaries = sorted({chain.injections[i].cell_index for i in interior})
    spans = list(
        zip([0] + boundaries, boundaries + [chain.num_cells])
    ) if chain.num_cells else []

    index = iter(range(n))

    def run_item(states, flow, src_items):
        b = next(index)
        for i in entry:
            flow = chain.injections[i].combine(flow, src_items[str(i)])
        parts_in, parts_out = [], []
        for lo, hi in spans:
            for i in interior:
                if chain.injections[i].cell_index == lo:
                    flow = chain.injections[i].combine(flow, src_items[str(i)])
            sub = P.tree_map(lambda l: l[lo:hi], states)
            sub_const = P.tree_map(lambda l: l[lo:hi], const_state)
            flow, new_sub = scan_cells(cell_fn, mutable, flow, sub_const, sub, item=b)
            parts_in.append(sub)
            parts_out.append(new_sub)
        if not parts_out:
            return states, flow
        return join_parts(states, parts_in, parts_out), flow

    src_xs = {
        str(i): feeds[i] for i in entry + interior
    }  # every non-primary source has n items

    if fb is not None:
        ring = [P.tree_map(lambda x, _j=j: x[_j], feeds[0]) for j in range(fb.lag)]

        def step(states, xs):
            flow = ring.pop(0)
            new_states, out = run_item(states, flow, xs)
            emitted = fb.emit(out)
            _check_emit_structure(flow, emitted)
            ring.append(emitted)
            return new_states, emitted

        final_states, outs = scan(step, init_state, src_xs or None, length=n)
        return split_states(final_states), outs

    def step(carry, xs):
        new_states, out = run_item(carry, xs["__primary__"], xs)
        return new_states, out

    xs = dict(src_xs)
    xs["__primary__"] = feeds[0]
    final_states, outs = scan(step, init_state, xs, length=n)
    for i in tail:
        outs = apply_per_item(
            lambda ab, _c=chain.injections[i].combine: _c(*ab),
            (outs, feeds[i]),
        )
    if chain.finalize is not None:
        outs = apply_per_item(chain.finalize, outs)
    return split_states(final_states), outs
