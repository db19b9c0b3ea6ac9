"""Futures on one GPU: work issued on a side CUDA stream, forced by an event.

The paper's ``Future[A]`` is a handle to a value being produced
asynchronously, forced by ``Await.result``.  The JAX package pins an XLA
scheduling edge; on a CUDA device the counterpart is concurrency the
card really has:

1. **Stream futures** (:class:`Future`, :func:`defer`): ``defer(f, *args)``
   makes a side stream wait on the caller's stream (so ``args`` are
   ready), issues ``f`` there and records an event.  ``force()`` makes
   the caller's current stream wait on that event -- an ordering on the
   card, with no host sync -- so work the caller issues between
   ``defer`` and ``force`` overlaps ``f``.  Tensors that cross streams
   are marked with ``Tensor.record_stream``, so that the caching
   allocator does not hand their memory to another stream while the
   other one may still read it.  The side stream is one per device
   unless the caller passes ``stream=``.  Where no argument is a CUDA
   tensor (and no stream is given), ``f`` runs at once on the caller's
   stream: on the CPU a future is its value.
2. **Ring hand-offs** (:func:`ppermute_future`): the pipeline's hop
   from stage d to stage d+1.  The reference permutes the value over a
   mesh axis; on one card the value stays where it is, and what crosses
   is the ordering: an event recorded on the producing stage's stream,
   which the consuming stage's stream waits on when it forces the
   future.  Stage d's stream is :func:`stage_stream`, one per (device,
   stage), made once and reused.
3. **Collective futures** (:func:`all_gather_future`,
   :func:`psum_scatter_future`): the collective is issued now with
   ``async_op=True`` over the process group of one axis of a
   ``DeviceMesh`` (the reference's ``axis_name`` under ``shard_map``),
   and ``force()`` waits on its work.  On NCCL that wait makes the
   caller's current stream wait on the collective -- an ordering, with
   no host sync, as for the stream futures; on gloo it blocks the host.
   The future holds the collective's input and output tensors until it
   is forced.
   :func:`ring_hop_future` is the ring hop across ranks: each rank's
   value goes to the next rank of a mesh axis (``isend``/``irecv``),
   the reference's ``ppermute`` over a mesh axis; differentiated, the
   cotangent goes back along the reverse ring.
4. **Host futures** (:class:`HostFuture`): a thin wrapper over
   ``concurrent.futures`` for host work (data prefetch, checkpoint
   writes).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Any, Callable

import torch

from repro_torch import pytree as P

PyTree = Any

# One side stream per CUDA device, made on first use.
_SIDE_STREAMS: dict[int, torch.cuda.Stream] = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The default side stream ``defer`` issues on for ``device``."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(device=index)
    return _SIDE_STREAMS[index]


# The pipeline's stage streams: one per (CUDA device, stage), made on
# first use.
_STAGE_STREAMS: dict[tuple[int, int], torch.cuda.Stream] = {}


def stage_stream(device: torch.device, stage: int) -> torch.cuda.Stream:
    """The CUDA stream that runs pipeline stage ``stage`` on ``device``."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    key = (index, stage)
    if key not in _STAGE_STREAMS:
        _STAGE_STREAMS[key] = torch.cuda.Stream(device=index)
    return _STAGE_STREAMS[key]


def _cuda_tensors(tree: PyTree) -> list[torch.Tensor]:
    return [t for t in P.leaves(tree) if isinstance(t, torch.Tensor) and t.is_cuda]


@dataclasses.dataclass
class Future:
    """A value plus, on a CUDA device, the event that marks it ready on
    the side stream that produces it (``None``: ready on the caller's
    stream already), or the works of the collectives that produce it
    (with their inputs, held until the future is forced)."""

    _value: PyTree
    _forced: bool = False
    _event: torch.cuda.Event | None = None
    _stream: torch.cuda.Stream | None = None
    _works: list | None = None
    _held: PyTree = None
    _hop: "_Hop | None" = None

    def map(self, f: Callable[[PyTree], PyTree]) -> "Future":
        """The Lazy/Future monad's ``map`` — forwards the asynchrony: ``f``
        is issued on the producing stream, after the value.  A
        collective's future is forced first (on NCCL an ordering on the
        caller's stream, no host sync)."""
        if self._works:
            self.force()
        if self._stream is None or self._forced:
            return Future(f(self._value), self._forced)
        with torch.cuda.stream(self._stream):
            value = f(self._value)
            event = torch.cuda.Event()
            event.record(self._stream)
        return Future(value, False, event, self._stream)

    def flat_map(self, f: Callable[[PyTree], "Future"]) -> "Future":
        """``f`` returns a Future; it runs on the producing stream, so
        whatever it issues there is ordered after the value."""
        if self._works:
            self.force()
        if self._stream is None or self._forced:
            return f(self._value)
        with torch.cuda.stream(self._stream):
            return f(self._value)

    def force(self, anchor: PyTree | None = None) -> PyTree:
        """Await.result, on the card: the caller's current stream waits
        on the value's event (no host sync), and the value's tensors are
        marked as used by that stream.

        ``anchor`` is accepted for the reference's signature: there it
        ties the completion after the anchor's computation for XLA's
        scheduler.  Here the anchor's work, issued on the caller's stream
        before ``force``, already overlaps the side stream's, and the
        caller's later work is ordered after both.
        """
        del anchor
        if self._works:
            for work in self._works:
                work.wait()
            if self._hop is not None:
                self._value = self._land_hop()
            self._works, self._held, self._hop = None, None, None
        if self._event is not None and not self._forced:
            current = torch.cuda.current_stream(self._stream.device)
            current.wait_event(self._event)
            for t in _cuda_tensors(self._value):
                t.record_stream(current)
        self._forced = True
        return self._value

    def _land_hop(self) -> PyTree:
        """A ring hop's received buffers as the value: linked to the sent
        leaves where autograd records, laid out as the sent leaves are."""
        flat, treedef = self._held
        bufs = self._value
        if torch.is_grad_enabled() and any(t.requires_grad for t in self._hop.sent):
            bufs = list(_RingHop.apply(self._hop, *bufs, *self._hop.sent))
        return P.unflatten(treedef, [like_local(b, leaf) for b, leaf in zip(bufs, flat)])


def defer(f: Callable[..., PyTree], *args, stream: torch.cuda.Stream | None = None,
          **kwargs) -> Future:
    """Issue ``f(*args, **kwargs)`` now; force its result later (the
    paper's ``future``).  On a CUDA device ``f`` runs on ``stream`` (the
    device's side stream by default) once the caller's stream has
    produced the arguments; elsewhere it runs at once."""
    inputs = _cuda_tensors((args, kwargs))
    if stream is None:
        if not inputs:
            return Future(f(*args, **kwargs))
        stream = _side_stream(inputs[0].device)
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    for t in inputs:
        t.record_stream(stream)
    with torch.cuda.stream(stream):
        value = f(*args, **kwargs)
        event = torch.cuda.Event()
        event.record(stream)
    return Future(value, False, event, stream)


def ppermute_future(x: PyTree, stream: torch.cuda.Stream | None = None) -> Future:
    """The ring hop of the pipeline, issued now and forced by the next
    stage (the counterpart of the reference's ``ppermute_future``).

    ``x`` was issued on ``stream`` (the producing stage's); an event is
    recorded there now.  The consumer forces the future under its own
    stream, which then waits on the event and marks ``x``'s tensors as
    used by it, so neither the order nor the caching allocator lets it
    read memory too early.  Without a stream (the CPU, where stages run
    in tick order) the future is the value."""
    if stream is None:
        return Future(x)
    event = torch.cuda.Event()
    event.record(stream)
    return Future(x, False, event, stream)


def axis_group(axis_name: str, mesh=None):
    """The process group of ``mesh``'s axis ``axis_name`` (``mesh``
    defaults to the one ``parallel.sharding.set_mesh`` set)."""
    from repro_torch.parallel import sharding as SH

    mesh = SH.ACTIVE_MESH if mesh is None else mesh
    if mesh is None:
        raise ValueError(f"no mesh for axis {axis_name!r}: pass mesh= or use set_mesh")
    return mesh.get_group(axis_name)


# Leaves a hop may carry: the leaf index is the low bits of its tag.
_LEAF_BITS = 10


def hop_tag(tag: int, leaf: int, backward: bool = False) -> int:
    """The p2p tag of leaf ``leaf`` of hop ``tag``, in one direction: gloo
    matches a receive to a send by (peer, tag); NCCL ignores tags and
    matches by the order of issue, so every rank issues its hops in one
    order that both ends of each pair share."""
    if leaf >= 1 << _LEAF_BITS:
        raise ValueError(f"a hop carries at most {1 << _LEAF_BITS} leaves")
    return ((2 * tag + int(backward)) << _LEAF_BITS) | leaf


def p2p(sends, recvs, group) -> list:
    """Issue ``sends`` ``[(tensor, peer, tag)]`` and ``recvs`` ``[(buffer,
    peer, tag)]`` (peers are global ranks) as one batch over ``group``
    (one NCCL group call, so that two ranks sending to each other do not
    wait on each other); returns the works, [] for no message: one a
    message on gloo, one for the whole batch on NCCL, so a receive is
    complete only once every work of its batch is."""
    import torch.distributed as dist

    ops = ([dist.P2POp(dist.isend, t, peer, group, tag) for t, peer, tag in sends]
           + [dist.P2POp(dist.irecv, t, peer, group, tag) for t, peer, tag in recvs])
    return dist.batch_isend_irecv(ops) if ops else []


class P2PBatch:
    """The works of one :func:`p2p` batch, waited on once however many
    futures share it (waiting twice on a gloo p2p work blocks: it waits
    for another message)."""

    def __init__(self, works: list):
        self._works = works

    def wait(self) -> None:
        for work in self._works:
            work.wait()
        self._works = []


def ring_peers(group, reverse: bool = False) -> tuple[int, int, int, int]:
    """``(size, index, next, previous)`` on ``group``'s ring: the axis
    size, this rank's index on it, and the global ranks one step along
    the ring and one step back (``reverse`` swaps the direction)."""
    import torch.distributed as dist

    size, idx = dist.get_world_size(group), dist.get_rank(group)
    step = -1 if reverse else 1
    return (size, idx, dist.get_global_rank(group, (idx + step) % size),
            dist.get_global_rank(group, (idx - step) % size))


def to_local(x) -> torch.Tensor:
    """A DTensor's local shard (autograd-aware), else ``x``."""
    from repro_torch.parallel.sharding import is_dtensor

    return x.to_local() if is_dtensor(x) else x


def like_local(local: torch.Tensor, like):
    """``local`` laid out as the DTensor ``like`` is (its shard on this
    rank; autograd-aware), else ``local``."""
    from repro_torch.parallel.sharding import is_dtensor

    if not is_dtensor(like):
        return local
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


@dataclasses.dataclass
class _Hop:
    """What the backward of a forced :func:`ring_hop_future` needs: the
    ring's group and ends, the tag, and the local tensors sent."""

    group: Any
    to: int
    frm: int
    tag: int
    sent: list


class _RingHop(torch.autograd.Function):
    """The received leaves, linked to the sent ones: the backward sends
    the received leaves' cotangent back to the rank they came from and
    receives the sent leaves' cotangent from the rank they went to (the
    transpose of a ring ``ppermute`` is the reverse ring)."""

    @staticmethod
    def forward(ctx, hop: _Hop, *leaves):
        ctx.hop = hop
        return tuple(r.clone() for r in leaves[: len(hop.sent)])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        hop = ctx.hop
        bufs = [torch.empty_like(t) for t in hop.sent]
        works = p2p([(g.contiguous(), hop.frm, hop_tag(hop.tag, i, True))
                     for i, g in enumerate(grads)],
                    [(b, hop.to, hop_tag(hop.tag, i, True)) for i, b in enumerate(bufs)],
                    hop.group)
        for w in works:
            w.wait()
        return (None, *[None] * len(grads), *bufs)


def ring_hop_future(x: PyTree, axis_name: str, *, mesh=None, reverse: bool = False,
                    tag: int = 0) -> Future:
    """The ring hop across the ranks of a mesh axis, issued now and forced
    where the value is used: every rank's ``x`` goes to the next rank of
    the axis (the previous one with ``reverse``), and the future's value
    is what the previous rank sent -- the reference's ``ppermute`` over
    a mesh axis.  Each leaf's local shard travels (a DTensor's shard on
    this rank goes to the same ``(data, model)`` coordinate of the next
    rank, and is laid out there as ``x``'s leaf is here).  ``tag`` tells
    concurrent hops apart on gloo; NCCL matches them by order, so ranks
    that issue several must issue them in one order.

    ``force()`` waits on the works (on NCCL an ordering of the caller's
    stream; on gloo the host waits).  Forced under autograd, the value is
    linked to ``x``: differentiating through it sends the cotangent back
    along the reverse ring and receives ``x``'s from the next rank, so
    the backward is a collective of the axis too: every rank must
    differentiate through the value it forced.  On an axis of size 1 the
    hop is the value itself and no p2p is issued (torch's ``send``
    refuses the caller's own rank, and NCCL two ranks on one GPU)."""
    group = axis_group(axis_name, mesh)
    size, _, to, frm = ring_peers(group, reverse)
    if size == 1:
        return Future(x)
    flat, treedef = P.flatten(x)
    sent = [to_local(leaf).contiguous() for leaf in flat]
    bufs = [torch.empty_like(t) for t in sent]
    works = p2p([(t, to, hop_tag(tag, i)) for i, t in enumerate(sent)],
                [(b, frm, hop_tag(tag, i)) for i, b in enumerate(bufs)], group)
    return Future(bufs, False, _works=works, _held=(flat, treedef),
                  _hop=_Hop(group, to, frm, tag, sent))


def _collective_future(x: PyTree, issue: Callable) -> Future:
    """``issue(leaf) -> (out, work)`` for every tensor leaf of ``x``, as
    one future over the outputs."""
    flat, treedef = P.flatten(x)
    outs, works = [], []
    for leaf in flat:
        out, work = issue(leaf.contiguous())
        outs.append(out)
        works.append(work)
    return Future(P.unflatten(treedef, outs), False, _works=works, _held=flat)


def all_gather_future(x: PyTree, axis_name: str, *, tiled: bool = True, mesh=None) -> Future:
    """Start an all-gather of each rank's ``x`` over the mesh axis; force
    at the use site to overlap.  ``tiled``: the shards concatenated on
    dim 0 (``lax.all_gather(tiled=True)``), else stacked on a new dim 0."""
    import torch.distributed as dist

    group = axis_group(axis_name, mesh)
    size = dist.get_world_size(group)

    def issue(v):
        out = v.new_empty((size * v.shape[0],) + tuple(v.shape[1:]))
        work = dist.all_gather_into_tensor(out, v, group=group, async_op=True)
        return (out if tiled else out.view((size,) + tuple(v.shape))), work

    return _collective_future(x, issue)


def psum_scatter_future(x: PyTree, axis_name: str, *, mesh=None) -> Future:
    """Start a reduce-scatter (sum over the axis, rank i keeping block i
    of dim 0: ``lax.psum_scatter(tiled=True)``); force at the use site to
    overlap."""
    import torch.distributed as dist

    group = axis_group(axis_name, mesh)
    size = dist.get_world_size(group)

    def issue(v):
        if v.shape[0] % size:
            raise ValueError(f"dim 0 of {tuple(v.shape)} does not split over {size} ranks")
        out = v.new_empty((v.shape[0] // size,) + tuple(v.shape[1:]))
        work = dist.reduce_scatter_tensor(out, v, op=dist.ReduceOp.SUM, group=group,
                                          async_op=True)
        return out, work

    return _collective_future(x, issue)


class HostFuture:
    """Host-side future (data prefetch, async checkpoint writes)."""

    _pool = concurrent.futures.ThreadPoolExecutor(max_workers=4)

    def __init__(self, fn: Callable[[], Any]):
        self._fut = self._pool.submit(fn)

    def map(self, f: Callable[[Any], Any]) -> "HostFuture":
        fut = self._fut
        return HostFuture(lambda: f(fut.result()))

    def done(self) -> bool:
        return self._fut.done()

    def force(self, timeout: float | None = None) -> Any:
        return self._fut.result(timeout=timeout)
