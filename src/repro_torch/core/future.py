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
            self._works, self._held = None, None
        if self._event is not None and not self._forced:
            current = torch.cuda.current_stream(self._stream.device)
            current.wait_event(self._event)
            for t in _cuda_tensors(self._value):
                t.record_stream(current)
        self._forced = True
        return self._value


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
