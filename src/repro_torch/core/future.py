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
3. **Host futures** (:class:`HostFuture`): a thin wrapper over
   ``concurrent.futures`` for host work (data prefetch, checkpoint
   writes).

The collective futures of the JAX package (``all_gather_future``,
``psum_scatter_future``) need several cards and are not ported yet.
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
    stream already)."""

    _value: PyTree
    _forced: bool = False
    _event: torch.cuda.Event | None = None
    _stream: torch.cuda.Stream | None = None

    def map(self, f: Callable[[PyTree], PyTree]) -> "Future":
        """The Lazy/Future monad's ``map`` — forwards the asynchrony: ``f``
        is issued on the producing stream, after the value."""
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
