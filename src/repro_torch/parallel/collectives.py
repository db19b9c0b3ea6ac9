"""Collective helpers: overlap idioms and ring primitives (port of
``repro.parallel.collectives``).

Each function runs on every rank of one axis of a ``DeviceMesh`` (the
mesh given, else the one ``sharding.set_mesh`` set), on that rank's
shard, as the reference runs under ``shard_map``.  The futures are the
collective futures of :mod:`repro_torch.core.future`: issued now with
``async_op=True``, forced where the value is used.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import pytree as P
from repro_torch.core.future import (
    Future,
    all_gather_future,
    axis_group,
    p2p,
    psum_scatter_future,
    ring_peers,
)

PyTree = Any


def ring_all_gather_overlapped(
    x: torch.Tensor,
    axis_name: str,
    compute_fn: Callable[[torch.Tensor, int], torch.Tensor],
    *,
    mesh=None,
):
    """All-gather by ring permute, overlapping ``compute_fn`` per shard.

    ``compute_fn(shard, slot)`` consumes each peer's shard as it arrives
    -- the paper's stream: each arriving shard is a cell, the in-flight
    hop is the future tail.  Hop h sends the shard in hand to the next
    rank and receives the previous rank's (``batch_isend_irecv``) while
    ``compute_fn`` runs on the shard in hand, which came from rank
    ``(idx - h) % size``.  Returns the per-hop results in that order, as
    the reference does.  (The reference's last hop moves a shard nobody
    reads; it is not issued here.)
    """
    group = axis_group(axis_name, mesh)
    size, idx, send_to, recv_from = ring_peers(group)
    results = []
    shard = x.contiguous()
    for hop in range(size):
        fut = None
        if hop + 1 < size:
            # start moving the next shard now (future) ...
            nxt = torch.empty_like(shard)
            works = p2p([(shard, send_to, 0)], [(nxt, recv_from, 0)], group)
            fut = Future(nxt, False, _works=works, _held=shard)
        # ... while computing on the current one
        results.append(compute_fn(shard, (idx - hop) % size))
        if fut is not None:
            shard = fut.force()
    return results


def reduce_scatter_then_all_gather(x: torch.Tensor, axis_name: str, *, mesh=None) -> Future:
    """The SP decomposition of an all-reduce: psum_scatter + all_gather.

    Splitting lets the two halves straddle the residual compute between
    them (Megatron sequence parallelism); callers place compute between
    the returned future's creation and force.
    """
    scattered = psum_scatter_future(x, axis_name, mesh=mesh).force()
    return all_gather_future(scattered, axis_name, mesh=mesh)


def pod_allreduce_compressed(grads: PyTree, axis_name: str, error: PyTree | None, *,
                             mesh=None):
    """Cross-pod gradient all-reduce in bf16 with error feedback: each
    leaf's bf16 cast is summed over the axis in bf16 and divided by the
    axis size in bf16 (``lax.pmean`` on the bf16 value), then upcast."""
    import torch.distributed as dist

    from repro_torch.train.compression import compress_decompress

    group = axis_group(axis_name, mesh)
    size = dist.get_world_size(group)
    q, new_error = compress_decompress(grads, error)

    def mean(g):
        h = g.to(torch.bfloat16)
        dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group)
        return (h / size).to(torch.float32)

    return P.tree_map(mean, q), new_error
