"""The paper's prime sieve (§5) as a Stream computation (PyTorch).

The port of ``repro.algorithms.sieve``.  Original (deliberately naive —
"it scans every divisor of a number up to the number itself", the paper
keeps it because it is *parallelizable*)::

    def sieve(s: Stream[Int]): Stream[Int] =
      s match { case head#::tail =>
        head#::tail.map(s => sieve(s.filter { _ % head != 0 })) }

i.e. a growing chain of filter cells, one per prime found.  SIMD
adaptation: candidates flow through the chain in *blocks* (bounded
stream, as the paper's own Future version: ``Stream.range(2, n, 1)``);
each cell owns up to ``primes_per_cell`` primes (the §7 chunk-size knob
— K=1 is the paper's original fine-grained cell).  A cell filters the
incoming block by its primes and claims new primes from the surviving
front of the block if it still has free slots.  Every choice in a cell
is a tensor op (``where``, ``argmax``), so a chain on the card never
syncs with the host.

In the combinator algebra the sieve is the canonical ``mask`` program::

    Stream.source(blocks).mask(lambda v: v < limit)
          .through(sieve_cell, primes_state)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.graph import Stream, scan


def sieve_cell(state, item):
    """One chain cell: state = claimed primes (K,), 0 = free slot.

    ``item`` is a masked block ``{"value": (B,), "valid": (B,)}`` as
    produced by ``Stream.mask``; surviving candidates keep their valid
    bit, eliminated composites lose it.
    """
    primes = state  # (K,)
    values, valid = item["value"], item["valid"]

    def slot(carry, p):
        values, valid = carry
        # If this slot already holds a prime, filter by it; otherwise
        # claim the first survivor (which is prime: it survived every
        # earlier prime's filter) and filter by it.
        has_any = valid.any()
        first = valid.to(torch.int32).argmax()  # first max, as jnp.argmax
        candidate = values.index_select(0, first.view(1)).view(())
        new_p = torch.where((p == 0) & has_any, candidate, p)
        keep = torch.where(
            new_p > 0,
            valid & (values % new_p.clamp(min=1) != 0),
            valid,
        )
        return (values, keep), new_p

    (values, valid), new_primes = scan(slot, (values, valid), primes)
    return new_primes, {"value": values, "valid": valid}


def sieve_stream(
    limit: int,
    *,
    block_size: int = 256,
    primes_per_cell: int = 1,
    num_cells: int | None = None,
    device: str | torch.device = "cuda",
) -> Stream:
    """The sieve as an algebra program: ``source . mask . through``, with
    the candidates and the prime slots on ``device``."""
    device = resolve_device(device)
    if num_cells is None:
        # Upper bound on pi(limit): enough cell slots to hold every prime.
        bound = int(_pi_upper_bound(limit))
        num_cells = -(-bound // primes_per_cell)
    n = limit - 2
    num_blocks = -(-n // block_size)
    values = np.arange(2, 2 + num_blocks * block_size, dtype=np.int32)
    blocks = torch.as_tensor(values.reshape(num_blocks, block_size), device=device)
    init = torch.zeros((num_cells, primes_per_cell), dtype=torch.int32, device=device)
    return (
        Stream.source(blocks)
        .mask(lambda v: v < limit)
        .through(sieve_cell, init, num_cells=num_cells)
    )


def run_sieve(
    limit: int,
    *,
    block_size: int = 256,
    primes_per_cell: int = 1,
    num_cells: int | None = None,
    evaluator=None,
    device: str | torch.device = "cuda",
):
    """All primes < ``limit``.  Returns (primes int32[num_slots], count),
    both tensors on ``device``; across the ranks of a mesh, on every
    rank."""
    stream = sieve_stream(
        limit,
        block_size=block_size,
        primes_per_cell=primes_per_cell,
        num_cells=num_cells,
        device=device,
    )
    return sieve_result(stream.collect(evaluator), evaluator)


def sieve_result(result, evaluator=None):
    """(primes, count) from a collected sieve stream.  The primes are the
    cells' states: a ``FutureEvaluator`` across ranks returns each rank's
    own cells only, so they are gathered over its axis first."""
    states = result.states
    if getattr(evaluator, "mesh", None) is not None:
        states = evaluator.gather_states(states)
    primes = states[0].reshape(-1)
    count = (primes > 0).sum()
    return primes, count


def _pi_upper_bound(limit: int) -> float:
    """pi(x) < 1.3 x / ln x for x >= 17 (Rosser–Schoenfeld)."""
    if limit < 17:
        return 8
    return 1.3 * limit / np.log(limit)


def reference_primes(limit: int) -> np.ndarray:
    """Classic Eratosthenes oracle (numpy, host)."""
    mask = np.ones(limit, bool)
    mask[:2] = False
    for p in range(2, int(limit**0.5) + 1):
        if mask[p]:
            mask[p * p :: p] = False
    return np.nonzero(mask)[0].astype(np.int32)
