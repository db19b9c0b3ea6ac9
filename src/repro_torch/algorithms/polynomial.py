"""Sparse multivariate polynomial multiplication as a Stream computation.

The port of ``repro.algorithms.polynomial``.  The paper's second example
(§6): multivariate polynomials in distributive representation,
multiplied by decomposing into a stream of multiply-by-a-term-and-add
operations::

    def times(x: T, y: T) = (zero /: y) { (l, r) => l + multiply(x, a, b) }

Representation:

* A polynomial is ``Poly(keys, coeffs)`` with capacity N: ``keys`` int32
  packed exponents (3 vars × 10 bits, graded by integer order — monomial
  product = key add), ``coeffs`` (N, L) limb integers
  (:mod:`repro_torch.algorithms.limb`).  Absent terms have
  ``key == EMPTY_KEY`` (int32 max) so sorts push them to the back, and
  zero coefficients.
* Terms are kept sorted ascending by key.  Sorts are stable
  (``torch.argsort(stable=True)``, as ``jnp.argsort``), so equal
  ``EMPTY_KEY`` lanes keep their order and results are bitwise the
  reference's.
* Cancellation clears a lane (key := EMPTY) — no blocking.

Stream decomposition (paper Fig. 2): a **two-source zip program** —

    Stream.source(x_chunks)                       # source 1: chunks of x
          .zip(Stream.source(acc_chunks), ...)    # source 2: accumulators
          .through(y_term_cells, y_state)         # cell j: chunk of y

    item b  = {x-chunk b, partial accumulator b}  (flows)
    cell j  = y-term-chunk j: acc_b += multiply(x_b, m_j, c_j)

Seeding the accumulator source with chunks of a third polynomial ``z``
computes the fused multiply-add ``x*y + z`` (:func:`times_into`).  Final
result = tree-add of the M partial accumulators.

The ``list`` control (paper's parallel-collections baseline [4]) is
:func:`times_dense`: one outer product + sort + segment-reduce.

Every op is a tensor op on the polynomials' device; none syncs with the
host (``masked_fill`` and ``index_select`` where a Python scalar or a
tensor index would otherwise be copied or read back).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import pytree as P
from repro_torch import resolve_device
from repro_torch.algorithms import limb
from repro_torch.core.chunking import chunk_axis
from repro_torch.core.graph import Stream, scan

EMPTY_KEY = np.int32(np.iinfo(np.int32).max)
_EMPTY = int(EMPTY_KEY)
VAR_BITS = 10
NUM_VARS = 3


@P.register_dataclass
@dataclasses.dataclass(frozen=True)
class Poly:
    """Sparse polynomial with fixed capacity; invalid slots key=EMPTY_KEY."""

    keys: torch.Tensor  # (N,) int32
    coeffs: torch.Tensor  # (N, L) int32 limbs

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def num_limbs(self) -> int:
        return self.coeffs.shape[-1]


def pack_key(exponents) -> int:
    e = list(exponents) + [0] * (NUM_VARS - len(exponents))
    key = 0
    for x in e:
        assert 0 <= x < (1 << VAR_BITS)
        key = (key << VAR_BITS) | x
    return key


def unpack_key(key: int) -> tuple[int, ...]:
    return tuple(
        (int(key) >> (VAR_BITS * (NUM_VARS - 1 - i))) & ((1 << VAR_BITS) - 1)
        for i in range(NUM_VARS)
    )


def from_dict(terms: dict[tuple[int, ...], int], capacity: int, num_limbs: int,
              device: str | torch.device = "cuda") -> Poly:
    """Constructor from {exponent-tuple: int coefficient}, built on the
    host and placed on ``device``."""
    device = resolve_device(device)
    items = sorted((pack_key(e), c) for e, c in terms.items())
    if len(items) > capacity:
        raise ValueError(f"{len(items)} terms exceed capacity {capacity}")
    keys = np.full(capacity, EMPTY_KEY, np.int32)
    coeffs = np.zeros((capacity, num_limbs), np.int32)
    for i, (k, c) in enumerate(items):
        keys[i] = k
        coeffs[i] = limb.from_int_np(c, num_limbs)
    return Poly(torch.as_tensor(keys, device=device), torch.as_tensor(coeffs, device=device))


def to_dict(p: Poly) -> dict[tuple[int, ...], int]:
    """Host-side exact extraction (Python bigints)."""
    keys = p.keys.cpu().numpy()
    coeffs = p.coeffs.cpu().numpy()
    out: dict[tuple[int, ...], int] = {}
    for i in range(keys.shape[0]):
        if keys[i] == EMPTY_KEY:
            continue
        value = limb.to_int(coeffs[i])
        if value:
            out[unpack_key(int(keys[i]))] = out.get(unpack_key(int(keys[i])), 0) + value
    return out


# ---------------------------------------------------------------------------
# Core ops (all shape-static)
# ---------------------------------------------------------------------------


def _mask_invalid(keys: torch.Tensor, coeffs: torch.Tensor):
    """Clear lanes whose coefficient is zero (the paper's cancellation)."""
    zero = limb.is_zero(coeffs)
    keys = keys.masked_fill(zero, _EMPTY)
    coeffs = coeffs.masked_fill(zero[..., None], 0)
    return keys, coeffs


def multiply_term(p: Poly, m_key: torch.Tensor, c_limbs: torch.Tensor) -> Poly:
    """The paper's ``multiply(x, m, c)``: p * (c * monomial m), vectorized."""
    valid = p.keys != _EMPTY
    keys = (p.keys + m_key).masked_fill(~valid, _EMPTY)
    coeffs = limb.mul(p.coeffs, c_limbs[None, :])
    keys, coeffs = _mask_invalid(keys, coeffs)
    return Poly(keys, coeffs)


def _sort_by_key(keys: torch.Tensor, coeffs: torch.Tensor):
    order = torch.argsort(keys, stable=True)
    return keys.index_select(0, order), coeffs.index_select(0, order)


def compact(p: Poly, capacity: int) -> Poly:
    """Sort valid terms to the front; truncate/grow to ``capacity``."""
    keys, coeffs = _sort_by_key(p.keys, p.coeffs)
    n = p.capacity
    if capacity >= n:
        keys = torch.cat([keys, keys.new_full((capacity - n,), _EMPTY)])
        coeffs = torch.cat([coeffs, coeffs.new_zeros((capacity - n, p.num_limbs))])
    else:
        # Truncation only sound if the tail is empty; callers size capacity.
        keys = keys[:capacity]
        coeffs = coeffs[:capacity]
    return Poly(keys, coeffs)


def plus(x: Poly, y: Poly, capacity: int | None = None) -> Poly:
    """The paper's recursive merge-add, as sort + adjacent-combine.

    Equal keys combine; cancellations clear lanes (no early force).
    """
    capacity = capacity or x.capacity
    keys, coeffs = _sort_by_key(torch.cat([x.keys, y.keys]), torch.cat([x.coeffs, y.coeffs]))
    # Combine runs of equal keys.  Each input has unique keys, so runs have
    # length <= 2: one adjacent-combine pass suffices.
    same = torch.cat(
        [keys.new_zeros((1,), dtype=torch.bool),
         (keys[1:] == keys[:-1]) & (keys[1:] != _EMPTY)]
    )
    shifted = torch.cat([torch.zeros_like(coeffs[:1]), coeffs[:-1]])
    coeffs = torch.where(same[:, None], limb.add(coeffs, shifted), coeffs)
    # The first element of each combined pair is dead.
    dead = torch.cat([same[1:], same.new_zeros((1,))])
    keys = keys.masked_fill(dead, _EMPTY)
    coeffs = coeffs.masked_fill(dead[:, None], 0)
    keys, coeffs = _mask_invalid(keys, coeffs)
    return compact(Poly(keys, coeffs), capacity)


def num_terms(p: Poly) -> torch.Tensor:
    return (p.keys != _EMPTY).sum()


# ---------------------------------------------------------------------------
# times() as a two-source zip Stream
# ---------------------------------------------------------------------------


def _flatten_poly(p: Poly):
    return {"keys": p.keys, "coeffs": p.coeffs}


def _unflatten_poly(d) -> Poly:
    return Poly(d["keys"], d["coeffs"])


def _y_cell_fn(acc_capacity: int):
    """Cell j: acc += x_chunk * (each of my y-term slots)."""

    def cell_fn(cell_state, item):
        x_chunk = _unflatten_poly(item["x"])
        acc = _unflatten_poly(item["acc"])

        def one_term(acc_d, term):
            acc_p = _unflatten_poly(acc_d)
            t_key, t_coeff = term
            prod = multiply_term(x_chunk, t_key, t_coeff)
            # Absent y-term (padding) => multiply_term yields all-EMPTY prod,
            # so the add is a no-op; no control flow needed.
            absent = t_key == _EMPTY
            prod = Poly(
                prod.keys.masked_fill(absent, _EMPTY),
                prod.coeffs.masked_fill(absent, 0),
            )
            return _flatten_poly(plus(acc_p, prod, acc_capacity)), None

        acc_d, _ = scan(
            one_term,
            _flatten_poly(acc),
            (cell_state["keys"], cell_state["coeffs"]),
        )
        return cell_state, {"x": item["x"], "acc": acc_d}

    return cell_fn


def times_stream(
    x: Poly,
    y: Poly,
    *,
    num_x_chunks: int = 1,
    terms_per_cell: int = 1,
    acc_capacity: int | None = None,
    into: Poly | None = None,
) -> Stream:
    """The product as an algebra program: two sources zipped into a chain.

    Source 1 streams chunks of ``x``; source 2 streams the running
    accumulators — all-EMPTY for a plain product, or chunks of ``into``
    for the fused multiply-add ``x*y + into``.  The zip pairs chunk b
    with accumulator b (source order, deterministic); cell j holds
    y-term chunk j (G = ``terms_per_cell`` is the paper §7 chunk-size
    knob).  Collecting yields M partial accumulators to tree-add.
    """
    acc_capacity = acc_capacity or _product_capacity(x, y)
    if x.capacity % num_x_chunks != 0:
        raise ValueError("x capacity not divisible by num_x_chunks")
    if y.capacity % terms_per_cell != 0:
        raise ValueError("y capacity not divisible by terms_per_cell")
    num_cells = y.capacity // terms_per_cell
    state = {
        "keys": y.keys.reshape(num_cells, terms_per_cell),
        "coeffs": y.coeffs.reshape(num_cells, terms_per_cell, y.num_limbs),
    }
    # Chunking x leaves EMPTY padding distributed arbitrarily; that's fine —
    # multiply_term propagates EMPTY lanes.
    x_items = chunk_axis(_flatten_poly(x), num_x_chunks)
    acc_keys = x.keys.new_full((num_x_chunks, acc_capacity), _EMPTY)
    acc_coeffs = x.coeffs.new_zeros((num_x_chunks, acc_capacity, x.num_limbs))
    if into is not None:
        # Seed accumulator chunk 0 with `into` (added exactly once).
        if into.capacity > acc_capacity:
            raise ValueError(
                f"into capacity {into.capacity} exceeds acc_capacity "
                f"{acc_capacity}"
            )
        acc_keys[0, : into.capacity] = into.keys
        acc_coeffs[0, : into.capacity] = into.coeffs
    acc_items = {"keys": acc_keys, "coeffs": acc_coeffs}
    return (
        Stream.source(x_items)
        .zip(
            Stream.source(acc_items),
            lambda x_chunk, acc: {"x": x_chunk, "acc": acc},
        )
        .through(
            _y_cell_fn(acc_capacity),
            state,
            num_cells=num_cells,
            mutable_state=False,
        )
    )


def times(
    x: Poly,
    y: Poly,
    *,
    evaluator=None,
    num_x_chunks: int = 1,
    terms_per_cell: int = 1,
    acc_capacity: int | None = None,
) -> Poly:
    """Sparse product x*y via the stream-of-multiply-and-add decomposition.

    ``evaluator=None`` → Lazy (the paper's sequential mode).
    """
    return times_into(
        x,
        y,
        None,
        evaluator=evaluator,
        num_x_chunks=num_x_chunks,
        terms_per_cell=terms_per_cell,
        acc_capacity=acc_capacity,
    )


def times_into(
    x: Poly,
    y: Poly,
    z: Poly | None,
    *,
    evaluator=None,
    num_x_chunks: int = 1,
    terms_per_cell: int = 1,
    acc_capacity: int | None = None,
) -> Poly:
    """Fused multiply-add ``x*y + z`` in one pass.

    ``z`` rides the accumulator source (zip source 2), so the add costs
    nothing extra.  ``z=None`` is the plain product.
    """
    acc_capacity = acc_capacity or _product_capacity(x, y)
    stream = times_stream(
        x,
        y,
        num_x_chunks=num_x_chunks,
        terms_per_cell=terms_per_cell,
        acc_capacity=acc_capacity,
        into=z,
    )
    out_items = stream.collect(evaluator).items
    partials = [
        Poly(out_items["acc"]["keys"][b], out_items["acc"]["coeffs"][b])
        for b in range(num_x_chunks)
    ]
    acc = partials[0]
    for p in partials[1:]:
        acc = plus(acc, p, acc_capacity)
    return acc


def _product_capacity(x: Poly, y: Poly) -> int:
    cap = x.capacity * y.capacity
    return int(min(cap, 1 << 15))


# ---------------------------------------------------------------------------
# The "list" control: data-parallel outer product (paper's baseline [4])
# ---------------------------------------------------------------------------


def times_dense(x: Poly, y: Poly, capacity: int | None = None) -> Poly:
    """Parallel-collections analogue: all |x|·|y| term products at once.

    Outer product of keys/coeffs, then a single sort + segmented combine.
    This is the classical well-optimized baseline the paper compares
    against (its ``list`` rows).
    """
    capacity = capacity or _product_capacity(x, y)
    kx, ky = x.keys, y.keys
    valid = (kx[:, None] != _EMPTY) & (ky[None, :] != _EMPTY)
    keys = (kx[:, None] + ky[None, :]).masked_fill(~valid, _EMPTY).reshape(-1)
    coeffs = limb.mul(x.coeffs[:, None, :], y.coeffs[None, :, :]).reshape(
        -1, x.num_limbs
    )
    coeffs = coeffs.masked_fill(~valid.reshape(-1, 1), 0)
    keys, coeffs = _sort_by_key(keys, coeffs)
    # Segmented reduce of equal-key runs (runs can be long): log-step
    # prefix-combine on sorted keys.
    n = keys.shape[0]
    steps = max(1, int(np.ceil(np.log2(max(n, 2)))))
    seg_sum = coeffs
    for shift in [1 << s for s in range(steps)]:
        prev_key = torch.cat([keys.new_full((shift,), -1), keys[:-shift]])
        prev_sum = torch.cat([torch.zeros_like(seg_sum[:shift]), seg_sum[:-shift]])
        take = prev_key == keys
        seg_sum = torch.where(take[:, None], limb.add(seg_sum, prev_sum), seg_sum)
    # Keep only the last element of each run (holds the full segment sum).
    next_key = torch.cat([keys[1:], keys.new_full((1,), -1)])
    last = keys != next_key
    keys = keys.masked_fill(~(last & (keys != _EMPTY)), _EMPTY)
    coeffs = seg_sum.masked_fill((keys == _EMPTY)[:, None], 0)
    keys, coeffs = _mask_invalid(keys, coeffs)
    return compact(Poly(keys, coeffs), capacity)


# ---------------------------------------------------------------------------
# Test-case generator (Fateman benchmark, as cited by the paper [2])
# ---------------------------------------------------------------------------


def fateman_terms(power: int, big_factor: int = 1) -> dict[tuple[int, ...], int]:
    """The terms of (1 + x + y + z)^power times big_factor, exact ints."""
    terms: dict[tuple[int, ...], int] = {(0, 0, 0): 1}
    for _ in range(power):
        new: dict[tuple[int, ...], int] = {}
        for (a, b, c), coef in terms.items():
            for d in ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)):
                key = (a + d[0], b + d[1], c + d[2])
                new[key] = new.get(key, 0) + coef
        terms = new
    if big_factor != 1:
        terms = {k: v * big_factor for k, v in terms.items()}
    return terms


def fateman_poly(power: int, capacity: int, num_limbs: int, big_factor: int = 1,
                 device: str | torch.device = "cuda") -> Poly:
    """(1 + x + y + z)^power, coefficients optionally scaled by big_factor.

    ``big_factor=100000000001`` reproduces the paper's ``stream_big``.
    Built host-side with exact Python ints, placed on ``device``.
    """
    return from_dict(fateman_terms(power, big_factor), capacity, num_limbs, device)


def reference_product(
    x_terms: dict[tuple[int, ...], int], y_terms: dict[tuple[int, ...], int]
) -> dict[tuple[int, ...], int]:
    """Exact oracle with Python bigints."""
    out: dict[tuple[int, ...], int] = {}
    for ex, cx in x_terms.items():
        for ey, cy in y_terms.items():
            key = tuple(a + b for a, b in zip(ex, ey))
            out[key] = out.get(key, 0) + cx * cy
    return {k: v for k, v in out.items() if v}
