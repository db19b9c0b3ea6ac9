"""``jax.random``'s default generator on the host, in numpy uint32.

The serving engines sample at temperature > 0 with
``categorical(fold_in(fold_in(PRNGKey(seed), uid), ngen), logits / T)``,
so a request's tokens depend on (seed, uid, token index) only.  The port
rebuilds that draw bit for bit from the same integer operations:

* ``threefry2x32``: the Threefry-2x32 hash (20 rounds, key schedule
  with the 0x1BD11BDA parity word), elementwise over broadcast arrays;
* ``PRNGKey(seed)``: the key ``[0, seed mod 2**32]`` (JAX's 32-bit mode);
* ``fold_in(key, data)``: the hash of the counter pair ``(0, data)``;
* ``random_bits``: 32-bit words in the partitionable counter layout
  (``jax_threefry_partitionable``, on in the JAX the reference runs with): element
  ``i`` of the row-major flattened shape hashes the counter pair
  ``(i >> 32, i & 0xffffffff)`` and returns the xor of the two words;
* ``uniform``: fp32 in ``[minval, maxval)`` from the top 23 bits, set
  as the mantissa of a float in ``[1, 2)``, minus 1;
* ``gumbel``: ``-log(-log(uniform(minval=tiny, maxval=1)))``, each log
  correctly rounded to fp32 (taken in fp64).  XLA's fp32 log is
  faithful but not correctly rounded (one ulp off for about a seventh of
  inputs), so a Gumbel value can differ from JAX's by up to two fp32
  ulps of ``max(|g|, 1)``; a token changes only where the top two noisy
  logits lie that close;
* ``categorical``: ``argmax(gumbel + logits)`` over the last axis.

``key`` arguments are ``(..., 2)`` uint32 arrays; a batch of keys draws
one row each.

The functions with a ``_t`` suffix are the same draw on tensors, for a
sampler that runs on the card inside a decode round (the
``StreamEngine``'s emit): each 32-bit word is an int64 tensor masked to
32 bits after every operation that may overflow, so the bits equal the
numpy versions'.  They create no tensor from host data, so they never
sync the host with the card.  ``gumbel_t`` takes its logs in fp64 and
rounds them to fp32, as ``_log`` does: the card's fp64 log is not
correctly rounded either, so a Gumbel value may differ from the host's in
its last fp32 ulp where the fp64 value lies next to a rounding boundary
(the same two-ulp bound holds).
"""
from __future__ import annotations

import numpy as np
import torch

_U32 = np.uint32
_MASK = 0xFFFFFFFF
_PARITY = _U32(0x1BD11BDA)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter words ``(x0, x1)`` under ``key``
    (``(..., 2)`` uint32); every operand broadcasts against the others."""
    key = np.asarray(key, _U32)
    ks = [key[..., 0], key[..., 1]]
    ks.append(ks[0] ^ ks[1] ^ _PARITY)
    x0, x1 = np.broadcast_arrays(np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1])
    x0, x1 = x0.copy(), x1.copy()
    tmp = np.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.right_shift(x1, _U32(32 - r), out=tmp)  # x1 = rotl(x1, r) ^ x0
            x1 <<= _U32(r)
            x1 |= tmp
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 - the name of jax.random's
    """The raw key of ``jax.random.PRNGKey(seed)`` with 64-bit types off."""
    return np.array([0, int(seed) & _MASK], _U32)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in``: a new key from ``key`` and a 32-bit integer
    (``data`` may be an array: one key each, broadcast against ``key``)."""
    data = np.asarray(np.asarray(data, np.int64) & _MASK, _U32)
    key = np.asarray(key, _U32)
    y0, y1 = threefry2x32(key, np.zeros_like(data), data)
    return np.stack(np.broadcast_arrays(y0, y1), axis=-1)


def random_bits(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32-bit words of ``jax.random.bits(key, shape)``; a batch of keys
    ``(..., 2)`` gives ``(..., *shape)``."""
    key = np.asarray(key, _U32)
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64).reshape(shape)
    hi = (idx >> np.uint64(32)).astype(_U32)
    lo = (idx & np.uint64(_MASK)).astype(_U32)
    k = key.reshape(key.shape[:-1] + (1,) * len(shape) + (2,))
    b0, b1 = threefry2x32(k, hi, lo)
    return b0 ^ b1


def uniform(key: np.ndarray, shape: tuple[int, ...], minval=0.0, maxval=1.0) -> np.ndarray:
    """fp32 ``jax.random.uniform``."""
    bits = random_bits(key, shape)
    floats = ((bits >> _U32(32 - 23)) | _U32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """fp32 ``jax.random.gumbel`` (its default "low" mode)."""
    u = uniform(key, shape, minval=np.finfo(np.float32).tiny, maxval=1.0)
    return -_log(-_log(u))


def _log(x: np.ndarray) -> np.ndarray:
    """fp32 natural log, correctly rounded."""
    return np.log(x.astype(np.float64)).astype(np.float32)


def categorical(key: np.ndarray, logits: np.ndarray) -> np.ndarray:
    """``jax.random.categorical`` over the last axis of fp32 ``logits``
    ``(..., V)``, one key per row: ``key`` is ``(2,)`` or ``(..., 2)``."""
    logits = np.asarray(logits)
    key = np.asarray(key, _U32)
    noise = gumbel(key, logits.shape[key.ndim - 1:])
    return np.argmax(noise + logits, axis=-1).astype(np.int32)


def request_key(seed: int, uid, ngen) -> np.ndarray:
    """The serving key of a request's ``ngen``-th token:
    ``fold_in(fold_in(PRNGKey(seed), uid), ngen)``; ``uid`` and ``ngen``
    may be arrays (one key per element)."""
    return fold_in(fold_in(PRNGKey(seed), uid), ngen)


# ---------------------------------------------------------------------------
# The same draw on tensors
# ---------------------------------------------------------------------------


def _words(key):
    """The two 32-bit words of a key: a ``(..., 2)`` int64 tensor, or a
    pair of ints (``PRNGKey``'s, with no tensor made from host data)."""
    if isinstance(key, torch.Tensor):
        return key[..., 0], key[..., 1]
    return int(key[0]) & _MASK, int(key[1]) & _MASK


def threefry2x32_t(key, x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`threefry2x32` on int64 tensors holding 32-bit words; ``key``
    is a ``(..., 2)`` int64 tensor or a pair of ints, and the operands
    broadcast."""
    k0, k1 = _words(key)
    ks = (k0, k1, k0 ^ k1 ^ int(_PARITY))
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) & _MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def fold_in_t(key, data: torch.Tensor) -> torch.Tensor:
    """:func:`fold_in` of integer tensor ``data`` (one key each): a
    ``(*data.shape, 2)`` int64 tensor."""
    data = data.to(torch.int64) & _MASK
    y0, y1 = threefry2x32_t(key, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits_t(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """:func:`random_bits` for a ``(..., 2)`` key tensor: 32-bit words,
    int64, shape ``(..., *shape)``."""
    idx = torch.arange(int(np.prod(shape, dtype=np.int64)), dtype=torch.int64,
                       device=key.device).reshape(shape)
    k = key.reshape(key.shape[:-1] + (1,) * len(shape) + (2,))
    b0, b1 = threefry2x32_t(k, idx >> 32, idx & _MASK)
    return b0 ^ b1


def uniform_t(key: torch.Tensor, shape: tuple[int, ...], minval=0.0, maxval=1.0) -> torch.Tensor:
    """:func:`uniform` on tensors: fp32."""
    bits = random_bits_t(key, shape)
    floats = ((bits >> (32 - 23)) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    return (floats * float(hi - lo) + float(lo)).clamp_min(float(lo))


def gumbel_t(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """:func:`gumbel` on tensors: fp32, each log taken in fp64."""
    u = uniform_t(key, shape, minval=np.finfo(np.float32).tiny, maxval=1.0)
    return -_log_t(-_log_t(u))


def _log_t(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.to(torch.float64)).to(torch.float32)


def categorical_t(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """:func:`categorical` on tensors: int32 draws over the last axis of
    fp32 ``logits``, one key (``(..., 2)``) per row."""
    noise = gumbel_t(key, tuple(logits.shape[key.dim() - 1:]))
    return torch.argmax(noise + logits, dim=-1).to(torch.int32)


def request_key_t(seed: int, uid: torch.Tensor, ngen: torch.Tensor) -> torch.Tensor:
    """:func:`request_key` on tensors: ``(*uid.shape, 2)`` int64."""
    return fold_in_t(fold_in_t((0, seed), uid), ngen)
