"""Fixed-width multi-limb unsigned integers (base 2^13, int32 limbs).

The port of ``repro.algorithms.limb``.  The paper's ``stream_big``
variant multiplies every coefficient by 100000000001 (~2^37) "in order
to increase the footprint of elementary operations" — JVM ``BigInteger``
arithmetic.  Tensors have no arbitrary precision, so we carry
fixed-width multi-limb integers: a number is ``(L,)`` int32 limbs,
little-endian, each in ``[0, 2^13)``.

Base 2^13 keeps every intermediate inside int32 (never widened):
  * limb product  < 2^26
  * sum of up to 32 limb products or carries < 2^31 ✓ (L ≤ 32 enforced)

The limb count L is the *footprint knob*: L=4 (52 bits) for ``stream``,
L=12 (156 bits) for ``stream_big``.  Every op is a tensor op on the
limbs' device: no host sync.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device

LIMB_BITS = 13
LIMB_BASE = 1 << LIMB_BITS
LIMB_MASK = LIMB_BASE - 1
MAX_LIMBS = 32


def from_int_np(value: int, num_limbs: int) -> np.ndarray:
    """Python int (arbitrary precision) -> int32 limb vector on the host.
    Raises on overflow."""
    if value < 0:
        raise ValueError("unsigned limb integers only")
    limbs = []
    v = int(value)
    for _ in range(num_limbs):
        limbs.append(v & LIMB_MASK)
        v >>= LIMB_BITS
    if v:
        raise OverflowError(f"{value} does not fit in {num_limbs} limbs")
    return np.asarray(limbs, np.int32)


def from_int(value: int, num_limbs: int, device: str | torch.device = "cuda") -> torch.Tensor:
    """Python int (arbitrary precision) -> limb vector on ``device``."""
    return torch.as_tensor(from_int_np(value, num_limbs), device=resolve_device(device))


def to_int(limbs) -> int:
    """Limb vector -> Python int (host-side; exact)."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    out = 0
    for limb in reversed(np.asarray(limbs).tolist()):
        out = (out << LIMB_BITS) | int(limb)
    return out


def _shift_up(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with ``n`` zero limbs put below it along the last axis."""
    return F.pad(x, (n, 0))


def normalize(raw: torch.Tensor) -> torch.Tensor:
    """Carry-propagate (..., L) int32 limbs that may exceed the base.

    A fixed sweep per limb fully propagates carries produced by one
    add/mul round (each carry is < base after the first sweep).
    """
    num_limbs = raw.shape[-1]
    out = raw
    for _ in range(num_limbs):  # full ripple worst case
        carry = out >> LIMB_BITS
        out = (out & LIMB_MASK) + _shift_up(carry[..., :-1], 1)
    # Any residual carry out of the top limb is overflow; truncated (mod 2^(13L)).
    return out & LIMB_MASK


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., L) + (..., L) -> (..., L), mod 2^(13L)."""
    return normalize(a + b)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., L) * (..., L) -> (..., L) low limbs, mod 2^(13L).

    Schoolbook convolution, accumulated per output limb with staged
    normalization every 16 partial products to stay inside int32.
    """
    num_limbs = a.shape[-1]
    if num_limbs > MAX_LIMBS:
        raise ValueError(f"L={num_limbs} exceeds MAX_LIMBS={MAX_LIMBS}")
    acc = None
    for j in range(num_limbs):
        # a * b_j, shifted by j limbs; only low (L - j) limbs contribute.
        prod = a[..., : num_limbs - j] * b[..., j : j + 1]
        shifted = _shift_up(prod, j)
        acc = shifted if acc is None else acc + shifted
        if (j + 1) % 16 == 0:
            acc = normalize(acc)
    return normalize(acc)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (...,) bool."""
    return (a == 0).all(dim=-1)


def widen(a: torch.Tensor, num_limbs: int) -> torch.Tensor:
    """Zero-extend (..., L) to (..., num_limbs)."""
    pad = num_limbs - a.shape[-1]
    if pad < 0:
        raise ValueError("cannot narrow")
    if pad == 0:
        return a
    return F.pad(a, (0, pad))
