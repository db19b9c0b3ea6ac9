"""Gradient compression for slow links (port of ``repro.train.compression``).

* **bf16 reduction with error feedback** -- gradients are cast to bf16
  before a slow reduction and the local cast residual is fed back into
  the next step's gradient, keeping the update unbiased over time
  (Seide et al. 2014-style error feedback).
* **moment-dtype compression** lives in :mod:`repro_torch.train.optimizer`.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import pytree as P

PyTree = Any


def compress_decompress(grads: PyTree, error: PyTree | None, dtype=torch.bfloat16):
    """Cast-with-error-feedback.  Returns ``(compressed_f32, new_error)``.

    ``grads`` are fp32; ``error`` is the residual carried from the
    previous step (same structure, fp32), or None on step 0.
    """
    if error is None:
        error = P.tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    def one(g, e):
        corrected = g.to(torch.float32) + e
        q = corrected.to(dtype)
        new_e = corrected - q.to(torch.float32)
        return q.to(torch.float32), new_e

    flat_g, treedef = P.flatten(grads)
    out = [one(g, e) for g, e in zip(flat_g, P.leaves(error))]
    return (
        P.unflatten(treedef, [o[0] for o in out]),
        P.unflatten(treedef, [o[1] for o in out]),
    )


def init_error_state(abstract_grads: PyTree) -> PyTree:
    """The error-feedback state's template: fp32 meta tensors of the
    gradients' shapes."""
    return P.tree_map(
        lambda g: torch.empty(g.shape, dtype=torch.float32, device="meta"), abstract_grads
    )
