"""Plain PyTorch version of the decode emit: final norm -> logits.

Follows the JAX package's ``repro.kernels.emit_norm_logits.ref`` op for
op: ``_norm`` (rmsnorm or OLMo's non-parametric layernorm, rounded to
x's dtype), then ``layers.logits`` (tied or untied head, product in x's
dtype, fp32 upcast) and the ``[:, 0, :]`` squeeze.
"""
from __future__ import annotations

import torch


def emit_norm_logits_ref(
    x: torch.Tensor,        # (B, 1, d) -- the emit's hidden state
    w: torch.Tensor,        # (d, V) untied head | (V, d) tied embedding
    *,
    norm: str,              # "rmsnorm" | "layernorm_nonparam"
    scale=None,             # (d,) rmsnorm scale (None for layernorm)
    eps: float = 1e-5,
    tied: bool = False,
) -> torch.Tensor:
    from repro_torch.models import layers as L

    if norm == "rmsnorm":
        xn = L.rmsnorm({"scale": scale}, x, eps)
    elif norm == "layernorm_nonparam":
        xn = L.layernorm_nonparam(x, eps)
    else:
        raise ValueError(norm)
    eq = "bsd,vd->bsv" if tied else "bsd,dv->bsv"
    return torch.einsum(eq, xn, w).float()[:, 0, :]
