"""Plain PyTorch version of the RMSNorm kernel (``csrc/rmsnorm.cu``).

Op for op with the JAX package's ``repro.kernels.rmsnorm.ref.
rmsnorm_ref``: an fp32 mean of squares over the last axis, rsqrt, the
scale, then a cast to x's dtype.  With ``gate`` the row first becomes
Mamba-2's gated row, op for op as the JAX ``ssm_block`` computes it:
``x * silu(gate.float()).to(x.dtype)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5, *,
                gate: torch.Tensor | None = None) -> torch.Tensor:
    """x: (..., d); scale: (d,) fp32; gate: x's shape and dtype, or None.
    fp32 math, output in x's dtype."""
    if gate is not None:
        x = x * F.silu(gate.float()).to(x.dtype)
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)
