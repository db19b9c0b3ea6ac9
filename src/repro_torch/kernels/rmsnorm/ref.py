"""Plain PyTorch version of the RMSNorm kernel (``csrc/rmsnorm.cu``).

Op for op with the JAX package's ``repro.kernels.rmsnorm.ref.
rmsnorm_ref``: an fp32 mean of squares over the last axis, rsqrt, the
scale, then a cast to x's dtype.
"""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); scale: (d,) fp32.  fp32 math, output in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)
