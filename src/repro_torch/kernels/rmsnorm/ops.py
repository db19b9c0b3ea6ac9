"""Wrapper of the RMSNorm CUDA kernel (``csrc/rmsnorm.cu``).

``rmsnorm(x, scale, eps)`` flattens x's leading dims into rows, as the
JAX package's ``repro.kernels.rmsnorm.ops.rmsnorm`` does.  A CPU tensor
runs the plain version (``ref.py``); a CUDA tensor launches the kernel
on the current stream or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); scale: (d,) fp32.  Returns x's shape and dtype."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"the RMSNorm kernel runs on CPU or CUDA tensors, not {x.device}")
    d = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"the RMSNorm kernel takes float32 or bfloat16 x, not {x.dtype}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (d,):
        raise TypeError(f"scale must be float32 of shape ({d},), got {scale.dtype} {tuple(scale.shape)}")
    if scale.device != x.device:
        raise ValueError(f"scale is on {scale.device}, x on {x.device}")
    vec = 16 // x.element_size()
    if d % vec:
        raise ValueError(f"d={d} must be a multiple of {vec}")
    for name, t in (("x", x), ("scale", scale)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows == 0:
        return out
    fn = K.kernel_function("rmsnorm", "rmsnorm", _ARGTYPES)
    code = fn(
        _DTYPES[x.dtype], x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
        float(eps), torch.cuda.current_stream(x.device).cuda_stream,
    )
    K.check_launch("rmsnorm", code)
    K.LAUNCHES["rmsnorm"] += 1
    return out
