"""Wrapper of the RMSNorm CUDA kernel (``csrc/rmsnorm.cu``).

``rmsnorm(x, scale, eps, gate=z)`` flattens x's leading dims into rows,
as the JAX package's ``repro.kernels.rmsnorm.ops.rmsnorm`` does.  With
``gate`` it normalises Mamba-2's gated row ``x * silu(z)`` (rounded as
``models.ssm`` rounds it) in the same launch; z may be a column slice of
a wider tensor (the in_proj output), read in place through its row
stride.  The operands are checked on every device; then a CPU tensor
runs the plain version (``ref.py``) and a CUDA tensor launches the
kernel on the current stream or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
     ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
)


def _check(x, scale, gate):
    d = x.shape[-1]
    if scale.device != x.device:
        raise ValueError(f"scale is on {scale.device}, x on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the RMSNorm kernel takes float32 or bfloat16 x, not {x.dtype}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (d,):
        raise TypeError(f"scale must be float32 of shape ({d},), got {scale.dtype} {tuple(scale.shape)}")
    vec = 16 // x.element_size()
    if d % vec:
        raise ValueError(f"d={d} must be a multiple of {vec}")
    for name, t in (("x", x), ("scale", scale)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if gate is None:
        return 0
    if gate.device != x.device:
        raise ValueError(f"gate is on {gate.device}, x on {x.device}")
    if gate.dtype != x.dtype:
        raise TypeError(f"gate is {gate.dtype}, x is {x.dtype}")
    if gate.shape != x.shape:
        raise ValueError(f"gate must be {tuple(x.shape)}, got {tuple(gate.shape)}")
    try:
        rows = gate.view(-1, d)  # one stride between rows, or no view
    except RuntimeError:
        raise ValueError("gate's rows must lie at one stride from each other") from None
    stride = rows.stride(0) if rows.shape[0] > 1 else d
    if rows.stride(1) != 1 or gate.data_ptr() % 16 or stride % vec:
        raise ValueError("gate must be contiguous in d, with a 16-byte aligned base and row stride")
    return stride


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5, *,
            gate: torch.Tensor | None = None) -> torch.Tensor:
    """x: (..., d); scale: (d,) fp32; gate: x's shape and dtype, or None.
    Returns x's shape and dtype."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the RMSNorm kernel runs on CPU or CUDA tensors, not {x.device}")
    z_stride = _check(x, scale, gate)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps, gate=gate)
    d = x.shape[-1]
    n = x.numel() // d
    out = torch.empty_like(x)
    if n == 0:
        return out
    fn = K.kernel_function("rmsnorm", "rmsnorm", _ARGTYPES)
    code = fn(
        _DTYPES[x.dtype], x.data_ptr(), None if gate is None else gate.data_ptr(), z_stride,
        scale.data_ptr(), out.data_ptr(), n, d, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    K.check_launch("rmsnorm", code)
    K.LAUNCHES["rmsnorm"] += 1
    return out
