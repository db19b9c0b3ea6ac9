"""Wrapper of the fused emit CUDA kernel (``csrc/emit_norm_logits.cu``).

A CPU tensor runs the plain version (``ref.py``); a CUDA tensor launches
the kernel on the current stream or raises.  A batch wider than one
launch takes (:func:`emit_tiles`) is tiled over launches, each writing
its rows of the one ``(B, V)`` output and reading the whole head: the
head's bytes grow with the launch count.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import kernels as K
from repro_torch.kernels.emit_norm_logits.ref import emit_norm_logits_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NORMS = {"rmsnorm": 0, "layernorm_nonparam": 1}
_ARGTYPES = (
    [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
)
SMEM_LIMIT = 227 * 1024  # shared memory one block may use on Hopper

# The untied ring's layout (csrc/emit_norm_logits.cu: Untied<T>, U_*).
UNTIED_MAX_ROWS = 64      # batch rows a launch: 8 n8 tiles of the mma
UNTIED_MAX_STAGES = 16
UNTIED_FIXED = 2048       # alignment slack and the barriers ahead of the ring
UNTIED_KC = (256, 128, 64, 32)  # rows of d a stage: a TMA box has at most 256


def untied_cols(dtype: torch.dtype) -> int:
    """Vocab columns a group: 256 bytes of each row of the head."""
    return 256 // dtype.itemsize


class UntiedPlan(NamedTuple):
    rows: int      # batch rows a launch
    launches: int  # ceil(B / rows), each reading the head once
    kc: int        # rows of d a stage
    stages: int
    smem: int      # bytes of shared memory a block


def untied_plan(b: int, d: int, dtype: torch.dtype) -> UntiedPlan:
    """The untied kernel's ring for ``b`` rows of width ``d``: the fewest
    launches whose rows of normalised x leave room for two stages, the
    tallest stage of which two fit, and as many stages as fit, at most 16.
    Raises with the reason where none fits."""
    elem = dtype.itemsize
    if b > UNTIED_MAX_ROWS:
        raise ValueError(f"B={b}: the untied emit kernel takes at most {UNTIED_MAX_ROWS} rows")
    ldx = -(-d // 64) * 64 + (8 if elem == 2 else 0)  # a shared row of x, padded
    heights = sorted({min(kc, -(-d // 32) * 32) for kc in UNTIED_KC}, reverse=True)
    for launches in range(1, b + 1):
        rows = -(-b // launches)
        free = SMEM_LIMIT - UNTIED_FIXED - rows * ldx * elem
        for kc in heights:
            stage = kc * untied_cols(dtype) * elem
            stages = min(UNTIED_MAX_STAGES, max(free, 0) // stage)
            if stages >= 2:
                return UntiedPlan(rows, -(-b // rows), kc, stages,
                                  UNTIED_FIXED + stages * stage + rows * ldx * elem)
    raise ValueError(f"d={d}: one row of the normalised x ({ldx * elem} bytes) leaves no room "
                     f"for two stages of the untied emit kernel in {SMEM_LIMIT} bytes")


# The tied kernel's shared memory: each row of the normalised x padded by
# 32 elements, the fp32 rmsnorm scale, and 20 KB of the kernels' own (at
# least two stages of the tied bf16 ring)
TIED_FIXED = 20 * 1024


def tied_max_rows(d: int, dtype: torch.dtype) -> int:
    """Batch rows one tied launch holds in shared memory at width ``d``;
    raises where not one row fits."""
    rows = (SMEM_LIMIT - TIED_FIXED - 4 * d) // ((d + 32) * dtype.itemsize)
    if rows < 1:
        raise ValueError(f"d={d}: one row of the normalised x does not fit the tied emit "
                         f"kernel's shared memory")
    return rows


def emit_tiles(b: int, d: int, dtype: torch.dtype, tied: bool) -> list[tuple[int, int]]:
    """The launches of one emit call: ``[(first row, end row), ...]``,
    the fewest launches of at most :func:`tied_max_rows` (tied) or
    ``UNTIED_MAX_ROWS`` (untied) rows, the rows spread evenly over them.
    An untied launch splits its rows again where its ``untied_plan``
    says so."""
    limit = tied_max_rows(d, dtype) if tied else UNTIED_MAX_ROWS
    launches = -(-b // limit)
    rows = -(-b // launches)
    return [(r, min(b, r + rows)) for r in range(0, b, rows)]


def emit_norm_logits(
    x: torch.Tensor,  # (B, 1, d)
    w: torch.Tensor,  # (d, V) untied head | (V, d) tied embedding
    *,
    norm: str,
    scale=None,
    eps: float = 1e-5,
    tied: bool = False,
) -> torch.Tensor:
    """Final norm + logits of one decode position: fp32 ``(B, V)``, each
    logit rounded to x's dtype (the same function as ``ref.py``)."""
    if norm not in _NORMS:
        raise ValueError(norm)
    if x.device.type == "cpu":
        return emit_norm_logits_ref(x, w, norm=norm, scale=scale, eps=eps, tied=tied)
    if x.device.type != "cuda":
        raise ValueError(f"emit runs on CPU or CUDA tensors, not {x.device}")
    b, s, d = x.shape
    v = w.shape[0] if tied else w.shape[1]
    if s != 1:
        raise ValueError(f"x must be (B, 1, d), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or bfloat16, got {x.dtype}, {w.dtype}")
    if tuple(w.shape) != ((v, d) if tied else (d, v)):
        raise ValueError(f"w {tuple(w.shape)} does not match d={d} (tied={tied})")
    vec = 16 // x.element_size()
    if d % vec or v % vec:
        raise ValueError(f"d={d} and V={v} must be multiples of {vec}")
    if norm == "rmsnorm":
        if scale is None or scale.dtype != torch.float32 or tuple(scale.shape) != (d,):
            raise TypeError("rmsnorm needs a float32 scale of shape (d,)")
        operands = (("x", x), ("w", w), ("scale", scale))
    else:
        operands = (("x", x), ("w", w))
    for name, t in operands:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty((b, v), dtype=torch.float32, device=x.device)
    fn = K.kernel_function("emit_norm_logits", "emit_norm_logits", _ARGTYPES)
    for r0, r1 in emit_tiles(b, d, x.dtype, tied):
        if tied:
            plan = (0, 0, 0)
        else:
            p = untied_plan(r1 - r0, d, x.dtype)
            plan = (p.kc, p.stages, p.rows)
        code = fn(
            _DTYPES[x.dtype], _NORMS[norm], int(tied),
            x[r0:r1].data_ptr(), w.data_ptr(), scale.data_ptr() if norm == "rmsnorm" else None,
            out[r0:r1].data_ptr(), r1 - r0, d, v, float(eps), *plan,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        K.check_launch("emit_norm_logits", code)
        K.LAUNCHES["emit_norm_logits"] += 1
    return out
