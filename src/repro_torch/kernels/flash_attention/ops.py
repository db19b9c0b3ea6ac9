"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

``flash_attention`` takes the model's ``(B, S, H, dh)`` layout, as
``layers.attention`` passes it; ``flash_attention_bhsd`` the kernel
layout ``(B, H, S, dh)`` of the JAX package's ``flash_attention_bhsd``.
Both launch the same kernel (it reads either layout through strides).
``kv_len`` is ``None``, an int, or a ``(B,)`` / ``(B, 1)`` int32 tensor;
``q_offset`` an int.  A CPU tensor runs the plain version (``ref.py``);
a CUDA tensor launches the kernel on the current stream or raises.

In bf16 the kernel splits the keys a query tile can see over blocks
where the query tiles alone leave SMs idle (:func:`flash_split`), and
the last split of a tile to finish merges the splits in the same launch
through ``kernels.merge_tickets`` (one buffer per device and stream for
eager calls, tickets of its own for each launch captured into a graph).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.flash_attention.ref import attention_ref, flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)  # the kernel's template instances
TILE = 64  # key rows of a stage (BK); query rows of a consumer warpgroup (BQ)
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float]
    + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                            ctypes.c_longlong, ctypes.c_void_p]
)


def key_span(sq: int, sk: int, *, causal: bool, q_offset: int, kv_len) -> int:
    """Keys some query can see, from what the host knows: the causal bound
    of the last query row, and ``kv_len`` when it is one count."""
    span = min(max(q_offset + sq, 0), sk) if causal else sk
    if kv_len is not None and not isinstance(kv_len, torch.Tensor):
        span = min(span, max(min(int(kv_len), sk), 0))
    return span


def flash_split(b: int, h: int, sq: int, span: int, sms: int) -> tuple[int, int, int]:
    """``(query rows a block, keys a split, splits)`` of the bf16 kernel
    (one block an SM) for ``b * h`` heads of ``sq`` queries that see at
    most ``span`` keys, on ``sms`` SMs.

    Where 128-row query tiles alone reach the SM count (``forward`` over a
    long prompt), a block holds 128 rows in two consumer warpgroups that
    share each K/V tile, and the keys are not split.  Otherwise a block
    holds 64 rows, and the keys are split into as many ranges of whole
    64-key tiles as keep the grid within the SM count: every split past
    the first adds a partial to merge, and a merge reads each partial
    once.  Every split holds at least one key of the span."""
    tiles = max(1, -(-span // TILE))
    if b * h * -(-sq // (2 * TILE)) >= sms:
        return 2 * TILE, tiles * TILE, 1
    blocks = max(1, b * h * -(-sq // TILE))
    want = max(1, min(tiles, sms // blocks))
    per = -(-tiles // want)  # key tiles a split
    return TILE, per * TILE, -(-tiles // per)


def partial_floats(b: int, h: int, sq: int, dh: int, splits: int, rows: int) -> int:
    """fp32 scratch of the splits' partials: (m, l) and an unnormalised
    output per query row (of whole ``rows``-row blocks), head and split;
    none for one split."""
    return b * h * -(-sq // rows) * splits * rows * (dh + 2) if splits > 1 else 0


def _launch(q, k, v, *, heads_first, causal, q_offset, kv_len, softmax_scale):
    """Check the operands and launch the kernel; the output has q's
    layout.  ``heads_first``: (B, H, S, dh) instead of (B, S, H, dh)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CPU or CUDA tensors, not {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, not {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be 4-d with k and v alike: {q.shape}, {k.shape}, {v.shape}")
    if heads_first:
        b, h, sq, dh = q.shape
        kv, sk = k.shape[1], k.shape[2]
    else:
        b, sq, h, dh = q.shape
        sk, kv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh}: the kernel is built for {HEAD_DIMS}")
    if h % kv:
        raise ValueError(f"num_heads {h} is not a multiple of kv heads {kv}")
    if not isinstance(q_offset, int):
        raise TypeError(f"q_offset must be an int, not {type(q_offset).__name__}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lens, len_scalar = None, sk
    if isinstance(kv_len, torch.Tensor):
        if kv_len.device != q.device:
            raise ValueError(f"kv_len is on {kv_len.device}, q on {q.device}")
        if kv_len.dtype != torch.int32 or kv_len.numel() != b:
            raise TypeError(f"kv_len must be an int32 tensor of {b} counts, got "
                            f"{kv_len.dtype} {tuple(kv_len.shape)}")
        lens = kv_len.reshape(b).contiguous()
    elif kv_len is not None:
        len_scalar = max(min(int(kv_len), sk), 0)
    out = torch.empty_like(q)
    qs, ks = q.stride(), k.stride()
    if heads_first:  # strides: batch, row, head
        q_str, k_str = (qs[0], qs[2], qs[1]), (ks[0], ks[2], ks[1])
    else:
        q_str, k_str = (qs[0], qs[1], qs[2]), (ks[0], ks[1], ks[2])
    if q.dtype == torch.bfloat16:  # fp32 runs one block per query tile and head
        span = key_span(sq, sk, causal=causal, q_offset=q_offset, kv_len=kv_len)
        rows, keys, splits = flash_split(b, h, sq, span, K.sm_count(q.device))
    else:
        rows, keys, splits = TILE, TILE * max(1, -(-sk // TILE)), 1
    scratch = torch.empty(max(partial_floats(b, h, sq, dh, splits, rows), 1),
                          dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = K.merge_tickets(q.device, b * h * -(-sq // rows), stream)
    fn = K.kernel_function("flash_attention", "flash_attention", _ARGTYPES)
    code = fn(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lens is None else lens.data_ptr(), len_scalar, b, sq, sk, h, kv, dh,
        *q_str, *k_str, int(bool(causal)), q_offset,
        float(softmax_scale if softmax_scale is not None else dh**-0.5),
        rows, keys, splits, scratch.data_ptr(), scratch.numel(), tickets.data_ptr(),
        tickets.numel(), stream,
    )
    K.check_launch("flash_attention", code)
    K.LAUNCHES["attention"] += 1
    return out


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, dh)
    k: torch.Tensor,  # (B, Sk, KV, dh)
    v: torch.Tensor,  # (B, Sk, KV, dh)
    *,
    causal: bool,
    q_offset: int = 0,
    kv_len=None,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """Attention context ``(B, Sq, H, dh)``: query row i sits at position
    ``q_offset + i``; keys at or past ``kv_len`` are masked; a row with no
    valid key gives 0 (the same function as ``ref.flash_attention_ref``)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=kv_len, softmax_scale=softmax_scale)
    return _launch(q, k, v, heads_first=False, causal=causal, q_offset=q_offset,
                   kv_len=kv_len, softmax_scale=softmax_scale)


def flash_attention_bhsd(
    q: torch.Tensor,  # (B, H, Sq, dh)
    k: torch.Tensor,  # (B, KV, Sk, dh)
    v: torch.Tensor,  # (B, KV, Sk, dh)
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_len=None,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """:func:`flash_attention` in the kernel layout ``(B, H, S, dh)``
    (``ref.attention_ref`` on CPU tensors)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len, softmax_scale=softmax_scale)
    return _launch(q, k, v, heads_first=True, causal=causal, q_offset=q_offset,
                   kv_len=kv_len, softmax_scale=softmax_scale)
