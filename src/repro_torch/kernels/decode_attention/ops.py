"""Wrapper of the fused decode-attention CUDA kernel (``csrc/decode_attention.cu``).

Model code hands the decode query as ``(B, 1, H, dh)`` and per-sequence
``kv_len`` as ``(B,)`` or ``(B, 1)``; the kernel takes flat per-row
operands.  A CPU tensor runs the plain version (``ref.py``); a CUDA
tensor launches the kernel on the current stream or raises.

The kernel splits each row's S axis over blocks (:func:`decode_split`
picks the split) and merges the splits in the same launch: the last
split of a (row, KV head) to finish takes an atomic ticket and merges.
The tickets are ``kernels.merge_tickets``, which every launch leaves
zeroed: one int32 buffer per (device, stream) for eager calls, and
tickets of its own for each launch captured into a CUDA graph, so no two
launches that may run at once share tickets.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_void_p,
                                              ctypes.c_longlong] + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_void_p]
)
MAX_GROUP = 16  # query heads per KV head the kernel holds (MAX_G)
TILE = 64  # cache rows a stage of the kernel's ring (TILE): splits are multiples of it
WAVES = 4  # blocks an SM the split aims at when every row is full


def decode_split(b: int, kv: int, s: int, sms: int) -> tuple[int, int]:
    """``(rows a split, splits)`` of the S axis for ``b * kv`` (row, KV
    head) pairs on ``sms`` SMs: enough splits that the grid of ``splits *
    b * kv`` blocks reaches ``WAVES`` blocks an SM where S allows it, each
    split a whole number of ``TILE``-row tiles, every split holding at
    least one row of S.  (On an H100, 2 to 4 blocks an SM measured the
    same at OLMo-1B's step; 8 and 16, with their extra blocks and merges,
    slower.)"""
    tiles = -(-s // TILE)
    want = max(1, min(tiles, -(-WAVES * sms // (b * kv))))
    per = -(-tiles // want)  # tiles a split
    return per * TILE, -(-tiles // per)


def partial_floats(b: int, h: int, dh: int, splits: int) -> int:
    """fp32 scratch of the splits' partials: (m, l) and an unnormalised
    output row per (row, query head, split); none for one split."""
    return b * h * splits * (dh + 2) if splits > 1 else 0


def _check(q, k_new, v_new, k_cache, v_cache, pos, kv_len):
    b, _, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    for name, t in (("k_new", k_new), ("v_new", v_new), ("k_cache", k_cache),
                    ("v_cache", v_cache), ("pos", pos), ("kv_len", kv_len)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode attention takes float32 or bfloat16, not {q.dtype}")
    for name, t in (("k_new", k_new), ("v_new", v_new), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, dh), got {tuple(q.shape)}")
    if tuple(k_cache.shape) != (b, s, kv, dh) or tuple(v_cache.shape) != (b, s, kv, dh):
        raise ValueError(f"caches must be {(b, s, kv, dh)}, got {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if tuple(k_new.shape) != (b, kv, dh) or tuple(v_new.shape) != (b, kv, dh):
        raise ValueError(f"new rows must be {(b, kv, dh)}")
    if h % kv or h // kv > MAX_GROUP:
        raise ValueError(f"H={h}, KV={kv}: H must be a multiple of KV, at most {MAX_GROUP} times it")
    if dh % 32 or 256 % dh or (dh * q.element_size()) % 16:
        raise ValueError(f"head_dim {dh} must be 32, 64, 128 or 256")
    for name, t in (("pos", pos), ("kv_len", kv_len)):
        if t.dtype != torch.int32 or t.shape != (b,):
            raise TypeError(f"{name} must be int32 of shape ({b},), got {t.dtype} {tuple(t.shape)}")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new), ("k_cache", k_cache),
                    ("v_cache", v_cache), ("pos", pos), ("kv_len", kv_len)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def fused_decode_attention(
    q: torch.Tensor,        # (B, 1, H, dh)
    k_new: torch.Tensor,    # (B, KV, dh)
    v_new: torch.Tensor,    # (B, KV, dh)
    k_cache: torch.Tensor,  # (B, S, KV, dh) -- pre-update, left untouched
    v_cache: torch.Tensor,  # (B, S, KV, dh)
    *,
    pos: torch.Tensor,      # (B,) int32 write positions
    kv_len: torch.Tensor,   # (B,) or (B, 1) int32 valid KV count after the write
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """Attention context ``(B, 1, H, dh)`` of the decode query against the
    cache with each row's new K/V substituted at ``pos``.  The cache is
    not written: the caller writes the new rows afterwards."""
    if q.device.type == "cpu":
        return decode_attention_ref(
            q, k_new, v_new, k_cache, v_cache,
            pos=pos, kv_len=kv_len, softmax_scale=softmax_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on CPU or CUDA tensors, not {q.device}")
    b, _, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    pos = pos.reshape(b)
    kv_len = kv_len.reshape(b)
    _check(q, k_new, v_new, k_cache, v_cache, pos, kv_len)
    out = torch.empty((b, 1, h, dh), dtype=q.dtype, device=q.device)
    rows, splits = decode_split(b, kv, s, K.sm_count(q.device))
    scratch = torch.empty(max(partial_floats(b, h, dh, splits), 1), dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = K.merge_tickets(q.device, b * kv, stream)
    fn = K.kernel_function("decode_attention", "decode_attention", _ARGTYPES)
    code = fn(
        _DTYPES[q.dtype], q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), scratch.numel(), tickets.data_ptr(),
        tickets.numel(), b, s, h, kv, dh, rows,
        float(softmax_scale or dh**-0.5), stream,
    )
    K.check_launch("decode_attention", code)
    K.LAUNCHES["decode_attention"] += 1
    return out
