"""Plain PyTorch version of the flash-attention kernel (fp32 math, GQA).

Follows the JAX package's ``repro.kernels.flash_attention.ref.
attention_ref`` op for op: the ``(B, H, S, dh)`` layout, the scale
applied to q in fp32 before the product, GQA by reshape, softmax, the
NaN scrub of fully masked rows, the output cast to q's dtype.  It keeps
the contract of ``layers.attention`` that the JAX kernel drops: causal
positions start at ``q_offset``, and keys at or past ``kv_len`` (an int
or a ``(B,)`` / ``(B, 1)`` tensor) are masked.  The CUDA kernel is held
against these functions.
"""
from __future__ import annotations

import torch


def attention_ref(
    q: torch.Tensor,  # (B, H, Sq, dh)
    k: torch.Tensor,  # (B, KV, Sk, dh)
    v: torch.Tensor,  # (B, KV, Sk, dh)
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_len=None,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    b, h, sq, dh = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    scale = softmax_scale if softmax_scale is not None else dh**-0.5
    qf = q.reshape(b, kv, g, sq, dh).float() * scale
    kf = k.float()
    vf = v.float()
    scores = torch.einsum("bkgqd,bksd->bkgqs", qf, kf)
    kv_pos = torch.arange(sk, device=q.device)
    if causal:
        q_pos = torch.arange(sq, device=q.device) + q_offset
        mask = kv_pos[None, :] <= q_pos[:, None]
        scores = scores.masked_fill(~mask[None, None, None], -torch.inf)
    if kv_len is not None:
        # an int stays on the host: no copy to the device (CUDA graphs)
        klen = kv_len.reshape(-1, 1) if torch.is_tensor(kv_len) else kv_len  # (B,1) | int
        kmask = kv_pos[None, :] < klen  # (B|1, Sk)
        scores = scores.masked_fill(~kmask[:, None, None, None, :], -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(torch.isnan(probs), 0.0, probs)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, vf)
    return out.reshape(b, h, sq, dh).to(q.dtype)


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, H, dh)
    k: torch.Tensor,  # (B, Sk, KV, dh)
    v: torch.Tensor,  # (B, Sk, KV, dh)
    *,
    causal: bool,
    q_offset: int = 0,
    kv_len=None,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """:func:`attention_ref` in the model's ``(B, S, H, dh)`` layout, with
    the signature of the kernel's wrapper ``ops.flash_attention``."""
    out = attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, q_offset=q_offset, kv_len=kv_len,
        softmax_scale=softmax_scale,
    )
    return out.transpose(1, 2)
