"""Plain PyTorch version of the fused decode attention.

Follows the JAX package's ``repro.kernels.decode_attention.ref`` op for
op: update a copy of the K/V cache page at each sequence's write
position, then dense attention over the updated page with the
``kv_len`` prefix mask.  The CUDA kernel is held against this function;
it leaves the cache it is given untouched.
"""
from __future__ import annotations

import torch


def decode_attention_ref(
    q: torch.Tensor,        # (B, 1, H, dh) -- the one decode query
    k_new: torch.Tensor,    # (B, KV, dh) -- this step's K row (cache dtype)
    v_new: torch.Tensor,    # (B, KV, dh)
    k_cache: torch.Tensor,  # (B, S, KV, dh) -- the cache page (pre-update)
    v_cache: torch.Tensor,  # (B, S, KV, dh)
    *,
    pos: torch.Tensor,      # (B,) int32 per-sequence write position
    kv_len: torch.Tensor,   # (B,) or (B, 1) valid KV count after the write
    softmax_scale: float | None = None,
) -> torch.Tensor:
    from repro_torch.models.layers import attention_dense

    b = q.shape[0]
    idx = torch.arange(b, device=q.device)
    pos = pos.reshape(b).long()
    ck = k_cache.clone()
    cv = v_cache.clone()
    ck[idx, pos] = k_new
    cv[idx, pos] = v_new
    return attention_dense(
        q, ck, cv, causal=False,
        kv_len=kv_len.reshape(b, 1),
        softmax_scale=softmax_scale,
    )
