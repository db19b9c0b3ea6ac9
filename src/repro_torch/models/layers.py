"""Shared transformer layers: norms, RoPE, GQA attention, gated MLP.

PyTorch port of ``repro.models.layers``: the same functions on the same
parameter dicts and layouts, op for op (fp32 upcasts and casts back at
the same places).  The sharding hooks (``constrain*``) sit where the
reference's do: under a mesh (``parallel.sharding.set_mesh``) they
redistribute a DTensor activation to the canonical layout, and without
one they return their input itself.

Attention comes in three interchangeable implementations (``attn_impl``):

* ``dense`` -- full score matrix.
* ``chunked`` -- streaming attention (online softmax over KV chunks), the
  oracle of the flash kernel; memory O(chunk^2) instead of O(S^2).
* ``flash`` -- the hand-written CUDA kernel
  (:mod:`repro_torch.kernels.flash_attention`), dispatched through
  ``get_impl("attention", kernels)``: the kernel for ``kernels="cuda"``,
  its plain version for ``"plain"``.  It is the JAX package's
  ``"pallas"``, but keeps ``q_offset`` and ``kv_len``, which the Pallas
  kernel drops.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import get_impl
from repro_torch.models.params import ParamSpec
from repro_torch.parallel import sharding as SH

PyTree = Any

# ---------------------------------------------------------------------------
# Activation sharding constraints
#
# Under a mesh these pin the canonical layout of the reference (batch over
# (pod, data), heads/ffn over model, residual d unsharded) on DTensor
# activations.  Without a mesh a hook costs one global read.
# ---------------------------------------------------------------------------

_BATCH = ("pod", "data")


def constrain(x, *axes):
    """maybe_constrain with ('pod','data') batch plus given tail axes."""
    if SH.ACTIVE_MESH is None:
        return x
    return SH.maybe_constrain(x, SH.PartitionSpec(_BATCH, *axes))


def constrain_res(x):  # (B, S, d)
    return constrain(x, None, None)


def constrain_heads(x):  # (B, S, H|KV, dh)
    return constrain(x, None, "model", None)


def constrain_ffn(x):  # (B, S, f)
    return constrain(x, None, "model")


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_layout(dim: int, stacked: tuple[int, ...] = ()):
    axes = ("layers",) * len(stacked) + ("embed",)
    return {"scale": ParamSpec(stacked + (dim,), axes, init="ones", dtype=torch.float32)}


def rmsnorm(params, x, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dtype)


def layernorm_nonparam(x, eps: float = 1e-5):
    """OLMo's non-parametric LayerNorm (no scale/bias), biased variance."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dtype)


def make_norm_layout(norm: str, dim: int, stacked: tuple[int, ...] = ()):
    if norm == "rmsnorm":
        return rmsnorm_layout(dim, stacked)
    if norm == "layernorm_nonparam":
        return {}
    raise ValueError(norm)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions: (..., S) int."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (dh/2,)
    angles = positions[..., None].float() * freqs  # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------


def attention_dense(
    q, k, v, *, causal: bool, q_offset=0, kv_len=None, softmax_scale=None
):
    """Full-score attention.  q:(B,Sq,H,dh) k,v:(B,Sk,KV,dh) -> (B,Sq,H,dh).

    ``q_offset``: absolute position of q[0] (decode: Sq=1, offset=pos).
    ``kv_len``: number of valid KV positions (rest masked; cache padding),
    an int or a (B,)/(B,1) tensor.  A row with no valid key yields 0.

    Under a mesh the operands are pinned batch-sharded with their heads
    whole, as the chunked path pins its views (the reference's dense path
    has no pin: GSPMD partitions the products as they come, but DTensor
    in torch 2.11 cannot fold the score product's (batch, kv-head) dims
    when both are sharded; 2.13 can).
    """
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if h % kv:
        raise ValueError(f"num_heads {h} is not a multiple of kv heads {kv}")
    scale = softmax_scale or dh**-0.5
    if SH.ACTIVE_MESH is not None:
        q, k, v = (constrain(t, None, None, None) for t in (q, k, v))
    qg = q.reshape(b, sq, kv, h // kv, dh)
    scores = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), k.float()) * scale
    kv_pos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = torch.arange(sq, device=q.device) + q_offset
        mask &= kv_pos[None, :] <= q_pos[:, None]
    scores = scores.masked_fill(~mask[None, :, None, None, :], -torch.inf)
    if kv_len is not None:
        klen = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)  # (B,1)|(1,1)
        kmask = kv_pos[None, :] < klen  # (B,S)
        scores = scores.masked_fill(~kmask[:, None, None, None, :], -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    # Rows that are fully masked produce NaN; scrub (decode prefix).
    probs = torch.where(torch.isnan(probs), 0.0, probs)
    out = torch.einsum("bqkgs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


def attention_chunked(
    q, k, v, *, causal: bool, q_chunk: int = 512, kv_chunk: int = 1024,
    q_offset=0, kv_len=None, softmax_scale=None, causal_skip=None,
):
    """Streaming (online-softmax) attention; the flash-attention oracle.

    Walks KV chunks with carried (m, l, acc) -- memory O(q_chunk x
    kv_chunk) -- for each q chunk.  Blocks stay in the input dtype,
    scores and statistics in fp32; P is rounded to the input dtype
    before P.V, as in the JAX package.  ``causal_skip`` (None = auto)
    visits only the KV chunks on or below the diagonal; it applies only
    when ``causal and q_offset == 0 and sq == sk and kv_len is None``.
    Python loops take the place of the JAX package's scans; under
    training ``forward(remat=True)`` recomputes each layer group.
    """
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    scale = softmax_scale or dh**-0.5
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    # Ragged lengths are padded to chunk multiples: padded KV is masked
    # through kv_len, padded Q sliced off.
    sq_pad = -(-sq // q_chunk) * q_chunk
    sk_pad = -(-sk // kv_chunk) * kv_chunk
    if sk_pad != sk:
        k = F.pad(k, (0, 0, 0, 0, 0, sk_pad - sk))
        v = F.pad(v, (0, 0, 0, 0, 0, sk_pad - sk))
        kv_len = torch.clamp(torch.as_tensor(sk if kv_len is None else kv_len,
                                             device=q.device), max=sk)
    if sq_pad != sq:
        q = F.pad(q, (0, 0, 0, 0, 0, sq_pad - sq))
    orig_sq, sq, sk = sq, sq_pad, sk_pad
    nq, nk = sq // q_chunk, sk // kv_chunk
    g = h // kv
    # batch sharding re-pinned on the chunked views, as in the reference
    qg = constrain(q.reshape(b, nq, q_chunk, kv, g, dh), None, None, None, None, None)
    kc = constrain(k.reshape(b, nk, kv_chunk, kv, dh), None, None, None, None)
    vc = constrain(v.reshape(b, nk, kv_chunk, kv, dh), None, None, None, None)
    klen = None if kv_len is None else torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)

    def block_update(carry, q_blk, k_blk, v_blk, qi, kj):
        m, l, acc = carry
        s = torch.einsum("bqkgd,bskd->bqkgs", q_blk.float(), k_blk.float()) * scale
        kv_pos = kj * kv_chunk + torch.arange(kv_chunk, device=q.device)
        mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool, device=q.device)
        if causal:
            q_pos = qi * q_chunk + torch.arange(q_chunk, device=q.device) + q_offset
            mask &= kv_pos[None, :] <= q_pos[:, None]
        mask = mask[None].expand(b, q_chunk, kv_chunk)
        if klen is not None:
            mask = mask & (kv_pos[None, :] < klen)[:, None, :]  # (B|1, Sk) rows
        mask = mask[:, :, None, None, :]
        s = torch.where(mask, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard -inf rows (no valid key yet)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqkgs,bskd->bqkgd", p.to(q_blk.dtype).float(), v_blk.float())
        return m_new, l, acc

    auto_skip = causal and isinstance(q_offset, int) and q_offset == 0 and sq == sk \
        and kv_len is None
    causal_skip = auto_skip if causal_skip is None else (causal_skip and auto_skip)
    outs = []
    for qi in range(nq):
        # The skip visits the KV chunks that hold a key at or below this q
        # chunk's last row.  (The JAX package's pair list, kj <= qi, misses
        # chunks when q_chunk > kv_chunk; with q_chunk <= kv_chunk its
        # extra pairs are fully masked and change nothing.)
        last = min(nk, ((qi + 1) * q_chunk - 1) // kv_chunk + 1) if causal_skip else nk
        carry = (
            torch.full((b, q_chunk, kv, g), -torch.inf, device=q.device),
            torch.zeros((b, q_chunk, kv, g), device=q.device),
            torch.zeros((b, q_chunk, kv, g, dh), device=q.device),
        )
        for kj in range(last):
            carry = block_update(carry, qg[:, qi], kc[:, kj], vc[:, kj], qi, kj)
        m, l, acc = carry
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.stack(outs, dim=1)  # (B, nq, q_chunk, KV, G, dh)
    return out.reshape(b, sq, h, dh)[:, :orig_sq].to(q.dtype)


ATTN_IMPLS = ("dense", "chunked", "flash")


def check_attn_impl(impl: str) -> None:
    """Raise for a name that is not one of the port's implementations."""
    if impl not in ATTN_IMPLS:
        raise ValueError(
            f"attn_impl={impl!r}; the port's implementations are {ATTN_IMPLS} "
            "(the JAX package's 'pallas' is 'flash' here)"
        )


def attention(q, k, v, *, impl: str = "dense", kernels: str = "plain", **kw):
    """One of the three implementations on the same arguments.  ``kernels``
    is a resolved mode (``"plain"`` or ``"cuda"``) and picks, for
    ``impl="flash"``, the kernel or its plain version."""
    check_attn_impl(impl)
    if impl == "chunked":
        return attention_chunked(q, k, v, **kw)
    for extra in ("q_chunk", "kv_chunk", "causal_skip"):
        kw.pop(extra, None)
    if impl == "dense":
        return attention_dense(q, k, v, **kw)
    # einsum may hand back permuted views; the kernel takes contiguous
    # operands (a no-op where they already are)
    return get_impl("attention", kernels)(q.contiguous(), k.contiguous(), v.contiguous(), **kw)


# ---------------------------------------------------------------------------
# Attention block (projections + rope + qk-norm)
# ---------------------------------------------------------------------------


def attn_layout(cfg, stacked: tuple[int, ...] = (), cross: bool = False):
    """Projections of an attention block; a cross-attention block
    (``cross``) has no qkv biases, and keeps the qk-norm scales."""
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ax = ("layers",) * len(stacked)
    out = {
        "wq": ParamSpec(stacked + (d, h, dh), ax + ("embed", "heads", "head_dim"), dtype=cfg.dtype),
        "wk": ParamSpec(stacked + (d, kv, dh), ax + ("embed", "kv_heads", "head_dim"), dtype=cfg.dtype),
        "wv": ParamSpec(stacked + (d, kv, dh), ax + ("embed", "kv_heads", "head_dim"), dtype=cfg.dtype),
        "wo": ParamSpec(stacked + (h, dh, d), ax + ("heads", "head_dim", "embed"), dtype=cfg.dtype),
    }
    if cfg.qkv_bias and not cross:
        out["bq"] = ParamSpec(stacked + (h, dh), ax + ("heads", "head_dim"), init="zeros", dtype=cfg.dtype)
        out["bk"] = ParamSpec(stacked + (kv, dh), ax + ("kv_heads", "head_dim"), init="zeros", dtype=cfg.dtype)
        out["bv"] = ParamSpec(stacked + (kv, dh), ax + ("kv_heads", "head_dim"), init="zeros", dtype=cfg.dtype)
    if cfg.qk_norm:
        out["q_norm"] = ParamSpec(stacked + (dh,), ax + ("head_dim",), init="ones", dtype=torch.float32)
        out["k_norm"] = ParamSpec(stacked + (dh,), ax + ("head_dim",), init="ones", dtype=torch.float32)
    return out


def _maybe_qk_norm(params, q, k, eps):
    if "q_norm" in params:
        q = rmsnorm({"scale": params["q_norm"]}, q, eps)
        k = rmsnorm({"scale": params["k_norm"]}, k, eps)
    return q, k


def attn_project_qkv(params, x, cfg, positions):
    """x: (B,S,d) -> q,k,v with rope + optional bias/qk-norm."""
    q = constrain_heads(torch.einsum("bsd,dhk->bshk", x, params["wq"]))
    k = constrain_heads(torch.einsum("bsd,dhk->bshk", x, params["wk"]))
    v = constrain_heads(torch.einsum("bsd,dhk->bshk", x, params["wv"]))
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q, k = _maybe_qk_norm(params, q, k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(params, ctx):
    return constrain_res(torch.einsum("bshk,hkd->bsd", constrain_heads(ctx), params["wo"]))


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_layout(cfg, stacked: tuple[int, ...] = ()):
    d, f = cfg.d_model, cfg.d_ff
    ax = ("layers",) * len(stacked)
    return {
        "w_gate": ParamSpec(stacked + (d, f), ax + ("embed", "ffn"), dtype=cfg.dtype),
        "w_up": ParamSpec(stacked + (d, f), ax + ("embed", "ffn"), dtype=cfg.dtype),
        "w_down": ParamSpec(stacked + (f, d), ax + ("ffn", "embed"), dtype=cfg.dtype),
    }


def mlp(params, x):
    gate = constrain_ffn(torch.einsum("bsd,df->bsf", x, params["w_gate"]))
    up = constrain_ffn(torch.einsum("bsd,df->bsf", x, params["w_up"]))
    act = F.silu(gate.float()).to(x.dtype) * up
    return constrain_res(torch.einsum("bsf,fd->bsd", act, params["w_down"]))


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_layout(cfg):
    axes = ("vocab", None) if cfg.tie_embeddings else ("vocab_table", "embed_table")
    return {
        "embedding": ParamSpec(
            (cfg.vocab_size, cfg.d_model), axes,
            init="embed", init_scale=0.02, dtype=cfg.dtype,
        )
    }


def head_layout(cfg):
    if cfg.tie_embeddings:
        return {}
    return {
        "w": ParamSpec(
            (cfg.d_model, cfg.vocab_size), ("embed", "vocab"), dtype=cfg.dtype
        )
    }


def logits(head_params, embed_params, x, cfg):
    """LM head in the model dtype, upcast to fp32 after the product."""
    if cfg.tie_embeddings:
        # contraction over d (unsharded) -> logits sharded over vocab
        return constrain(
            torch.einsum("bsd,vd->bsv", x, embed_params["embedding"]), None, "model"
        ).float()
    return constrain(torch.einsum("bsd,dv->bsv", x, head_params["w"]), None, "model").float()


def embed_lookup(table, tokens):
    """Token embedding lookup (gather)."""
    return table[tokens]
