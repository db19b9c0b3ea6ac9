"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060].

PyTorch port of ``repro.models.ssm``: the same functions on the same
parameter dicts, op for op (fp32 upcasts and casts back at the same
places).  Sequence chunks are the cells of a stream whose carried value
is the (H, N, P) state; where the JAX package scans the chunks this port
runs a Python loop (training recomputes it per layer group:
``transformer.forward(remat=True)``).

Layout per block (d_inner = expand * d_model, H = d_inner / head_dim):

    in_proj : d -> [z (d_inner), x (d_inner), B (G*N), C (G*N), dt (H)]
    conv1d  : depthwise width-w over (x ⊕ B ⊕ C)
    A_log, D, dt_bias : (H,)
    norm    : gated RMSNorm over d_inner
    out_proj: d_inner -> d

Kernels (``ssm_block``'s resolved ``kernels`` mode): under ``"cuda"`` a
block of more than one token runs its SSD through the intra-chunk kernel
(``get_impl("ssd", "cuda")``, the sequential cross-chunk scan) and every
block's gated norm, the gate ``y * silu(z)`` included, through the
RMSNorm kernel; ``"plain"`` runs :func:`ssd_chunked` and
``layers.rmsnorm`` as the JAX model does.  A one-token decode step keeps
the closed-form :func:`_ssd_decode_step` in every mode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.kernels import get_impl
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec
from repro_torch.parallel import sharding as SH


def ssm_dims(cfg: ArchConfig, ssm: SSMConfig):
    d_inner = ssm.expand * cfg.d_model
    num_heads = d_inner // ssm.head_dim
    conv_dim = d_inner + 2 * ssm.num_groups * ssm.state_dim
    proj_dim = 2 * d_inner + 2 * ssm.num_groups * ssm.state_dim + num_heads
    return d_inner, num_heads, conv_dim, proj_dim


def ssm_layout(cfg: ArchConfig, ssm: SSMConfig, stacked: tuple[int, ...] = ()):
    d_inner, num_heads, conv_dim, proj_dim = ssm_dims(cfg, ssm)
    ax = ("layers",) * len(stacked)
    f32 = torch.float32
    return {
        "in_proj": ParamSpec(
            stacked + (cfg.d_model, proj_dim), ax + ("embed", "ffn"), dtype=cfg.dtype
        ),
        "conv_w": ParamSpec(
            stacked + (ssm.conv_width, conv_dim), ax + ("conv", "ffn"), dtype=cfg.dtype
        ),
        "conv_b": ParamSpec(
            stacked + (conv_dim,), ax + ("ffn",), init="zeros", dtype=cfg.dtype
        ),
        "A_log": ParamSpec(stacked + (num_heads,), ax + ("heads",), init="zeros", dtype=f32),
        "D": ParamSpec(stacked + (num_heads,), ax + ("heads",), init="ones", dtype=f32),
        "dt_bias": ParamSpec(stacked + (num_heads,), ax + ("heads",), init="zeros", dtype=f32),
        "norm_scale": ParamSpec(stacked + (d_inner,), ax + ("ffn",), init="ones", dtype=f32),
        "out_proj": ParamSpec(
            stacked + (d_inner, cfg.d_model), ax + ("ffn", "embed"), dtype=cfg.dtype
        ),
    }


def _split_proj(proj, cfg, ssm):
    d_inner, num_heads, _, _ = ssm_dims(cfg, ssm)
    gn = ssm.num_groups * ssm.state_dim
    z, xs, bb, cc, dt = torch.split(proj, [d_inner, d_inner, gn, gn, num_heads], dim=-1)
    return z, xs, bb, cc, dt


def ssd_chunked(x, dt, a, b_mat, c_mat, d_skip, *, chunk: int, initial_state=None):
    """Chunked SSD scan.

    x: (B,S,H,P) values; dt: (B,S,H) step sizes (post-softplus);
    a: (H,) negative decay rates; b_mat/c_mat: (B,S,G,N); d_skip: (H,).
    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,N,P) fp32).
    """
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    assert s % chunk == 0, (s, chunk)
    hg = h // g  # heads per group
    f32 = torch.float32
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()

    carry = (
        torch.zeros((bsz, h, n, p), dtype=f32, device=x.device)
        if initial_state is None
        else initial_state.float()
    )
    ys = []
    for start in range(0, s, chunk):
        sl = slice(start, start + chunk)
        x_f = x[:, sl].float()  # (B,Q,H,P)
        dt_b = dt[:, sl].float()  # (B,Q,H)
        b_b = b_mat[:, sl].float()  # (B,Q,G,N)
        c_b = c_mat[:, sl].float()
        da = dt_b * a  # (B,Q,H), negative
        # on a DTensor (batch-sharded, heads whole) each rank's shard:
        # DTensor in torch 2.11 has no strategy for the backward's flip
        cum = (SH.on_shards(torch.cumsum, da, 1) if SH.is_sharded(da)
               else torch.cumsum(da, dim=1))
        total = cum[:, -1, :]  # (B,H)

        # Intra-chunk: L[i,j] = exp(cum_i - cum_j) for j<=i (Q,Q per head).
        decay = torch.where(
            tri[None, :, :, None],
            torch.exp(cum[:, :, None, :] - cum[:, None, :, :]),
            0.0,
        )  # (B,Q,Q,H)
        cb = torch.einsum("bign,bjgn->bijg", c_b, b_b)  # (B,Q,Q,G)
        cb = cb.repeat_interleave(hg, dim=-1)  # (B,Q,Q,H)
        w = cb * decay * dt_b[:, None, :, :]
        y_chunk = torch.einsum("bijh,bjhp->bihp", w, x_f)

        # Inter-chunk: contribution of the carried state.
        ch = c_b.repeat_interleave(hg, dim=2)  # (B,Q,H,N)
        y_chunk = y_chunk + torch.einsum("bqhn,bhnp,bqh->bqhp", ch, carry, torch.exp(cum))

        # State update (the future handed to the next cell).
        state_decay = torch.exp(total[:, None, :] - cum) * dt_b  # (B,Q,H)
        bh = b_b.repeat_interleave(hg, dim=2)
        carry = carry * torch.exp(total)[:, :, None, None] + torch.einsum(
            "bqh,bqhn,bqhp->bhnp", state_decay, bh, x_f
        )
        y_chunk = y_chunk + x_f * d_skip[None, None, :, None]
        ys.append(y_chunk.to(x.dtype))
    return torch.cat(ys, dim=1), carry


def causal_conv1d(x, w, b, *, state=None):
    """Depthwise causal conv. x: (B,S,C), w: (W,C), b: (C,).

    With ``state`` (B,W-1,C): decode or a continued prefill (S may be
    1); returns (y, new_state).  Without: full-sequence, zero history.
    """
    bsz, s, c = x.shape
    width = w.shape[0]
    if state is None:
        hist = torch.zeros((bsz, width - 1, c), dtype=x.dtype, device=x.device)
    else:
        hist = state.to(x.dtype)
    full = torch.cat([hist, x], dim=1)  # (B, S+W-1, C)
    # Accumulate shifted taps (no (B,S,W,C) materialization).
    y = torch.zeros((bsz, s, c), dtype=torch.float32, device=x.device)
    for i in range(width):
        y = y + full[:, i : i + s, :].float() * w[i]
    y = y + b
    new_state = full[:, -(width - 1) :, :] if width > 1 else hist
    return F.silu(y.float()).to(x.dtype), new_state


def ssm_block(params, x, cfg: ArchConfig, ssm: SSMConfig, *, cache=None, kernels="plain"):
    """Full Mamba-2 block.  x: (B,S,d) -> (y, new_cache).

    cache = {"conv": (B,W-1,conv_dim), "state": (B,H,N,P)} for decode
    and chunked prefill; the new cache is returned, not written (the
    caller writes it in place).  ``kernels`` is the resolved mode
    (``"cuda" | "plain"``, see the module docstring).
    """
    d_inner, num_heads, conv_dim, _ = ssm_dims(cfg, ssm)
    proj = L.constrain_ffn(torch.einsum("bsd,dp->bsp", x, params["in_proj"]))
    z, xs, bb, cc, dt = _split_proj(proj, cfg, ssm)

    conv_in = torch.cat([xs, bb, cc], dim=-1)
    conv_state = None if cache is None else cache["conv"]
    conv_out, new_conv = causal_conv1d(
        conv_in, params["conv_w"], params["conv_b"], state=conv_state
    )
    gn = ssm.num_groups * ssm.state_dim
    xs, bb, cc = torch.split(conv_out, [d_inner, gn, gn], dim=-1)

    bsz, s, _ = x.shape
    xh = xs.reshape(bsz, s, num_heads, ssm.head_dim)
    bm = bb.reshape(bsz, s, ssm.num_groups, ssm.state_dim)
    cm = cc.reshape(bsz, s, ssm.num_groups, ssm.state_dim)
    a = -torch.exp(params["A_log"].float())
    dt_act = F.softplus(dt.float() + params["dt_bias"])
    d_skip = params["D"]
    if SH.ACTIVE_MESH is not None:
        # the scan's operands pinned batch-sharded with their heads whole,
        # the per-head parameters replicated (the reference has no pin;
        # DTensor in torch 2.11 cannot fold a product's (batch, head) dims
        # when both are sharded)
        xh, bm, cm, dt_act = (L.constrain(t, *(None,) * (t.dim() - 1))
                              for t in (xh, bm, cm, dt_act))
        a, d_skip = (SH.maybe_constrain(t, SH.PartitionSpec()) for t in (a, d_skip))

    init_state = None if cache is None else cache["state"]
    if cache is not None and s == 1:
        # Single-token decode: closed-form state update (no chunking).
        y, final = _ssd_decode_step(xh, dt_act, a, bm, cm, d_skip, init_state)
    else:
        chunk = min(ssm.chunk_size, s)
        ssd = get_impl("ssd", "cuda") if kernels == "cuda" and s > 1 else ssd_chunked
        y, final = ssd(xh, dt_act, a, bm, cm, d_skip, chunk=chunk,
                       initial_state=init_state)

    if SH.ACTIVE_MESH is not None:
        y = L.constrain(y, None, None, None)  # and so its gradient
    y = y.reshape(bsz, s, d_inner)
    # gated RMSNorm (Mamba-2): norm(y * silu(z)); the kernel computes the
    # gate in the same launch, reading z in place from proj
    if kernels == "cuda":
        y = get_impl("rmsnorm", "cuda")(y, params["norm_scale"], cfg.norm_eps, gate=z)
    else:
        gated = y * F.silu(z.float()).to(y.dtype)
        y = L.rmsnorm({"scale": params["norm_scale"]}, gated, cfg.norm_eps)
    out = L.constrain_res(torch.einsum("bsi,id->bsd", y, params["out_proj"]))
    return out, {"conv": new_conv, "state": final}


def _ssd_decode_step(xh, dt, a, bm, cm, d_skip, state):
    """One-token SSD update. xh: (B,1,H,P); state: (B,H,N,P)."""
    h = xh.shape[2]
    hg = h // bm.shape[2]
    x0 = xh[:, 0].float()  # (B,H,P)
    dt0 = dt[:, 0]  # (B,H)
    b0 = bm[:, 0].repeat_interleave(hg, dim=1).float()  # (B,H,N)
    c0 = cm[:, 0].repeat_interleave(hg, dim=1).float()
    decay = torch.exp(dt0 * a)  # (B,H)
    st = state.float() * decay[:, :, None, None] + torch.einsum(
        "bh,bhn,bhp->bhnp", dt0, b0, x0
    )
    y = torch.einsum("bhn,bhnp->bhp", c0, st) + x0 * d_skip[None, :, None]
    return y[:, None].to(xh.dtype), st


def init_ssm_cache(cfg: ArchConfig, ssm: SSMConfig, batch: int, dtype,
                   device: str | torch.device = "cuda"):
    _, num_heads, conv_dim, _ = ssm_dims(cfg, ssm)
    device = resolve_device(device)
    return {
        "conv": torch.zeros((batch, ssm.conv_width - 1, conv_dim), dtype=dtype, device=device),
        "state": torch.zeros(
            (batch, num_heads, ssm.state_dim, ssm.head_dim), dtype=torch.float32, device=device
        ),
    }
