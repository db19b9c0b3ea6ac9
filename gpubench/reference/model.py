"""The forward pass of the two block kinds, in fp32, from the published
descriptions.

* ``attention`` (OLMo [arXiv:2402.00838]): pre-norm blocks of causal
  multi-head attention with rotary embeddings (the two halves of each
  head rotated, as GPT-NeoX does) and a SwiGLU MLP; LayerNorm without
  scale or bias; the head tied to the embedding.
* ``mamba2`` (Mamba-2 [arXiv:2405.21060]): pre-RMSNorm blocks of the
  Mamba-2 mixer -- one input projection to z, x, B, C and dt; a causal
  depthwise convolution with SiLU over x, B and C; the SSD scan written
  as the paper's minimal chunked form; the skip D; an RMSNorm of
  y * silu(z); the output projection.

``mm`` is every matrix product (:mod:`gpubench.reference.lowp`), so the
same code runs as the fp8 control.  Weights are the benchmark's tree
(:mod:`gpubench.weights`) upcast to fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def layernorm(x, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def rmsnorm(x, scale, eps):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x: (B, S, H, dh) at positions 0 .. S-1."""
    dh, s = x.shape[-1], x.shape[1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, device=x.device, dtype=torch.float32) / dh)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    a, b = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention_layer(cfg, w, i, x, mm):
    b, s, d = x.shape
    h, kv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = mm(x, w["wq"][i].reshape(d, h * dh)).view(b, s, h, dh)
    k = mm(x, w["wk"][i].reshape(d, kv * dh)).view(b, s, kv, dh)
    v = mm(x, w["wv"][i].reshape(d, kv * dh)).view(b, s, kv, dh)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    rep = h // kv
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, S, dh)
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    scores = mm(q, k.transpose(-1, -2)) * dh ** -0.5
    future = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    ctx = mm(probs, v).transpose(1, 2).reshape(b, s, h * dh)
    return mm(ctx, w["wo"][i].reshape(h * dh, d))


def _mlp(w, i, x, mm):
    return mm(F.silu(mm(x, w["w_gate"][i])) * mm(x, w["w_up"][i]), w["w_down"][i])


def _segsum(x):
    """x: (..., T) -> (..., T, T): [i, j] = x[j+1] + ... + x[i] for j <= i,
    -inf above the diagonal."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    below = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)
    cs = torch.cumsum(x.masked_fill(~below, 0), dim=-2)
    return cs.masked_fill(~torch.ones(t, t, dtype=torch.bool, device=x.device).tril(), float("-inf"))


def ssd(x, a, b, c, chunk):
    """The SSD scan, chunked (the paper's minimal form).  x: (B, S, H, P)
    (already times dt); a: (B, S, H) (dt * A); b, c: (B, S, H, N).
    Returns y (B, S, H, P)."""
    bs, s, h, p = x.shape
    nc = s // chunk
    x, b, c = (t.reshape(bs, nc, chunk, *t.shape[2:]) for t in (x, b, c))
    a = a.reshape(bs, nc, chunk, h).permute(0, 3, 1, 2)  # (B, H, C, L)
    a_cum = torch.cumsum(a, dim=-1)
    decay = torch.exp(_segsum(a))  # (B, H, C, L, L)
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", c, b, decay, x)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", b, decay_states, x)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(_segsum(F.pad(a_cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", c, states, torch.exp(a_cum))
    return (y_diag + y_off).reshape(bs, s, h, p)


def _mamba_layer(cfg, w, i, u, mm):
    sc = cfg["ssm"]
    bs, s, d = u.shape
    d_inner = sc["expand"] * d
    heads, hp = d_inner // sc["head_dim"], sc["head_dim"]
    gn, ng = sc["n_groups"] * sc["d_state"], sc["n_groups"]
    z, xbc, dt = torch.split(mm(u, w["in_proj"][i]), [d_inner, d_inner + 2 * gn, heads], dim=-1)
    width = sc["d_conv"]
    conv_w = w["conv_w"][i].t()[:, None, :]  # (C, 1, W): tap W-1 is the current token
    xbc = F.conv1d(F.pad(xbc.transpose(1, 2), (width - 1, 0)), conv_w, w["conv_b"][i],
                   groups=xbc.shape[-1])
    xbc = F.silu(xbc.transpose(1, 2))
    x, bm, cm = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    x = x.reshape(bs, s, heads, hp)
    rep = heads // ng
    bm = bm.reshape(bs, s, ng, -1).repeat_interleave(rep, 2)
    cm = cm.reshape(bs, s, ng, -1).repeat_interleave(rep, 2)
    dt = F.softplus(dt + w["dt_bias"][i])  # (B, S, H)
    a = -torch.exp(w["A_log"][i])
    chunk = min(sc["chunk_size"], s)
    pad = -s % chunk
    if pad:  # trailing zero steps change nothing before them
        x, bm, cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, bm, cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    y = ssd(x * dt[..., None], dt * a, bm, cm, chunk)[:, :s]
    y = y + x[:, :s] * w["D"][i][:, None]
    y = y.reshape(bs, s, d_inner) * F.silu(z)
    y = rmsnorm(y, w["norm_scale"][i], cfg["norm_eps"])
    return mm(y, w["out_proj"][i])


def _norm(cfg, x, scale):
    if cfg["norm"] == "rmsnorm":
        return rmsnorm(x, scale, cfg["norm_eps"])
    return layernorm(x, cfg["norm_eps"])


def hidden(cfg, w, tokens, mm=torch.matmul, recompute=False):
    """The final normed hidden states (B, S, d) of ``tokens`` (B, S).
    ``recompute`` keeps only each layer's input for the backward pass and
    computes the layer again there, so that fp32 activations of every
    layer need not fit at once."""
    blk = w["blocks"]["block0"]

    def scale(name, i):
        t = blk.get(name, {}).get("scale")
        return None if t is None else t[i]

    def layer(x, i):
        h = _norm(cfg, x, scale("norm_mixer", i))
        if cfg["block"] == "attention":
            x = x + _attention_layer(cfg, blk["attn"], i, h, mm)
            return x + _mlp(blk["mlp"], i, _norm(cfg, x, scale("norm_ffn", i)), mm)
        return x + _mamba_layer(cfg, blk["mamba"], i, h, mm)

    x = w["embed"]["embedding"][tokens]
    for i in range(cfg["n_layers"]):
        x = checkpoint(layer, x, i, use_reentrant=False) if recompute else layer(x, i)
    return _norm(cfg, x, w.get("final_norm", {}).get("scale"))


def logits(cfg, w, h, mm=torch.matmul):
    """The tied head: (..., d) -> fp32 (..., table_rows)."""
    return mm(h, w["embed"]["embedding"].t())
