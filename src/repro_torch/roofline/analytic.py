"""Exact analytic FLOP and byte accounting per (arch x shape) and per kernel.

Port of ``repro.roofline.analytic`` on the port's ``block_plans``,
``effective_period`` and ``ssm_dims``: the same conventions and the same
numbers.  One MAC = 2 FLOPs; forward only for inference; training =
forward + backward (2x) + remat recompute (1x when remat is on) = 4x the
forward for all layer compute, 3x (no remat) for the head and loss.
Attention is charged the full S^2 unless ``causal_skip`` halves it.

Beside the reference's per-(arch, shape) counts this module holds the
work of each hand kernel of the port, computed from its shapes: the
bytes it must move (each input read once, each output written once) and
the operations it does, and :func:`bound_ms`, the least time of such
work on the card (``chip_smoke.py``'s bounds come from here).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import ssm as S
from repro_torch.models.transformer import block_plans, effective_period
from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS_BF16, PEAK_OPS


def _attn_layer_flops(cfg, tokens, s_kv, *, causal_skip=False):
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    proj = 2 * tokens * d * (h + 2 * kv) * dh + 2 * tokens * h * dh * d
    score_factor = 0.5 if causal_skip else 1.0
    attn = 2 * 2 * tokens * s_kv * h * dh * score_factor  # QK^T + PV
    return proj, attn


def _cross_attn_layer_flops(cfg, tokens, batch):
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    vt = cfg.vision_tokens
    proj = (
        2 * tokens * d * h * dh                   # q
        + 2 * batch * vt * d * 2 * kv * dh        # k,v over vision tokens
        + 2 * tokens * h * dh * d                 # out
    )
    attn = 2 * 2 * tokens * vt * h * dh
    return proj, attn


def _mlp_flops(cfg, tokens, d_ff):
    return 2 * 3 * tokens * cfg.d_model * d_ff


def _moe_flops(cfg, tokens):
    moe = cfg.moe
    router = 2 * tokens * cfg.d_model * moe.num_experts
    experts = 2 * 3 * tokens * moe.top_k * cfg.d_model * moe.d_ff_expert
    shared = (
        2 * 3 * tokens * cfg.d_model * moe.d_ff_expert * moe.num_shared_experts
    )
    return router + experts + shared


def _ssd_layer_flops(cfg, tokens, batch):
    ssm = cfg.ssm
    d_inner, h, conv_dim, proj_dim = S.ssm_dims(cfg, ssm)
    n, p, g = ssm.state_dim, ssm.head_dim, ssm.num_groups
    q = min(ssm.chunk_size, tokens // max(batch, 1))
    proj = 2 * tokens * cfg.d_model * proj_dim + 2 * tokens * d_inner * cfg.d_model
    conv = 2 * tokens * conv_dim * ssm.conv_width
    # intra-chunk: cb (Q×N×Q per group) + y_intra (Q×Q×P per head)
    intra = 2 * tokens * q * (g * n + h * p)
    # states + y_inter: two (N×P) contractions per token-head
    inter = 2 * 2 * tokens * h * n * p
    norm = 5 * tokens * d_inner
    return proj + conv + intra + inter + norm


def forward_flops(
    cfg: ArchConfig,
    tokens: int,
    batch: int,
    s_kv: int,
    *,
    causal_skip: bool = False,
    with_head: bool = True,
) -> dict[str, float]:
    """One forward pass, token count ``tokens``, KV context ``s_kv``."""
    plans = block_plans(cfg)
    groups = cfg.num_layers // effective_period(cfg)
    proj = attn = ffn = ssd = 0.0
    for plan in plans:
        if plan.mixer == "attn":
            p_, a_ = _attn_layer_flops(cfg, tokens, s_kv, causal_skip=causal_skip)
            proj += p_
            attn += a_
        elif plan.mixer == "cross_attn":
            p_, a_ = _cross_attn_layer_flops(cfg, tokens, batch)
            proj += p_
            attn += a_
        else:
            ssd += _ssd_layer_flops(cfg, tokens, batch)
        if plan.ffn == "dense":
            ffn += _mlp_flops(cfg, tokens, cfg.d_ff)
        elif plan.ffn == "moe":
            ffn += _moe_flops(cfg, tokens)
    out = {
        "proj": proj * groups,
        "attn": attn * groups,
        "ffn": ffn * groups,
        "ssd": ssd * groups,
        "head": 2 * tokens * cfg.d_model * cfg.vocab_size if with_head else 0.0,
    }
    out["total"] = sum(out.values())
    return out


def step_flops(cfg: ArchConfig, shape: ShapeCell, *, remat=True, causal_skip=False):
    """Analytic FLOPs of one step of this cell (global)."""
    if shape.kind == "train":
        f = forward_flops(
            cfg, shape.tokens, shape.global_batch, shape.seq_len,
            causal_skip=causal_skip,
        )
        mult = 4.0 if remat else 3.0  # fwd + bwd(2x) [+ remat fwd]
        body = (f["proj"] + f["attn"] + f["ffn"] + f["ssd"]) * mult
        head = f["head"] * 3.0  # head/loss not rematerialized
        return {"total": body + head, "forward": f}
    if shape.kind == "prefill":
        f = forward_flops(
            cfg, shape.tokens, shape.global_batch, shape.seq_len,
            causal_skip=causal_skip,
        )
        return {"total": f["total"], "forward": f}
    # decode: one token per sequence, context s_kv
    f = forward_flops(
        cfg, shape.global_batch, shape.global_batch, shape.seq_len,
        causal_skip=False,
    )
    return {"total": f["total"], "forward": f}


# ---------------------------------------------------------------------------
# Per-kernel decode rooflines (the serving hot path)
# ---------------------------------------------------------------------------


def _itemsize(cfg: ArchConfig) -> int:
    return torch.empty((), dtype=cfg.dtype).element_size()


DECODE_MODES = ("cuda", "plain")


def decode_kernel_rooflines(
    cfg: ArchConfig, *, batch: int, kv_len: int, mode: str = "cuda"
) -> dict[str, dict[str, float]]:
    """Roofline terms for one call of each decode-path kernel op.

    ``decode_attention`` is one attention layer's one-token step over a
    ``batch``-row microbatch with KV context ``kv_len``: the slab's
    length as allocated (rows past the valid length are charged as
    read), as the reference models it.  :func:`decode_attention_work`
    charges the valid rows the port's kernel reads instead.
    ``emit_norm_logits`` is the final norm and LM-head product for the
    same microbatch.  FLOPs: QK^T + PV (2 * 2 * B * kv_len * H * dh) and
    the head product plus the norm (2 * B * d * V + 6 * B * d).

    Traffic models, per ``mode``:

    * ``"cuda"`` (the reference's ``"pallas"``, term for term): the K
      and V slabs read once, the new K/V rows read and written once (the
      kernel substitutes them on chip; the caller's scatter writes
      them), q read and the context written once; the emit reads the
      head, x and writes fp32 logits in one pass.
    * ``"plain"``: the port's plain path writes the new rows in place
      before reading the slabs (``models.transformer.scatter_decode_rows``),
      so it pays no slab materialised by a functional scatter (the
      reference's ``"xla"`` term ``2 * slab``): the slabs, the new rows
      and q/context once.  Its emit keeps the normed intermediate (one
      write, one read of B x d).  The model charges the algorithm's
      traffic: the layout copies ``torch.einsum`` makes of its operands
      inside the plain attention are not in it.

    Returns ``{op: {"flops", "hbm_bytes", "intensity"}}``; intensity is
    FLOPs per HBM byte.
    """
    if mode not in DECODE_MODES:
        raise ValueError(f"mode {mode!r}: one of {DECODE_MODES}")
    it = _itemsize(cfg)
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    v = cfg.vocab_size

    attn_flops = 2 * 2 * batch * kv_len * h * dh
    slab = batch * kv_len * kv * dh * it          # one of K or V
    rows = batch * kv * dh * it                   # one new row per item
    qout = 2 * batch * h * dh * it                # q read + ctx write
    attn_bytes = 2 * slab + 2 * rows + qout       # read both slabs + new rows
    if mode == "cuda":
        attn_bytes += 2 * rows                    # row-granularity cache write
    emit_flops = 2 * batch * d * v + 6 * batch * d
    emit_bytes = d * v * it + batch * d * it + batch * v * 4  # w + x + f32 out
    if mode == "plain":
        emit_bytes += 2 * batch * d * it          # normed intermediate r/w

    out = {}
    for op, fl, by in (
        ("decode_attention", float(attn_flops), float(attn_bytes)),
        ("emit_norm_logits", float(emit_flops), float(emit_bytes)),
    ):
        out[op] = {"flops": fl, "hbm_bytes": by, "intensity": fl / by}
    return out


def predicted_tick_seconds(
    cfg: ArchConfig,
    *,
    batch: int,
    kv_len: int,
    peak_flops_per_second: float = PEAK_FLOPS_BF16,
    hbm_bytes_per_second: float = HBM_BW,
    mode: str = "cuda",
) -> dict[str, float]:
    """Roofline lower bound for one full-model decode step + emit.

    Sums, over all layers, max(compute, bandwidth) time for (a) the
    weight-streaming matmuls (projections/MLP/SSD: FLOPs from
    :func:`forward_flops`, bytes = parameter bytes less one d x V), and
    (b) the per-kernel decode terms of :func:`decode_kernel_rooflines`
    for every attention layer of ``block_pattern``, plus one emit.  The
    rates default to the H100's datasheet peaks.  Returns ``{"attn",
    "emit", "weights", "total"}`` seconds.

    As in the reference, the weight term subtracts one d x V from the
    parameter count: for an untied model the embedding table stays
    counted as streamed, though a decode step gathers only B of its rows.
    """
    from repro_torch.models.params import param_count
    from repro_torch.models.transformer import model_layout

    def t(flops: float, bytes_: float) -> float:
        return max(flops / peak_flops_per_second, bytes_ / hbm_bytes_per_second)

    per = decode_kernel_rooflines(cfg, batch=batch, kv_len=kv_len, mode=mode)
    n_attn = sum(1 for b in cfg.block_pattern if b == "attn") * (
        cfg.num_layers // cfg.pattern_period
    )
    ka = per["decode_attention"]
    ke = per["emit_norm_logits"]
    attn_s = n_attn * t(ka["flops"], ka["hbm_bytes"])
    emit_s = t(ke["flops"], ke["hbm_bytes"])

    f = forward_flops(cfg, batch, batch, kv_len, with_head=False)
    body_flops = f["proj"] + f["ffn"] + f["ssd"]
    body_bytes = (
        param_count(model_layout(cfg)) - cfg.d_model * cfg.vocab_size
    ) * _itemsize(cfg)
    weights_s = t(body_flops, max(body_bytes, 0))

    return {
        "attn": attn_s,
        "emit": emit_s,
        "weights": weights_s,
        "total": attn_s + emit_s + weights_s,
    }


# ---------------------------------------------------------------------------
# Each hand kernel's work, from its shapes
# ---------------------------------------------------------------------------


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """The least time of the work on the card, in ms, and what bounds it
    (``"bytes"`` or ``"operations"``): the larger of ``nbytes`` over the
    HBM rate and ``ops`` over the peak rate that ``dtype`` (a torch
    dtype or a key of ``PEAK_OPS``) names."""
    name = str(dtype).removeprefix("torch.")
    t_bytes, t_ops = nbytes / HBM_BW, ops / PEAK_OPS[name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def decode_attention_work(b, h, kv, dh, rows, elem) -> tuple[int, int]:
    """(bytes, operations) of one fused decode-attention call over
    ``rows`` valid cache rows in all (the sum over the batch of each
    row's ``kv_len``, the new row among them): q read and the context
    written once, the valid K and V rows read once, each row's position
    and length (int32); 4 * dh operations for each (head, valid row)."""
    nbytes = elem * (2 * b * h * dh + 2 * kv * dh * rows) + 8 * b
    return nbytes, 4 * h * dh * rows


def emit_work(b, d, v, elem, *, scaled) -> tuple[int, int]:
    """(bytes, operations) of one emit call: x and the (d, V) head read
    once, fp32 logits written once, the fp32 norm scale read when the
    norm has one; 2 operations for each multiply-add of the head
    product."""
    nbytes = elem * (b * d + v * d) + 4 * b * v + (4 * d if scaled else 0)
    return nbytes, 2 * b * d * v


def flash_work(b, sq, sk, h, kv, dh, causal, q_offset, lens, elem) -> tuple[int, int]:
    """(bytes, operations) this call needs: q and the output once, the K
    and V rows some query can see once per KV head; 4 * dh operations for
    each (query, head, valid key) pair."""
    pairs = rows = 0
    for n in lens:
        n = min(max(n, 0), sk)
        if causal:
            rows += min(n, max(q_offset + sq, 0))
            pairs += sum(min(n, max(q_offset + i + 1, 0)) for i in range(sq))
        else:
            rows += n
            pairs += sq * n
    nbytes = elem * (2 * b * sq * h * dh + 2 * rows * kv * dh) + 4 * b
    return nbytes, 4 * h * dh * pairs


def ssd_work(bc, h, q, p, g, n, elem) -> tuple[int, int, int]:
    """(bytes, C.B^T operations, per-head operations) of one intra-chunk
    call: x, dt, B, C read once, y, the fp32 state and cum written once;
    2 operations per multiply-add of the lower triangle of C.B^T (once per
    group: it does not depend on the head), and of W.x and of the state
    product (per head)."""
    tri = q * (q + 1) // 2
    nbytes = elem * (2 * bc * h * q * p + 2 * bc * g * q * n) + 4 * (
        2 * bc * h * q + 2 * h + bc * h * n * p)
    return nbytes, bc * 2 * g * tri * n, bc * h * (2 * tri * p + 2 * q * n * p)


def ssd_bound_ms(nbytes, cb_ops, head_ops, dtype) -> tuple[float, str]:
    """The least time of the SSD's work on the tensor cores.  The products
    must be fp32-accurate.  bf16 x, B and C are exact as one bf16 term, so
    C.B^T takes one bf16 product and W.x and the state product, whose fp32
    weights need two bf16 terms (W = hi + lo), take two: the bf16 rate.
    fp32 inputs take every product at the 3xTF32 rate."""
    if dtype == torch.bfloat16:
        return bound_ms(nbytes, cb_ops + 2 * head_ops, torch.bfloat16)
    return bound_ms(nbytes, cb_ops + head_ops, "3xtf32")


def rmsnorm_work(rows, d, elem, *, gated) -> tuple[int, int]:
    """(bytes, operations) of one RMSNorm call over (rows, d): x read and
    y written once (and the gate z read, gated), the fp32 scale once; 4
    operations an element (square, sum, scale, multiply), 9 gated (the
    gate's silu and product besides)."""
    nbytes = (3 if gated else 2) * rows * d * elem + 4 * d
    return nbytes, (9 if gated else 4) * rows * d
