"""Operations and bytes of the port's work, counted from shapes.

Frozen copies, so that a later change to the port cannot move the
yardstick.  ``*_work`` and :func:`bound_ms` are copied from
``repro_torch/roofline/analytic.py`` at commit 75044a6 (the peaks from
``roofline/analysis.py``): they count the valid rows once and the head
once per call, tiled or not.  Two functions of that module are not
copied, for faults found in them:

* ``decode_kernel_rooflines`` / ``predicted_tick_seconds`` charge the
  cache slab's allocated length (``max_len``) as read, not the valid
  rows: a share of the roofline built on them can pass 100 %.
* ``step_flops(remat=True)`` multiplies the layer body by 4, counting
  remat's recomputed forward as model work; a model-FLOP share counts
  the forward 3 times (forward and backward) and nothing recomputed.

:func:`model_flops` is this module's own count for the ``mfu`` metrics:
each projection, the attention over the causal half (pairs of a query
and a key at or before it), the MLP, the Mamba-2 block with its
intra-chunk product over the causal half, and the head.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80GB, datasheet figures (dense, without sparsity, at
# the card's full 700 W power limit)
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_FP32 = 67e12
PEAK_FLOPS_3XTF32 = 495e12 / 3
HBM_BW = 3.35e12
PEAK_OPS = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_FP32, "3xtf32": PEAK_FLOPS_3XTF32}


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """The least time of the work on the card, in ms, and what bounds it
    (``"bytes"`` or ``"operations"``)."""
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
    group), and of W.x and of the state product (per head)."""
    tri = q * (q + 1) // 2
    nbytes = elem * (2 * bc * h * q * p + 2 * bc * g * q * n) + 4 * (
        2 * bc * h * q + 2 * h + bc * h * n * p)
    return nbytes, bc * 2 * g * tri * n, bc * h * (2 * tri * p + 2 * q * n * p)


def rmsnorm_work(rows, d, elem, *, gated) -> tuple[int, int]:
    """(bytes, operations) of one RMSNorm call over (rows, d): x read and
    y written once (and the gate z read, gated), the fp32 scale once."""
    nbytes = (3 if gated else 2) * rows * d * elem + 4 * d
    return nbytes, (9 if gated else 4) * rows * d


# ---------------------------------------------------------------------------
# Model FLOPs (for the mfu metrics), from a configuration file's sizes
# ---------------------------------------------------------------------------


def _layer_token_flops(cfg: dict) -> float:
    """FLOPs a token costs in one layer, outside the attention's pairs
    and the SSD's intra-chunk product."""
    d = cfg["d_model"]
    if cfg["block"] == "attention":
        h, kv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
        proj = 2 * d * (h + 2 * kv) * dh + 2 * h * dh * d
        return proj + 2 * 3 * d * cfg["d_ff"]
    s = cfg["ssm"]
    d_inner = s["expand"] * d
    heads = d_inner // s["head_dim"]
    gn = s["n_groups"] * s["d_state"]
    proj_dim = 2 * d_inner + 2 * gn + heads
    conv = 2 * (d_inner + 2 * gn) * s["d_conv"]
    state = 2 * 2 * heads * s["d_state"] * s["head_dim"]  # state update and read-out
    return 2 * d * proj_dim + 2 * d_inner * d + conv + state


def _pair_flops(cfg: dict) -> float:
    """FLOPs of one (query, key) pair in one layer: attention's QK^T and
    PV; for an SSD layer, a pair inside one chunk (C.B^T per group, the
    weighted x per head)."""
    if cfg["block"] == "attention":
        return 2 * 2 * cfg["n_heads"] * cfg["head_dim"]
    s = cfg["ssm"]
    heads = s["expand"] * cfg["d_model"] // s["head_dim"]
    return 2 * (s["n_groups"] * s["d_state"] + heads * s["head_dim"])


def forward_flops(cfg: dict, tokens: int, pairs: int, head_rows: int) -> float:
    """One forward pass: ``tokens`` through every layer, ``pairs`` (query,
    key) pairs a layer (attention: causal pairs; SSD: causal pairs within
    the chunks), and the head for ``head_rows`` positions."""
    per_layer = tokens * _layer_token_flops(cfg) + pairs * _pair_flops(cfg)
    return cfg["n_layers"] * per_layer + head_rows * 2 * cfg["d_model"] * cfg["table_rows"]


def causal_pairs(cfg: dict, seq: int, start: int = 0, n: int | None = None) -> int:
    """Pairs a layer computes for the queries ``start .. start + n - 1``
    of one sequence of which ``start`` tokens came before: all the keys
    up to each query (attention), or those in the query's own chunk
    (SSD; the chunks before it reach it through the state)."""
    n = seq - start if n is None else n
    if cfg["block"] == "attention":
        return n * start + n * (n + 1) // 2
    q = cfg["ssm"]["chunk_size"]
    return sum(i % q + 1 for i in range(start, start + n))


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: the forward 3 times (forward,
    and the backward's two products), no remat, the head at every
    position."""
    tokens = batch * seq
    return 3 * forward_flops(cfg, tokens, batch * causal_pairs(cfg, seq), tokens)
