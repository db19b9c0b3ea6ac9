"""Decoder (PyTorch port of ``repro.models.transformer``).

Layers are grouped into a repeating *period*; parameters are stacked
over ``num_layers / period`` groups, and where the JAX package scans the
stack this port runs a Python loop over the groups.

Every block kind of the zoo: self-attention, Mamba-2 (``models.ssm``)
or gated cross-attention to vision tokens, each with a dense MLP, a
Mixture-of-Experts MLP (``models.moe``) or none -- dense decoders
(olmo-1b, qwen1.5-4b, qwen3-32b, internlm2-20b), MoE decoders
(moonshot-v1-16b-a3b, llama4-maverick-400b-a17b), the hybrid
jamba-1.5-large-398b, pure SSMs (mamba2-1.3b), the vision-language
llama-3.2-vision-90b (``vision_embeds``: precomputed patch embeddings,
whose K/V the cache keeps) and the embedding-input musicgen-medium
(``embeds`` in place of ``tokens``: its frontend is a stub).

Step kinds:
  * ``forward``      -- logits for full sequences.
  * ``prefill_step`` -- one prompt chunk written into the KV cache.
  * ``decode_step``  -- one token per sequence against the KV cache.
  * ``make_decode_cell`` / ``make_decode_emit`` -- decode as Stream cells
    (layer groups) and the feedback emit, for ``serve.engine.StreamEngine``.

Unlike the JAX package's functional ``.at[].set`` updates, the cache
is updated **in place**: ``prefill_step`` writes the chunk's K/V rows and
``decode_step`` one row per sequence into the cache tensors it is given,
a Mamba block overwrites its conv and SSD state, and both return that
same cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import pytree as P
from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import graph as G
from repro_torch.kernels import get_impl, resolve_mode
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.params import ParamSpec
from repro_torch.roofline import trace as TR

PyTree = Any

_ZERO_AUX = {"moe_lb_loss": 0.0, "moe_z_loss": 0.0, "moe_drop_fraction": 0.0}


# ---------------------------------------------------------------------------
# Block plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    mixer: str  # "attn" | "mamba" | "cross_attn"
    ffn: str    # "dense" | "moe" | "none"


def effective_period(cfg: ArchConfig) -> int:
    period = cfg.pattern_period
    if cfg.moe is not None:
        period = math.lcm(period, cfg.moe.every_k_layers)
    if cfg.cross_attn_every > 0:
        period = math.lcm(period, cfg.cross_attn_every)
    return period


def block_plans(cfg: ArchConfig) -> list[BlockPlan]:
    period = effective_period(cfg)
    plans = []
    for i in range(period):
        mixer = cfg.block_pattern[i % cfg.pattern_period]
        if (
            cfg.cross_attn_every > 0
            and i % cfg.cross_attn_every == cfg.cross_attn_every - 1
        ):
            mixer = "cross_attn"
        if cfg.d_ff == 0 and cfg.moe is None:
            ffn = "none"
        elif cfg.moe is not None and (
            i % cfg.moe.every_k_layers == cfg.moe.every_k_layers - 1
        ):
            ffn = "moe"
        else:
            ffn = "dense"
        plans.append(BlockPlan(mixer, ffn))
    return plans


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


def model_layout(cfg: ArchConfig) -> PyTree:
    period = effective_period(cfg)
    if cfg.num_layers % period != 0:
        raise ValueError(f"{cfg.num_layers=} not divisible by period {period}")
    stacked = (cfg.num_layers // period,)
    plans = block_plans(cfg)

    blocks: dict[str, PyTree] = {}
    for i, plan in enumerate(plans):
        blk: dict[str, PyTree] = {
            "norm_mixer": L.make_norm_layout(cfg.norm, cfg.d_model, stacked),
        }
        if plan.mixer in ("attn", "cross_attn"):
            blk["attn"] = L.attn_layout(cfg, stacked, cross=plan.mixer == "cross_attn")
            if plan.mixer == "cross_attn":
                blk["xattn_gate"] = {"gate": ParamSpec(stacked + (1,), ("layers", None),
                                                       init="zeros", dtype=torch.float32)}
        else:
            blk["mamba"] = S.ssm_layout(cfg, cfg.ssm, stacked)
        if plan.ffn != "none":
            blk["norm_ffn"] = L.make_norm_layout(cfg.norm, cfg.d_model, stacked)
            if plan.ffn == "moe":
                blk["moe"] = M.moe_layout(cfg, cfg.moe, stacked)
            else:
                blk["mlp"] = L.mlp_layout(cfg, stacked=stacked)
        blocks[f"block{i}"] = blk

    return {
        "embed": L.embed_layout(cfg),
        "blocks": blocks,
        "final_norm": L.make_norm_layout(cfg.norm, cfg.d_model, ()),
        "head": L.head_layout(cfg),
    }


# ---------------------------------------------------------------------------
# Cache layout (decode)
# ---------------------------------------------------------------------------


def cache_layout(cfg: ArchConfig, batch: int, max_len: int) -> PyTree:
    """Abstract cache: dict mirroring blocks, leaves ``meta`` tensors.

    Attention: K/V (groups, B, Smax, KV, dh).  Cross-attention: the
    vision tokens' K/V (groups, B, vision_tokens, KV, dh), which a
    prefill chunk given ``vision_embeds`` writes and decode only reads.
    Mamba: conv (groups, B, W-1, conv_dim) in ``cfg.dtype`` and state
    (groups, B, H, N, P) fp32.
    """
    groups = cfg.num_layers // effective_period(cfg)
    plans = block_plans(cfg)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    caches: dict[str, PyTree] = {}
    for i, plan in enumerate(plans):
        if plan.mixer in ("attn", "cross_attn"):
            rows = max_len if plan.mixer == "attn" else cfg.vision_tokens
            shape = (groups, batch, rows, cfg.num_kv_heads, cfg.head_dim)
            caches[f"block{i}"] = {"k": meta(shape, cfg.dtype), "v": meta(shape, cfg.dtype)}
        else:
            _, num_heads, conv_dim, _ = S.ssm_dims(cfg, cfg.ssm)
            caches[f"block{i}"] = {
                "conv": meta((groups, batch, cfg.ssm.conv_width - 1, conv_dim), cfg.dtype),
                "state": meta(
                    (groups, batch, num_heads, cfg.ssm.state_dim, cfg.ssm.head_dim),
                    torch.float32,
                ),
            }
    return caches


def cache_logical_axes(cfg: ArchConfig) -> PyTree:
    """Logical axes per cache leaf (for sharding rules): the vision K/V
    of a cross-attention block is not sharded on its sequence."""
    axes: dict[str, PyTree] = {}
    for i, plan in enumerate(block_plans(cfg)):
        if plan.mixer in ("attn", "cross_attn"):
            seq = "kv_seq" if plan.mixer == "attn" else None
            ax = ("layers", "batch", seq, "kv_heads", "head_dim")
            axes[f"block{i}"] = {"k": ax, "v": ax}
        else:
            axes[f"block{i}"] = {
                "conv": ("layers", "batch", None, "ffn"),
                "state": ("layers", "batch", "heads", "state", None),
            }
    return axes


def init_cache(
    cfg: ArchConfig, batch: int, max_len: int, device: str | torch.device = "cuda"
) -> PyTree:
    """A zeroed cache on ``device``; ``prefill_step`` and
    ``decode_step`` update it in place."""
    device = resolve_device(device)
    return {
        name: {k: torch.zeros_like(t, device=device) for k, t in blk.items()}
        for name, blk in cache_layout(cfg, batch, max_len).items()
    }


def _group(tree: PyTree, g: int) -> PyTree:
    """Layer group ``g`` of a group-stacked tree, as views (writes to a
    cache view land in the stacked cache)."""
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g]


def _num_groups(params) -> int:
    tree = params["blocks"]
    while isinstance(tree, dict):  # any leaf: all are stacked over the groups
        tree = next(v for v in tree.values() if not isinstance(v, dict) or v)
    return tree.shape[0]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _norm(cfg, params, x, kernels="plain"):
    """A block's norm.  ``kernels`` is the resolved mode: under ``"cuda"``
    an rmsnorm runs the RMSNorm kernel (the block pre-norms pass it); the
    final norms call this in ``"plain"``, and OLMo's non-parametric
    layernorm is plain in every mode."""
    if cfg.norm == "rmsnorm":
        if kernels == "cuda":
            return get_impl("rmsnorm", "cuda")(x, params["scale"], cfg.norm_eps)
        return L.rmsnorm(params, x, cfg.norm_eps)
    return L.layernorm_nonparam(x, cfg.norm_eps)


def _self_attn(
    params, x, cfg, *, positions, cache=None, cache_pos=None, kv_len=None,
    attn_impl="dense", q_chunk=512, kv_chunk=1024, causal_skip=None,
    kernels="plain",
):
    """Self-attention; with cache: decode or chunked prefill.
    Returns (out, (k, v)) with this call's K/V.

    ``attn_impl`` (``"dense" | "chunked" | "flash"``) picks the attention
    core (``layers.attention``); ``kernels`` is the resolved mode, which
    for ``"flash"`` picks the CUDA kernel or its plain version.

    Decode (S==1, ``cache_pos`` a tensor): (B,) int32 per-sequence write
    positions; the new K/V row of each sequence is written in place at
    its position.  ``kernels="cuda"`` reads attention through the fused
    decode-attention kernel (new row substituted on chip, cache read
    before the write), which takes precedence over ``attn_impl`` as in
    the JAX package; ``"plain"`` writes the row first and runs
    ``attn_impl`` over the cache.

    Chunked prefill (S>=1): ``cache_pos`` is an int chunk offset; the
    chunk is written in place at [pos, pos+S) -- which must lie inside
    the cache (the JAX package's ``dynamic_update_slice`` would clamp
    the offset instead) -- and attends causally to the cache.
    """
    q, k, v = L.attn_project_qkv(params, x, cfg, positions)
    impl = dict(impl=attn_impl, kernels=kernels, q_chunk=q_chunk, kv_chunk=kv_chunk,
                causal_skip=causal_skip)
    if cache is None:
        return L.attn_out(params, L.attention(q, k, v, causal=True, **impl)), (k, v)
    s = x.shape[1]
    ck, cv = cache["k"], cache["v"]
    if torch.is_tensor(cache_pos):  # decode (a one-token prefill chunk has an int pos)
        rows_k = k[:, 0].to(ck.dtype)
        rows_v = v[:, 0].to(cv.dtype)
        if kernels == "cuda":
            # einsum may hand back permuted views; the kernel takes
            # contiguous operands (a no-op where they already are)
            ctx = get_impl("decode_attention", "cuda")(
                q.contiguous(), rows_k.contiguous(), rows_v.contiguous(),
                ck, cv, pos=cache_pos, kv_len=kv_len,
            )
            scatter_decode_rows(cache, rows_k, rows_v, cache_pos)
            return L.attn_out(params, ctx), (k, v)
        scatter_decode_rows(cache, rows_k, rows_v, cache_pos)
        causal, q_offset = False, 0
    else:
        if cache_pos + s > ck.shape[1]:
            raise ValueError(
                f"prefill chunk [{cache_pos}, {cache_pos + s}) overruns the "
                f"cache of {ck.shape[1]} rows"
            )
        ck[:, cache_pos : cache_pos + s] = k.to(ck.dtype)
        cv[:, cache_pos : cache_pos + s] = v.to(cv.dtype)
        causal, q_offset = True, cache_pos
    ctx = L.attention(
        q, ck, cv, causal=causal, q_offset=q_offset, kv_len=kv_len, **impl,
    )
    return L.attn_out(params, ctx), (k, v)


def _cross_attn(
    params, gate, x, cfg, *, vision_kv=None, vision_embeds=None,
    attn_impl="dense", q_chunk=512, kv_chunk=1024, kernels="plain",
):
    """Gated cross-attention to vision tokens (llama-3.2 style).  Returns
    (out, {"k", "v"}): the vision K/V it attended to.

    Fresh ``vision_embeds`` (B, V, d) are projected to K/V (then
    ``k_norm``); otherwise ``vision_kv`` holds K/V as a prefill wrote
    them (normalised already).  No RoPE and no mask: every query sees
    every vision token (``causal=False``), through ``attn_impl`` -- the
    flash kernel under ``"flash"`` with ``kernels="cuda"``.  The output
    is scaled by ``tanh(gate)``, so a zero gate (``init_params``' own)
    makes the block add exactly 0."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if "q_norm" in params:
        q = L.rmsnorm({"scale": params["q_norm"]}, q, cfg.norm_eps)
    if vision_kv is not None:
        k, v = vision_kv["k"], vision_kv["v"]
    else:
        # jnp.einsum promotes mixed operands (bf16 embeds against fp32
        # weights compute in fp32); torch.einsum takes one dtype
        dtype = torch.promote_types(vision_embeds.dtype, params["wk"].dtype)
        e = vision_embeds.to(dtype)
        k = torch.einsum("bvd,dhk->bvhk", e, params["wk"].to(dtype))
        v = torch.einsum("bvd,dhk->bvhk", e, params["wv"].to(dtype))
        if "k_norm" in params:
            k = L.rmsnorm({"scale": params["k_norm"]}, k, cfg.norm_eps)
    ctx = L.attention(q, k, v, impl=attn_impl, kernels=kernels, causal=False,
                      q_chunk=q_chunk, kv_chunk=kv_chunk)
    out = L.attn_out(params, ctx)
    return torch.tanh(gate["gate"]).to(out.dtype) * out, {"k": k, "v": v}


def scatter_decode_rows(cache, rows_k, rows_v, pos):
    """One decode step's cache writes, in place: sequence b's new K/V row
    ``(KV, dh)`` lands at ``[b, pos[b]]`` of the block's cache
    ``(B, S, KV, dh)``, which may be a view of a microbatch's rows of the
    whole cache (a decode cell's): the write lands in the cache.  The
    bytes written are the rows.  The reference's ``scatter_decode_rows``
    scatters the rows a functional step returns; here the step writes
    them where they belong."""
    idx = torch.arange(rows_k.shape[0], device=rows_k.device)
    pos = pos.long()
    cache["k"][idx, pos] = rows_k
    cache["v"][idx, pos] = rows_v


def _apply_group(
    group_params, x, cfg, plans, *, positions, group_cache=None,
    cache_pos=None, kv_len=None, vision_embeds=None, collect_kv=False,
    attn_impl="dense", q_chunk=512, kv_chunk=1024, causal_skip=None,
    kernels="plain",
):
    """Apply one period group.  Returns (x, kv, aux) where kv maps each
    block to its full-sequence K/V (a Mamba block: its conv and SSD
    state; a cross-attention block: its vision K/V) when ``collect_kv``
    (forward only), and aux holds the MoE blocks' auxiliary losses
    averaged over the group's MoE blocks (zeros where it has none).

    A Mamba block writes its new conv and SSD state into the group's
    cache view in place, as attention writes its K/V rows.  A
    cross-attention block given fresh ``vision_embeds`` (forward, a
    prefill chunk) attends to them rather than to the cache, and writes
    their K/V into the cache in place; without them it reads the
    cache's vision K/V and writes nothing (decode)."""
    kv_out: dict[str, PyTree] = {}
    aux = dict(_ZERO_AUX)
    num_moe = 0
    for i, plan in enumerate(plans):
        name = f"block{i}"
        blk = group_params[name]
        cache_i = None if group_cache is None else group_cache[name]
        h = _norm(cfg, blk.get("norm_mixer"), x, kernels)
        if plan.mixer == "attn":
            out, kv = _self_attn(
                blk["attn"], h, cfg, positions=positions, cache=cache_i,
                cache_pos=cache_pos, kv_len=kv_len, attn_impl=attn_impl,
                q_chunk=q_chunk, kv_chunk=kv_chunk, causal_skip=causal_skip,
                kernels=kernels,
            )
            if collect_kv:
                kv_out[name] = {"k": kv[0], "v": kv[1]}
        elif plan.mixer == "cross_attn":
            if vision_embeds is None and cache_i is None:
                raise ValueError(f"{cfg.name}: cross-attention needs vision_embeds or a cache "
                                 "holding their K/V")
            out, vkv = _cross_attn(
                blk["attn"], blk["xattn_gate"], h, cfg,
                vision_kv=cache_i if vision_embeds is None else None,
                vision_embeds=vision_embeds, attn_impl=attn_impl, q_chunk=q_chunk,
                kv_chunk=kv_chunk, kernels=kernels,
            )
            if vision_embeds is not None and cache_i is not None:
                cache_i["k"].copy_(vkv["k"])
                cache_i["v"].copy_(vkv["v"])
            if collect_kv:
                kv_out[name] = vkv
        else:  # mamba
            out, c_new = S.ssm_block(blk["mamba"], h, cfg, cfg.ssm, cache=cache_i,
                                     kernels=kernels)
            if cache_i is not None:
                cache_i["conv"].copy_(c_new["conv"])
                cache_i["state"].copy_(c_new["state"])
            if collect_kv:
                kv_out[name] = c_new
        x = L.constrain_res(x + out)
        if plan.ffn != "none":
            h = _norm(cfg, blk.get("norm_ffn"), x, kernels)
            if plan.ffn == "moe":
                out, moe_aux = M.moe_apply(blk["moe"], h, cfg.moe)
                aux = {key: aux[key] + moe_aux[key] for key in aux}
                num_moe += 1
            else:
                out = L.mlp(blk["mlp"], h)
            x = L.constrain_res(x + out)
    if num_moe:
        aux = {key: v / num_moe for key, v in aux.items()}
    return x, kv_out, aux


# ---------------------------------------------------------------------------
# Model entry points
# ---------------------------------------------------------------------------


def _embed_input(params, cfg: ArchConfig, tokens=None, embeds=None):
    """The decoder's input: ``embeds`` cast to ``cfg.dtype`` for an
    embedding-input arch (its frontend is a stub), else the token
    embeddings.  Either is contiguous, as the first block pre-norm's
    kernel takes it: ``embeds`` may be a strided view (a window of a
    longer frame sequence)."""
    if cfg.embeds_input:
        if embeds is None:
            raise ValueError(f"{cfg.name} takes embeddings (embeds=), not tokens")
        return embeds.to(cfg.dtype).contiguous()
    if tokens is None:
        raise ValueError(f"{cfg.name} takes tokens")
    return L.embed_lookup(params["embed"]["embedding"], tokens)


def _input_device(tokens, embeds) -> torch.device:
    if tokens is None and embeds is None:
        raise ValueError("the decoder takes tokens or embeds; neither was given")
    return (tokens if tokens is not None else embeds).device


def forward(
    params, cfg: ArchConfig, *, tokens=None, embeds=None, vision_embeds=None,
    collect_kv=False, cache_pad_to=None, attn_impl="dense", q_chunk=512,
    kv_chunk=1024, causal_skip=None, kernels=None, remat=True,
):
    """Full-sequence forward.  Returns (logits, caches|None, aux).

    ``tokens`` (B, S), or ``embeds`` (B, S, d) for an embedding-input
    arch; ``vision_embeds`` (B, vision_tokens, d) for a cross-attention
    arch.  ``collect_kv`` also returns each block's K/V stacked over
    groups, (groups, B, S, KV, dh), a self-attention block's zero-padded
    along S to ``cache_pad_to`` (a cross-attention block's vision K/V
    keeps its ``vision_tokens`` rows, as ``cache_layout`` has them; a
    Mamba block: its conv and SSD state, stacked, not padded).
    ``kernels`` (None inherits ``cfg.kernels``) picks, under
    ``attn_impl="flash"``, the flash kernel or its plain version, for
    Mamba blocks the SSD and RMSNorm kernels or their plain versions, and
    for an rmsnorm model's block pre-norms the RMSNorm kernel or
    ``layers.rmsnorm``.  The final norm is plain in every mode.
    ``aux`` holds the MoE auxiliary losses: the mean over layer groups of
    each group's mean over its MoE blocks, as the reference's scan
    averages them (zeros for a model without MoE blocks).
    ``remat`` (the reference's ``jax.checkpoint`` per group): under
    autograd, each layer group keeps only its input and is recomputed on
    the backward pass (``graph._checkpoint``, non-reentrant); without
    autograd it changes nothing.  Under ``torch.profiler`` each group runs
    in a span ``model.group``, and so does its recompute.  The
    reference's ``unroll`` is an XLA knob with no counterpart here.
    """
    L.check_attn_impl(attn_impl)
    plans = block_plans(cfg)
    mode = resolve_mode(cfg.kernels if kernels is None else kernels,
                        _input_device(tokens, embeds))
    x = _embed_input(params, cfg, tokens, embeds)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    def group_fn(group_params, x, vision_embeds):
        # inside the checkpoint, so the span also marks remat's recompute
        with TR.span(TR.MODEL_GROUP):
            return _apply_group(
                group_params, x, cfg, plans,
                positions=positions, vision_embeds=vision_embeds, collect_kv=collect_kv,
                attn_impl=attn_impl, q_chunk=q_chunk, kv_chunk=kv_chunk,
                causal_skip=causal_skip, kernels=mode,
            )

    if remat:
        group_fn = G._checkpoint(group_fn)
    kvs, auxs = [], []
    for g in range(_num_groups(params)):
        x, kv, aux = group_fn(_group(params["blocks"], g), x, vision_embeds)
        kvs.append(kv)
        auxs.append(aux)
    x = _norm(cfg, params.get("final_norm"), x)
    lg = L.logits(params.get("head"), params["embed"], x, cfg)

    caches = None
    if collect_kv:
        caches = {}
        for name in kvs[0]:
            caches[name] = {}
            self_attn = plans[int(name.removeprefix("block"))].mixer == "attn"
            for key in kvs[0][name]:
                t = torch.stack([kv[name][key] for kv in kvs])
                if self_attn and cache_pad_to is not None and t.shape[2] < cache_pad_to:
                    pad = t.new_zeros(t.shape[:2] + (cache_pad_to - t.shape[2],) + t.shape[3:])
                    t = torch.cat([t, pad], dim=2)
                caches[name][key] = t
    aux = {key: sum(a[key] for a in auxs) / len(auxs) for key in _ZERO_AUX}
    return lg, caches, aux


class Transformer(torch.nn.Module):
    """A thin ``nn.Module`` that owns a parameter tree: the nested dict
    with ``model_layout``'s keys, held as frozen parameters (``.to``,
    ``state_dict`` and the like work on it).  ``params`` hands the tree
    back to the functions of this module and to the serving engine;
    calling the module runs :func:`forward` and returns its logits."""

    def __init__(self, cfg: ArchConfig, params: PyTree):
        super().__init__()
        self.cfg = cfg
        self.tree = _to_module(params)

    @property
    def params(self) -> PyTree:
        return _from_module(self.tree)

    def forward(self, tokens: torch.Tensor | None = None, *, embeds=None,
                vision_embeds=None) -> torch.Tensor:
        return forward(self.params, self.cfg, tokens=tokens, embeds=embeds,
                       vision_embeds=vision_embeds)[0]


def _to_module(tree: dict) -> torch.nn.Module:
    """A module per dict: its tensors as frozen parameters, its dicts as
    submodules (a MoE block's dict holds both)."""
    module = torch.nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            module.add_module(k, _to_module(v))
        else:
            module.register_parameter(k, torch.nn.Parameter(v, requires_grad=False))
    return module


def _from_module(module: torch.nn.Module) -> PyTree:
    tree = dict(module.named_parameters(recurse=False))
    tree.update({k: _from_module(v) for k, v in module.named_children()})
    return tree


def _emit_logits(params, cfg: ArchConfig, x, kernels: str = "plain"):
    """Final-norm -> logits for one decode position: (B, 1, d) -> (B, V).

    Under ``kernels="cuda"`` the two ops run as one fused kernel (the
    norm recomputed per vocab tile on chip); ``"plain"`` runs them as
    PyTorch ops.
    """
    if kernels == "cuda":
        w = (
            params["embed"]["embedding"]
            if cfg.tie_embeddings
            else params["head"]["w"]
        )
        fn = params.get("final_norm")
        return get_impl("emit_norm_logits", "cuda")(
            x, w, norm=cfg.norm,
            scale=fn["scale"] if cfg.norm == "rmsnorm" else None,
            eps=cfg.norm_eps, tied=cfg.tie_embeddings,
        )
    xn = _norm(cfg, params.get("final_norm"), x)
    return L.logits(params.get("head"), params["embed"], xn, cfg)[:, 0, :]


def decode_step(
    params, caches, cfg: ArchConfig, *, tokens=None, embeds=None, lengths=None,
    attn_impl="dense", kv_chunk=1024, kernels=None,
):
    """One-token step.  tokens: (B,) int (or embeds (B, 1, d) for an
    embedding-input arch); lengths: (B,) int32 current context length per
    sequence (the cache write position).  Returns (logits (B, V) fp32,
    caches), the caches updated in place; a cross-attention block reads
    the vision K/V of the cache and leaves it as it is.

    ``kernels`` (None inherits ``cfg.kernels``) selects the per-op
    implementations (see ``repro_torch.kernels``): ``"cuda"`` runs the
    fused decode-attention and emit kernels (and each Mamba block's gated
    norm and an rmsnorm model's block pre-norms through the RMSNorm
    kernel), ``"plain"`` the PyTorch versions,
    ``"auto"`` the kernels on a CUDA device.  ``attn_impl`` applies where
    the decode-attention kernel does not run."""
    L.check_attn_impl(attn_impl)
    plans = block_plans(cfg)
    device = _input_device(tokens, embeds)
    mode = resolve_mode(cfg.kernels if kernels is None else kernels, device)
    if cfg.embeds_input:
        x = _embed_input(params, cfg, embeds=embeds)
    else:
        x = _embed_input(params, cfg, tokens)[:, None, :]
    bsz = x.shape[0]
    if lengths is None:
        lengths = torch.zeros((bsz,), dtype=torch.int32, device=device)
    lengths = lengths.to(torch.int32)
    positions = lengths[:, None]
    kv_len = (lengths + 1)[:, None]  # (B,1) valid kv after the write
    for g in range(_num_groups(params)):
        x, _, _ = _apply_group(
            _group(params["blocks"], g), x, cfg, plans,
            positions=positions, group_cache=_group(caches, g),
            cache_pos=lengths, kv_len=kv_len, attn_impl=attn_impl,
            q_chunk=1, kv_chunk=kv_chunk, kernels=mode,
        )
    return _emit_logits(params, cfg, x, mode), caches


def _cache_seq_len(caches, plans):
    """Rows of the cache's self-attention K/V (None without one): never
    a cross-attention block's, whose rows are the vision tokens."""
    for i, plan in enumerate(plans):
        if plan.mixer == "attn":
            return caches[f"block{i}"]["k"].shape[2]
    return None


def prefill_step(
    params, caches, cfg: ArchConfig, *, tokens=None, embeds=None, pos: int = 0,
    vision_embeds=None, attn_impl="dense", q_chunk=512, kv_chunk=1024,
    logits_at: int | None = None, kernels=None,
):
    """Chunked prefill: process a prompt chunk at offset ``pos``.

    tokens: (B, C) (or embeds (B, C, d) for an embedding-input arch).
    Writes the chunk's K/V into ``caches`` in place at [pos, pos + C),
    which must lie inside the cache.  A cross-attention arch's chunk
    given ``vision_embeds`` (B, vision_tokens, d) attends to them and
    writes their K/V into the cache; a chunk without them attends to the
    vision K/V already there.  Returns (logits
    (B, V), caches) -- logits at the chunk's last position, or at index
    ``logits_at`` when given (a ragged prompt tail padded to one masked
    chunk reads its logits at the last *real* position; pad queries only
    pollute pad rows, which the next decode's write position and kv_len
    mask retire).

    ``kernels`` (None inherits ``cfg.kernels``) picks, under
    ``attn_impl="flash"``, the flash kernel (``"cuda"``, or ``"auto"`` on
    a CUDA device) or its plain version; the chunk's queries sit at
    ``q_offset = pos`` and see ``kv_len = pos + C`` keys.  Mamba blocks
    run their SSD and gated norm through the SSD and RMSNorm kernels,
    and an rmsnorm model's block pre-norms through the RMSNorm kernel,
    under the same mode.  The other ops of prefill, the final norm among
    them, run plain PyTorch in every mode.

    A Mamba block folds every token of the chunk into its conv and SSD
    state, pad tokens included: a ragged tail of an SSM model is
    prefilled unpadded (see ``serve.engine``).
    """
    L.check_attn_impl(attn_impl)
    plans = block_plans(cfg)
    mode = resolve_mode(cfg.kernels if kernels is None else kernels,
                        _input_device(tokens, embeds))
    x = _embed_input(params, cfg, tokens, embeds)
    s = x.shape[1]
    positions = (pos + torch.arange(s, device=x.device))[None, :]
    # Whole-cache prefill (pos 0, chunk covers the buffer): nothing to mask.
    full_cover = pos == 0 and _cache_seq_len(caches, plans) == s
    kv_len = None if full_cover else pos + s
    for g in range(_num_groups(params)):
        x, _, _ = _apply_group(
            _group(params["blocks"], g), x, cfg, plans,
            positions=positions, group_cache=_group(caches, g),
            cache_pos=pos, kv_len=kv_len, vision_embeds=vision_embeds,
            attn_impl=attn_impl, q_chunk=q_chunk, kv_chunk=kv_chunk, kernels=mode,
        )
    at = s - 1 if logits_at is None else logits_at
    x = _norm(cfg, params.get("final_norm"), x[:, at : at + 1, :])  # row-wise
    lg = L.logits(params.get("head"), params["embed"], x, cfg)
    return lg[:, 0, :], caches


# ---------------------------------------------------------------------------
# Decode as Stream cells (pipelined serving)
# ---------------------------------------------------------------------------
#
# The decode loop is a stream: cells = contiguous layer groups (each
# owning its params as read-only const state and its KV/SSD cache shard
# as mutable state), items = in-flight request microbatches.  The
# flowing item is a fixed-structure dict
#
#     {"x": (Bm, 1, d) hidden state (embed(tok) on entry),
#      "tok", "pos", "active", "uid", "ngen", "budget": (Bm,)}
#
# and `make_decode_emit` closes the loop (final norm -> logits -> sample
# -> re-embed), so the emitted item is the next step's input.  The
# reference's item also carries its microbatch and round step as device
# scalars ("mb", "step"); here both follow from the item's index b in
# the round's stream, known on the host while a cell runs
# (`graph.current_item`): item b < M is microbatch b at step 0, and the
# fed-back item b keeps the microbatch of item b - M one step later, so
# mb = b % M and step = b // M.  A cell then reads its microbatch's cache
# rows as a contiguous view (no gather, no host sync) and installs an
# admission with a host `if` and an in-place copy into the slot's column.
#
# The cache is only ever written in place: attention writes one row per
# sequence and layer (`scatter_decode_rows`), a Mamba block its
# sequences' conv and SSD state, an admission its slot's column; the cell
# returns the state row it was handed, so the cell scan writes nothing
# back and copies nothing (`graph.scan_cells`).


def _split_cells(tree, num_cells: int):
    def split(leaf):
        groups = leaf.shape[0]
        if groups % num_cells != 0:
            raise ValueError(f"{groups} layer groups not divisible by num_cells={num_cells}")
        return leaf.view((num_cells, groups // num_cells) + tuple(leaf.shape[1:]))

    return P.tree_map(split, tree)


def split_decode_cells(params, caches, num_cells: int):
    """Views of params and caches as ``num_cells`` contiguous layer-group
    cells: leaves ``(groups, ...)`` become ``(num_cells, groups /
    num_cells, ...)``, with nothing copied.

    Returns ``(const_state, state)``, the Stream's read-only / mutable
    split: ``{"blocks": ...}`` -- each cell's layer-group params, which
    the engine joins with a round's admission payload
    (``const_state["adm"]``) -- and ``{"cache": ...}``, each cell's
    KV/SSD cache shard, the only thing the cells write.
    """
    return (
        {"blocks": _split_cells(params["blocks"], num_cells)},
        {"cache": _split_cells(caches, num_cells)},
    )


def merge_decode_caches(cell_states) -> PyTree:
    """The batch cache of :func:`split_decode_cells`'s cache shards: a
    view again."""
    return P.tree_map(lambda l: l.view((-1,) + tuple(l.shape[2:])), cell_states["cache"])


def stack_admission_payload(singles, slots, steps, mbs, num_cells: int) -> PyTree:
    """Pack prefilled single-request caches into per-cell admission state.

    ``singles``: A caches from ``init_cache(cfg, 1, max_len)`` after
    prefill (leaves ``(groups, 1, ...)``).  Returns a pytree with leading
    axis ``num_cells``: per cell, the slice of every admission's cache it
    owns (``"cache"``, leaves ``(num_cells, A, groups / num_cells, ...)``
    on the cache's device), and the slot, round step and microbatch each
    admission is installed at (int32 ``(num_cells, A)`` on the host: a
    cell compares them with its item's index without a device read).
    """
    a_ = len(singles)
    meta = {
        name: torch.tensor(v, dtype=torch.int32).expand(num_cells, a_)
        for name, v in (("slot", slots), ("step", steps), ("mb", mbs))
    }
    if not a_:
        return meta

    def cellify(*leaves):
        stacked = torch.stack([leaf[:, 0] for leaf in leaves])  # (A, groups, ...)
        return stacked.unflatten(1, (num_cells, -1)).transpose(0, 1)

    return {"cache": P.tree_map(cellify, *singles), **meta}


def make_decode_cell(
    cfg: ArchConfig,
    *,
    microbatch: int,
    microbatches: int,
    attn_impl: str = "dense",
    kv_chunk: int = 1024,
    kernels: str = "plain",
):
    """One pipeline cell of the decode stream.

    ``cell_fn(const, state, item) -> (state, item')``: ``const`` holds the
    cell's layer-group params (``const["blocks"]``) and, in a round that
    admits requests, the cell's row of :func:`stack_admission_payload`
    (``const["adm"]``); ``state`` holds the cell's cache shard, leaves
    ``(groups a cell, B, ...)``.  For the item of stream index b (the
    section comment says why it is microbatch ``b % microbatches`` at
    round step ``b // microbatches``) the cell first installs the
    admissions planned at that step and microbatch -- the slot's column
    of the shard, copied in place -- then runs its layer groups on the
    microbatch's ``microbatch`` cache rows, a view of the shard.
    ``kernels`` is the resolved mode: ``"cuda"`` reads attention through
    the fused decode-attention kernel.  A cross-attention block reads
    its vision K/V and writes none, as the reference's
    ``scatter_decode_rows`` leaves them.
    """
    plans = block_plans(cfg)

    def cell_fn(const, state, item):
        b = G.current_item()
        mb, step = b % microbatches, b // microbatches
        cache = state["cache"]
        adm = const.get("adm")
        if adm is not None:
            for a in range(adm["slot"].shape[0]):
                if int(adm["step"][a]) == step and int(adm["mb"][a]) == mb:
                    slot = int(adm["slot"][a])
                    for full, new in zip(P.leaves(cache), P.leaves(adm["cache"])):
                        full[:, slot].copy_(new[a])
        lo = mb * microbatch
        rows = P.tree_map(lambda l: l[:, lo : lo + microbatch], cache)
        lengths = item["pos"]
        if lengths.data_ptr() % 16:
            # a row of the round's first items, at an offset the
            # decode-attention kernel does not take: its own copy
            lengths = lengths.clone()
        positions, kv_len = lengths[:, None], (lengths + 1)[:, None]
        x = item["x"]
        for g in range(_num_groups(const)):
            x, _, _ = _apply_group(
                _group(const["blocks"], g), x, cfg, plans,
                positions=positions, group_cache=_group(rows, g),
                cache_pos=lengths, kv_len=kv_len, attn_impl=attn_impl,
                q_chunk=1, kv_chunk=kv_chunk, kernels=kernels,
            )
        return state, {**item, "x": x}

    return cell_fn


def make_decode_emit(
    params,
    cfg: ArchConfig,
    *,
    sample_fn,
    eos_id: int,
    max_len: int,
    kernels: str = "plain",
):
    """The feedback emit closing the decode loop, all on the item's
    device: final norm -> logits (the fused emit kernel under
    ``kernels="cuda"``) -> ``sample_fn(logits, uid, ngen)`` -> re-embed.
    Retirement mirrors the sequential engine: a slot freezes (pos, tok
    and ngen stop) once it has generated its budget, hit EOS, or reached
    the ``max_len`` cache boundary; frozen slots keep flowing but never
    advance, so no cache row at index >= max_len is written."""
    table = params["embed"]["embedding"]

    def emit(item):
        lg = _emit_logits(params, cfg, item["x"], kernels)
        sampled = sample_fn(lg, item["uid"], item["ngen"])
        act = item["active"]
        tok = torch.where(act, sampled, item["tok"])
        pos = torch.where(act, item["pos"] + 1, item["pos"])
        ngen = torch.where(act, item["ngen"] + 1, item["ngen"])
        done = (ngen >= item["budget"]) | (tok == eos_id) | (pos + 1 >= max_len)
        return {
            **item,
            "x": L.embed_lookup(table, tok)[:, None, :],
            "tok": tok,
            "pos": pos,
            "ngen": ngen,
            "active": act & ~done,
        }

    return emit
