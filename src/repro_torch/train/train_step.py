"""Training step: loss, microbatch gradient accumulation, optimizer update.

Port of ``repro.train.train_step``.  The microbatch axis is a bounded
stream (the paper's chunking knob): plain accumulation evaluates it
Lazily (a sequential scan, constant memory); under the pipeline config
the same microbatches flow through layer stages under Future with a
pluggable schedule (:mod:`repro_torch.core.pipeline`).

Training runs the plain PyTorch ops, as the reference trains on XLA's:
neither package's kernels have a backward.  ``kernels="cuda"`` is
refused up front, ``"auto"`` resolves to ``"plain"`` on every device,
and the forward is always passed ``kernels="plain"`` (never None, which
would inherit ``cfg.kernels``); the kernel guard
(:func:`repro_torch.kernels.no_backward`) stops any other route.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import pytree as P
from repro_torch.configs.base import ArchConfig
from repro_torch.core import graph as G
from repro_torch.core.chunking import chunk_axis
from repro_torch.kernels import KERNEL_MODES
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH
from repro_torch.roofline import trace as TR
from repro_torch.train import optimizer as O

PyTree = Any

_METRICS = ("loss", "z_loss", "moe_lb_loss", "moe_z_loss", "moe_drop_fraction")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's fields, less ``unroll`` (an XLA scan knob with no
    counterpart in eager PyTorch)."""

    num_microbatches: int = 1
    accum_dtype: torch.dtype = torch.float32  # bf16 for >=100B configs
    remat: bool = True
    attn_impl: str = "chunked"
    q_chunk: int = 512
    kv_chunk: int = 1024
    causal_skip: bool | None = None
    z_loss_coef: float = 1e-4
    moe_lb_coef: float = 1e-2
    moe_z_coef: float = 1e-3
    # Layer-pipeline mode: the tick schedule the FutureEvaluator runs
    # and, for "interleaved", how many non-contiguous stage groups each
    # stage owns.
    pipeline_schedule: str = "gpipe"
    pipeline_interleave: int = 1
    # "autodiff" (autograd differentiates the forward plan) or "planned"
    # (the combined plan's B units as scheduled work; bitwise-equal
    # gradients).
    pipeline_backward: str = "autodiff"
    # Kernel dispatch (repro_torch.kernels): training takes "plain";
    # "cuda" is refused (the kernels have no backward) and "auto"
    # resolves to "plain".
    kernels: str = "plain"

    def pipeline_config(self, num_stages: int, axis_name: str = "pod"):
        """The PipelineConfig this training config implies for a stage count."""
        from repro_torch.core.pipeline import PipelineConfig

        return PipelineConfig(
            num_stages=num_stages,
            num_microbatches=self.num_microbatches,
            axis_name=axis_name,
            remat=self.remat,
            schedule=self.pipeline_schedule,
            interleave=self.pipeline_interleave,
            backward=self.pipeline_backward,
        )


def lm_loss(params, cfg: ArchConfig, batch: PyTree, tcfg: TrainConfig):
    """Next-token CE (fp32 logits, logsumexp form) + z-loss + MoE aux.
    Returns ``(total, metrics)``."""
    kw = {}
    if cfg.embeds_input:
        kw["embeds"] = batch["embeds"]
    else:
        kw["tokens"] = batch["tokens"]
    if cfg.vision_tokens:
        kw["vision_embeds"] = batch["vision_embeds"]
    logits, _, aux = T.forward(
        params, cfg,
        attn_impl=tcfg.attn_impl, q_chunk=tcfg.q_chunk, kv_chunk=tcfg.kv_chunk,
        causal_skip=tcfg.causal_skip, remat=tcfg.remat, kernels="plain", **kw,
    )
    labels = batch["labels"].long()  # (B, S)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    lse = torch.logsumexp(logits, dim=-1)  # (B, S)
    if SH.is_sharded(logits):
        # the reference's masked sum: it stays shard-local on vocab-sharded
        # logits (DTensor's gather there leaves a partial that the next op
        # cannot reduce)
        vocab_iota = torch.arange(logits.shape[-1], device=labels.device)
        gold = torch.sum(torch.where(vocab_iota == labels[..., None], logits, 0.0), dim=-1)
    else:
        # a gather is exact (the reference's masked sum adds zeros to it)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    ce = (lse - gold) * mask
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(ce) / denom
    z_loss = torch.sum(torch.square(lse) * mask) / denom
    total = loss + tcfg.z_loss_coef * z_loss
    if cfg.moe is not None:
        total = (
            total
            + tcfg.moe_lb_coef * aux["moe_lb_loss"]
            + tcfg.moe_z_coef * aux["moe_z_loss"]
        )
    metrics = {"loss": loss, "z_loss": z_loss, **aux}
    metrics = {
        k: torch.as_tensor(v, dtype=torch.float32, device=labels.device).detach()
        for k, v in metrics.items()
    }
    return total, metrics


def value_and_grad(params, cfg: ArchConfig, batch: PyTree, tcfg: TrainConfig):
    """``((total, metrics), grads)`` of :func:`lm_loss` with respect to
    every parameter leaf (``jax.value_and_grad(lm_loss, has_aux=True)``):
    the leaves are taken as views that require grad, and the gradients
    come in the parameters' dtypes.  Under ``torch.profiler`` the loss
    runs in a span ``train.forward`` and the gradients in
    ``train.backward``."""
    flat, treedef = P.flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        with TR.span(TR.TRAIN_FORWARD):
            total, metrics = lm_loss(P.unflatten(treedef, leaves), cfg, batch, tcfg)
        with TR.span(TR.TRAIN_BACKWARD):
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return (total.detach(), metrics), P.unflatten(treedef, grads)


def _constrain(tree: PyTree, param_pspecs: PyTree | None) -> PyTree:
    if param_pspecs is None:
        return tree
    return P.tree_map(SH.maybe_constrain, tree, param_pspecs)


def accumulate_grads(
    params, cfg: ArchConfig, batch: PyTree, tcfg: TrainConfig,
    param_pspecs: PyTree | None = None,
):
    """Microbatches through a Lazy scan, gradients summed in
    ``accum_dtype`` in microbatch order and scaled by ``1/M`` (the
    reference's ``lax.scan``).  Returns ``(grads, metrics)``.

    With ``param_pspecs`` (the parameters' specs) under a mesh, the
    per-microbatch gradients, the accumulator and its zeros are
    constrained to the parameters' sharding, as in the reference: the
    data-axis reduction of a gradient then lands on its FSDP shard."""
    if tcfg.num_microbatches == 1:
        (_, metrics), grads = value_and_grad(params, cfg, batch, tcfg)
        return _constrain(grads, param_pspecs), metrics

    micro = chunk_axis(batch, tcfg.num_microbatches)

    def step(carry, mb):
        acc, metrics_acc = carry
        (_, metrics), grads = value_and_grad(params, cfg, mb, tcfg)
        grads = _constrain(grads, param_pspecs)
        for a, g in zip(P.leaves(acc), P.leaves(grads)):
            a.add_(g.to(tcfg.accum_dtype))
        acc = _constrain(acc, param_pspecs)
        metrics_acc = {k: metrics_acc[k] + metrics[k] for k in metrics_acc}
        return (acc, metrics_acc), None

    device = P.leaves(params)[0].device
    zeros = _constrain(P.tree_map(
        lambda p: torch.zeros_like(p, dtype=tcfg.accum_dtype), params
    ), param_pspecs)
    metrics0 = {k: torch.zeros((), dtype=torch.float32, device=device) for k in _METRICS}
    (grads, metrics), _ = G.scan(step, (zeros, metrics0), micro)
    inv = 1.0 / tcfg.num_microbatches
    return (
        P.tree_map(lambda g: g * inv, grads),
        {k: m * inv for k, m in metrics.items()},
    )


def resolve_train_kernels(tcfg: TrainConfig) -> str:
    """The ``kernels`` mode training runs: ``"plain"``.  ``"auto"``
    resolves to it on every device (the reference resolves it to XLA);
    ``"cuda"`` raises, with the reference's two messages."""
    if tcfg.kernels not in KERNEL_MODES:
        raise ValueError(f"kernels={tcfg.kernels!r}; expected one of {KERNEL_MODES}")
    if tcfg.kernels == "cuda":
        if tcfg.pipeline_backward == "planned":
            raise ValueError(
                "kernels='cuda' is not supported with pipeline_backward='planned': "
                "the planned backward recomputes forward units under autograd, and "
                "the port's CUDA kernels have no backward.  Use kernels='plain' "
                "(or 'auto', which resolves to plain for training)."
            )
        raise ValueError(
            "kernels='cuda' is not supported for training: the port's CUDA kernels "
            "have no backward (nor have the reference's Pallas kernels), so autograd "
            "cannot differentiate them.  Use kernels='plain' (or 'auto', which "
            "resolves to plain for training); the kernels are a serving-path knob."
        )
    return "plain"


def make_train_step(
    cfg: ArchConfig, tcfg: TrainConfig, ocfg: O.AdamWConfig,
    param_pspecs: PyTree | None = None,
):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; functional, the given trees are left as they
    were.

    Sharded training: the parameters (and moments) are DTensors laid out
    by ``param_shardings``, ``param_pspecs`` their specs, and the step
    runs under ``sharding.set_mesh(mesh)``; plain tensors it meets (the
    batch, positions, masks) count as replicated there.

    Under ``torch.profiler`` a step runs in a span ``train.step``."""
    tcfg = dataclasses.replace(tcfg, kernels=resolve_train_kernels(tcfg))

    def train_step(params, opt_state, batch):
        with TR.span(TR.TRAIN_STEP), SH.replicate_plain_tensors():
            grads, metrics = accumulate_grads(params, cfg, batch, tcfg, param_pspecs)
            params, opt_state, opt_metrics = O.adamw_update(
                params, grads, opt_state, cfg=ocfg
            )
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step
