"""AdamW with dtype-configurable moments and global-norm clipping.

Port of ``repro.train.optimizer``, written as the reference writes its
update: the global norm of the gradients clips them, each leaf's update
runs in fp32, and the parameters and moments are cast back to their
storage dtypes.  ``torch.optim.AdamW`` is not this update: it has no
global clip, applies the decay as ``p * (1 - lr * wd)`` before the step
and rounds bf16 storage elsewhere.  Moments are stored in a configurable
dtype (bf16 for the largest configs), with fp32 math at update time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import pytree as P
from repro_torch.roofline import trace as TR

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32  # bf16 for >=100B configs
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def _step_device(params: PyTree) -> torch.device:
    first = next((t for t in P.leaves(params) if isinstance(t, torch.Tensor)), None)
    return torch.device("cpu") if first is None else first.device


def init_opt_state(params: PyTree, cfg: AdamWConfig) -> PyTree:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter, and
    the step count (an int32 scalar on the parameters' device).  A
    DTensor parameter gets DTensor moments with its placements."""
    zeros = lambda p: torch.zeros_like(p, dtype=cfg.moment_dtype)
    return {
        "m": P.tree_map(zeros, params),
        "v": P.tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=_step_device(params)),
    }


def abstract_opt_state(abstract_params: PyTree, cfg: AdamWConfig) -> PyTree:
    """:func:`init_opt_state`'s shapes and dtypes as meta tensors (the
    template a checkpoint restores into)."""
    meta = lambda p: torch.empty(p.shape, dtype=cfg.moment_dtype, device="meta")
    return {
        "m": P.tree_map(meta, abstract_params),
        "v": P.tree_map(meta, abstract_params),
        "step": torch.empty((), dtype=torch.int32, device="meta"),
    }


def lr_schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in fp32 on the
    step's device (no host sync)."""
    step = step.to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    progress = torch.clamp(
        (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps),
        0.0,
        1.0,
    )
    cos = 0.5 * (1 + torch.cos(math.pi * progress))
    decayed = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * torch.minimum(warm, decayed)


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(
        sum(torch.sum(torch.square(x.to(torch.float32))) for x in P.leaves(tree))
    )


def adamw_update(
    params: PyTree, grads: PyTree, opt_state: PyTree, cfg: AdamWConfig
) -> tuple[PyTree, PyTree, dict]:
    """One update; fp32 math, params/moments cast back to storage dtypes.
    Functional: returns new trees and leaves the given ones as they were.
    Under ``torch.profiler`` it runs in a span ``train.optimizer``."""
    with TR.span(TR.TRAIN_OPTIMIZER):
        return _adamw_update(params, grads, opt_state, cfg)


def _adamw_update(params, grads, opt_state, cfg: AdamWConfig):
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_schedule(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)

    def update_one(p, g, m, v):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        update = update + cfg.weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * update
        return new_p.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    with torch.no_grad():
        flat_p, treedef = P.flatten(params)
        out = [
            update_one(p, g, m, v)
            for p, g, m, v in zip(
                flat_p, P.leaves(grads), P.leaves(opt_state["m"]), P.leaves(opt_state["v"])
            )
        ]
    new_params = P.unflatten(treedef, [o[0] for o in out])
    new_state = {
        "m": P.unflatten(treedef, [o[1] for o in out]),
        "v": P.unflatten(treedef, [o[2] for o in out]),
        "step": step,
    }
    metrics = {"grad_norm": gnorm, "learning_rate": lr}
    return new_params, new_state, metrics
