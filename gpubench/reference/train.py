"""Training steps of the reference: the loss, its gradient, and AdamW
with clipping by the global norm, all in fp32 with fp32 parameters.

The loss is the next-token cross-entropy averaged over the batch's
tokens, plus ``z_loss`` times the mean squared log-partition; the
gradient is summed over blocks of rows so that the fp32 activations fit
beside the parameters and the moments.  AdamW (Loshchilov and Hutter)
decays every parameter, takes the bias-corrected moments, and follows a
cosine schedule from the peak after ``warmup_steps`` to ``min_lr_ratio``
of it at ``total_steps``.
"""
from __future__ import annotations

import math

import torch

from gpubench.reference import model


def lr_at(step: int, opt: dict) -> float:
    warm = step / max(1, opt["warmup_steps"])
    progress = min(max((step - opt["warmup_steps"]) / max(1, opt["total_steps"] - opt["warmup_steps"]),
                       0.0), 1.0)
    decayed = opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (1 + math.cos(math.pi * progress))
    return opt["learning_rate"] * min(warm, decayed)


def run(cfg: dict, params: dict, batches, opt: dict, *, z_loss: float, mm=torch.matmul,
        rows_per_block: int = 1, rows: int | None = None) -> dict:
    """``len(batches)`` steps from ``params`` (fp32 leaves by path; updated
    in place).  ``rows`` keeps only a batch's first rows (a fault).
    Returns each step's loss, the first step's global gradient norm and
    each leaf's clipped gradient norm (as the optimizer takes it), and
    each leaf's change over all the steps."""
    from gpubench.weights import _set  # the tree's paths, shared with the weights

    paths = sorted(params)
    leaves = [params[p] for p in paths]
    start = [t.detach().clone() for t in leaves]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    tree: dict = {}
    for p, t in zip(paths, leaves):
        t.requires_grad_(True)
        _build(tree, p)
        _set(tree, p, t)
    losses, first = [], None
    for step, batch in enumerate(batches, start=1):
        tokens = torch.as_tensor(batch["tokens"][:rows], device=leaves[0].device).long()
        labels = torch.as_tensor(batch["labels"][:rows], device=leaves[0].device).long()
        count = labels.numel()
        ce_sum = 0.0
        for t in leaves:
            t.grad = None
        for r in range(0, tokens.shape[0], rows_per_block):
            h = model.hidden(cfg, tree, tokens[r:r + rows_per_block], mm, recompute=True)
            lg = model.logits(cfg, tree, h, mm)
            lse = torch.logsumexp(lg, dim=-1)
            ce = lse - torch.gather(lg, -1, labels[r:r + rows_per_block, :, None])[..., 0]
            total = (ce.sum() + z_loss * (lse * lse).sum()) / count
            total.backward()
            ce_sum += float(ce.detach().sum())
        losses.append(ce_sum / count)
        with torch.no_grad():
            grads = [t.grad for t in leaves]
            gnorm = float(torch.sqrt(sum(torch.sum(g * g) for g in grads)))
            clip = min(1.0, opt["clip_norm"] / max(gnorm, 1e-9))
            lr = lr_at(step, opt)
            b1, b2 = opt["beta1"], opt["beta2"]
            if first is None:
                first = {"grad_norm": gnorm,
                         "leaf_grad": {p: float(torch.linalg.vector_norm(g)) * clip
                                       for p, g in zip(paths, grads)}}
            for t, g, mi, vi in zip(leaves, grads, m, v):
                g = g * clip
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mi / (1 - b1 ** step)) / (torch.sqrt(vi / (1 - b2 ** step)) + opt["eps"])
                t.sub_(lr * (upd + opt["weight_decay"] * t))
    with torch.no_grad():
        change = {p: float(torch.linalg.vector_norm(t - s)) for p, t, s in zip(paths, leaves, start)}
    return {"losses": losses, **first, "leaf_change": change}


def _build(tree, path):
    node = tree
    for part in path.split("/")[:-1]:
        node = node.setdefault(part, {})
