"""Matrix products for the reference: exact fp32, or emulated fp8.

``fp32`` turns TF32 off, so a float32 product is a float32 product on
the card.  ``fp8`` is the control's precision, the one below the bf16
that the configurations state: each operand of a product is rounded to
float8 e4m3 under one scale per tensor (its absolute maximum at 448),
the gradient flowing into a product to e5m2 (at 57344), and the product
accumulates in fp32, as an fp8 tensor-core product does.
"""
from __future__ import annotations

import torch


def exact_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _q(x: torch.Tensor, fmt, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / top
    return (x / scale).to(fmt).to(torch.float32) * scale


def q8(x):
    return _q(x, torch.float8_e4m3fn, 448.0)


def q8_grad(x):
    return _q(x, torch.float8_e5m2, 57344.0)


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = q8(a), q8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = q8_grad(g)
        ga = qg @ qb.mT
        if qb.dim() == 2:
            gb = qa.reshape(-1, qa.shape[-1]).mT @ qg.reshape(-1, qg.shape[-1])
        else:
            gb = qa.mT @ qg
        return ga, gb


def fp8_matmul(a, b):
    return _Fp8MatMul.apply(a, b)


MATMULS = {"fp32": torch.matmul, "fp8": fp8_matmul}
