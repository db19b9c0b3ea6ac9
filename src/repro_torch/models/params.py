"""Declarative parameter layouts (PyTorch port of ``repro.models.params``).

A model declares its parameters as a nested dict of :class:`ParamSpec`
(shape + logical axis names + init).  ``init_params`` draws real
parameters from one seeded ``torch.Generator``; ``params_from_numpy``
takes the JAX package's parameter tree (as numpy arrays) instead, so the
port and the reference run on identical weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device

PyTree = Any

# numpy dtype names of the JAX package's leaves -> torch dtypes.  Read by
# name so a bf16 leaf needs no ``ml_dtypes`` import.
_TORCH_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical_axes: tuple[str | None, ...]
    dtype: Any = torch.bfloat16
    init: str = "fan_in"  # fan_in | normal | zeros | ones | embed
    init_scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(
                f"shape {self.shape} vs logical_axes {self.logical_axes}"
            )


def map_tree(fn, tree: PyTree) -> PyTree:
    """Apply ``fn`` to every leaf of a nested dict, keys in sorted order
    (the order ``jax.tree`` flattens a dict in)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def _init_scale(spec: ParamSpec) -> float:
    if spec.init == "embed":
        return spec.init_scale
    if spec.init == "fan_in":
        # For stacked layers (leading 'layers'/'stage' axis) fan-in excludes it.
        non_stack = [
            d
            for d, ax in zip(spec.shape, spec.logical_axes)
            if ax not in ("layers", "stage", "experts")
        ]
        fan_in = max(1, int(np.prod(non_stack[:-1]))) if len(non_stack) > 1 else 1
        return spec.init_scale / np.sqrt(fan_in)
    return spec.init_scale  # normal


# Elements of the largest fp32 draw: a leaf above it is drawn one slice
# of its leading axis at a time (an expert stack of a full-width MoE
# model, 8.9e9 elements, would otherwise need a 35 GB fp32 temporary).
DRAW_LIMIT = 1 << 30


def _randn(shape, gen, scale, dtype, device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * scale
    return x.to(dtype)


def _fill_randn(out: torch.Tensor, gen, scale) -> None:
    """Fill ``out`` slice by slice of its leading axis, each slice drawn
    as one leaf of at most :data:`DRAW_LIMIT` elements (or sliced again)."""
    for part in out:
        if part.numel() > DRAW_LIMIT:
            _fill_randn(part, gen, scale)
        else:
            part.copy_(_randn(part.shape, gen, scale, out.dtype, out.device))


def init_params(
    layout: PyTree, seed: int = 0, device: str | torch.device = "cuda"
) -> PyTree:
    """Random parameters for ``layout``, drawn leaf by leaf (sorted keys)
    from one ``torch.Generator`` seeded with ``seed`` on ``device``.

    Same shapes, dtypes and fan-in scales as the JAX package's
    ``init_params``; the numbers differ (another generator).  Use
    :func:`params_from_numpy` for weights identical to the reference's.
    A leaf of more than :data:`DRAW_LIMIT` elements is drawn into its
    result one slice of its leading axis at a time, so that no fp32
    temporary is larger than a slice.
    """
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def one(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        scale = _init_scale(spec)
        if int(np.prod(spec.shape)) <= DRAW_LIMIT:
            return _randn(spec.shape, gen, scale, spec.dtype, device)
        out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
        _fill_randn(out, gen, scale)
        return out

    return map_tree(one, layout)


def param_count(layout: PyTree) -> int:
    """The number of parameters a layout of :class:`ParamSpec` declares."""
    if isinstance(layout, dict):
        return sum(param_count(v) for v in layout.values())
    return int(np.prod(layout.shape))


def abstract_params(layout: PyTree) -> PyTree:
    """Stand-ins for ``layout``'s parameters: meta-device tensors of its
    shapes and dtypes (no allocation), the counterpart of the
    reference's ``jax.ShapeDtypeStruct`` tree."""
    return map_tree(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), layout
    )


def cast_layout(layout: PyTree, dtype) -> PyTree:
    """``layout`` with every :class:`ParamSpec`'s dtype set to ``dtype``."""
    return map_tree(lambda s: dataclasses.replace(s, dtype=dtype), layout)


def params_from_numpy(tree: PyTree, device: str | torch.device = "cuda") -> PyTree:
    """The weight bridge: a parameter tree of numpy arrays -> tensors.

    ``tree`` is the JAX package's ``init_params`` output with each leaf
    turned into a numpy array.  Each leaf is upcast with
    ``.astype(np.float32)`` (which works on bf16 arrays without
    importing ``ml_dtypes``) and cast back to its own dtype on
    ``device``; bf16 -> fp32 -> bf16 is lossless, so the converted
    weights are bit-identical to the reference's.
    """
    device = resolve_device(device)

    def one(leaf) -> torch.Tensor:
        name = str(leaf.dtype)
        if name not in _TORCH_DTYPES:
            raise TypeError(f"unsupported parameter dtype {name}")
        t = torch.from_numpy(np.ascontiguousarray(leaf.astype(np.float32)))
        return t.to(device=device, dtype=_TORCH_DTYPES[name])

    return map_tree(one, tree)

