"""Abstract, sharded input specs per (arch x shape) cell (port of
``repro.launch.specs``).

Everything the dry run lays out is declared here: abstract params,
optimizer state, batches, caches -- each leaf a :class:`ShardedStruct`,
a ``meta`` tensor (shape and dtype, no allocation) paired with its spec
and mesh, so that it reports its shard's shape and bytes per chip: the
counterpart of a ``jax.ShapeDtypeStruct`` with a ``NamedSharding``.
Logical axes resolve to specs through the rule sets of
:mod:`repro_torch.parallel.sharding`.

Modality frontends are stubs, as in the reference: the VLM's
``vision_embeds`` and the audio model's frame ``embeds`` arrive as
precomputed embeddings.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import transformer as T
from repro_torch.models.params import abstract_params
from repro_torch.parallel import sharding as SH
from repro_torch.train import optimizer as O

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ShardedStruct:
    """A ``meta`` tensor laid out by ``spec`` on ``mesh``."""

    value: torch.Tensor
    spec: SH.PartitionSpec
    mesh: Any

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.value.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.value.dtype

    @property
    def local_shape(self) -> tuple[int, ...]:
        """One chip's shard (a dim that does not split evenly rounds up,
        as a padded shard does)."""
        sizes = SH.mesh_axes(self.mesh)
        out = list(self.shape)
        for d, part in enumerate(self.spec):
            axes = () if part is None else (part if isinstance(part, tuple) else (part,))
            out[d] = -(-out[d] // math.prod(sizes[a] for a in axes))
        return tuple(out)

    @property
    def local_bytes(self) -> int:
        return math.prod(self.local_shape) * self.dtype.itemsize


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ArchConfig, shape: ShapeCell) -> tuple[PyTree, PyTree]:
    """(meta tensors, logical-axes tree) for one training batch."""
    b, s = shape.global_batch, shape.seq_len
    structs: dict[str, Any] = {}
    axes: dict[str, Any] = {}
    if cfg.embeds_input:
        structs["embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
        axes["embeds"] = ("batch", "seq", None)
    else:
        structs["tokens"] = _meta((b, s), torch.int32)
        axes["tokens"] = ("batch", "seq")
    structs["labels"] = _meta((b, s), torch.int32)
    axes["labels"] = ("batch", "seq")
    if cfg.vision_tokens:
        structs["vision_embeds"] = _meta((b, cfg.vision_tokens, cfg.d_model), torch.bfloat16)
        axes["vision_embeds"] = ("batch", None, None)
    return structs, axes


def sharded(structs: PyTree, axes: PyTree, rules, mesh) -> PyTree:
    """Attach fitted specs to meta tensors by logical axes (``axes``
    mirrors ``structs``' dicts, a tuple of logical axes per leaf)."""
    if isinstance(structs, dict):
        return {k: sharded(structs[k], axes[k], rules, mesh) for k in sorted(structs)}
    spec = SH.fit_spec(SH.spec_for(axes, rules), tuple(structs.shape), mesh)
    return ShardedStruct(structs, spec, mesh)


def abstract_model_state(cfg: ArchConfig, ocfg: O.AdamWConfig, rules, mesh):
    """(abstract params, abstract opt state) with specs attached: the
    moments share the params' specs, the step is replicated."""
    layout = T.model_layout(cfg)
    pspecs = SH.param_pspecs(layout, rules, mesh)
    a_params = abstract_params(layout)

    def attach(tree, specs):
        if isinstance(tree, dict):
            return {k: attach(tree[k], specs[k]) for k in sorted(tree)}
        return ShardedStruct(tree, specs, mesh)

    a_opt = O.abstract_opt_state(a_params, ocfg)
    return attach(a_params, pspecs), {
        "m": attach(a_opt["m"], pspecs),
        "v": attach(a_opt["v"], pspecs),
        "step": ShardedStruct(a_opt["step"], SH.PartitionSpec(), mesh),
    }


def abstract_cache(cfg: ArchConfig, shape: ShapeCell, rules, mesh):
    caches = T.cache_layout(cfg, shape.global_batch, shape.seq_len)
    return sharded(caches, T.cache_logical_axes(cfg), rules, mesh)


def decode_inputs(cfg: ArchConfig, shape: ShapeCell, rules, mesh):
    b = shape.global_batch
    batch_spec = SH.prune_spec(SH.spec_for(("batch",), rules), mesh)
    structs = {"lengths": ShardedStruct(_meta((b,), torch.int32), batch_spec, mesh)}
    if cfg.embeds_input:
        spec = SH.prune_spec(SH.spec_for(("batch", None, None), rules), mesh)
        structs["embeds"] = ShardedStruct(_meta((b, 1, cfg.d_model), torch.bfloat16), spec, mesh)
    else:
        structs["tokens"] = ShardedStruct(_meta((b,), torch.int32), batch_spec, mesh)
    return structs


def prefill_inputs(cfg: ArchConfig, shape: ShapeCell, rules, mesh):
    b, s = shape.global_batch, shape.seq_len
    structs: dict[str, Any] = {}
    axes: dict[str, Any] = {}
    if cfg.embeds_input:
        structs["embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
        axes["embeds"] = ("batch", "seq", None)
    else:
        structs["tokens"] = _meta((b, s), torch.int32)
        axes["tokens"] = ("batch", "seq")
    if cfg.vision_tokens:
        structs["vision_embeds"] = _meta((b, cfg.vision_tokens, cfg.d_model), torch.bfloat16)
        axes["vision_embeds"] = ("batch", None, None)
    return sharded(structs, axes, rules, mesh)


def local_bytes(tree: PyTree) -> int:
    """Bytes per chip of every :class:`ShardedStruct` in ``tree``."""
    total = 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            total += node.local_bytes
    return total
