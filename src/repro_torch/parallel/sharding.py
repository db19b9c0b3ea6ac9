"""Logical-axis sharding rules on ``DeviceMesh`` and ``DTensor``.

PyTorch port of ``repro.parallel.sharding``.  Weights are 2-D sharded
(FSDP over ``data`` x TP over ``model``), ZeRO-3 style: optimizer state
and gradients inherit the same sharding.  The rule sets are the
reference's dicts ``logical axis -> mesh axis (or tuple or None)``,
copied verbatim; per-shape overrides are dict updates, not code.

A spec is :class:`PartitionSpec`, a tuple of ``None``, a mesh axis name
or a tuple of names, one entry per tensor dim (trailing ``None``s
dropped); it compares equal to ``tuple(jax_spec)``.  Where the
reference attaches a ``NamedSharding`` and lets GSPMD propagate it, the
port maps the spec onto DTensor placements (:func:`placements`) and lets
DTensor's sharding propagation choose the collectives, eagerly.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (a live one,
over the process group) or an :class:`AbstractMesh` (axis names and
sizes only: the dry run's production meshes).  The spec functions read
only the names and sizes, so both serve them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import sys
from typing import Any, Mapping

from repro_torch.models.params import ParamSpec, map_tree

PyTree = Any

# Base rules: training / prefill on the production mesh.
TRAIN_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "embed": "data",       # FSDP shard of the d_model dim of weights
    "mlp_in": "data",      # FSDP shard of non-model dims
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "vocab": "model",
    # Untied input-embedding table: FSDP the rows over `data`; the input
    # gather then costs one transient table replication (SPMD last-resort
    # replicate-then-gather — compiles everywhere; an embed-dim-sharded
    # table instead trips the CPU partitioner on the gather+reshard).
    # Baseline inefficiency, attacked in §Perf.
    "vocab_table": "data",
    "embed_table": None,
    "experts": "model",    # expert parallelism folded onto the TP axis
    "layers": None,
    "stage": "pod",        # pipeline stages (stream-future mode)
    "seq": None,
    "act_seq": "model",    # sequence-parallel activations between blocks
    "kv_seq": None,
    "conv": None,
    "state": None,
    "groups": None,
}

# Decode: KV cache sequence dim sharded over the TP axis (flash-decoding
# style split-K combine is left to GSPMD's partial softmax reductions).
# kv_heads must then stay unsharded — one mesh axis per spec position.
DECODE_RULES = dict(TRAIN_RULES, kv_seq="model", kv_heads=None, act_seq=None)

# Prefill: cache written across the whole sequence; shard it like decode.
PREFILL_RULES = dict(TRAIN_RULES, kv_seq="model", kv_heads=None)

# Long-context decode with global_batch=1: batch axes would idle, so the
# KV/state sequence shards over every axis (512k / 512 = 1k per chip).
LONG_DECODE_RULES = dict(
    DECODE_RULES, batch=None, kv_seq=("pod", "data", "model")
)


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names (major to minor).  A plain tuple underneath, so
    it compares equal to ``tuple(jax.sharding.PartitionSpec(...))``; a
    leaf of a pytree, as in ``jax.tree``."""

    pytree_leaf = True

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"



@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no devices and no process group: the
    counterpart of the reference's mesh over host-platform placeholders.
    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh.
    shape`` does."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of an :class:`AbstractMesh`, a ``DeviceMesh``
    or any object with ``axis_names`` and a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # DeviceMesh: shape is a tuple, names a tuple
        return dict(zip(names, mesh.shape))
    shape = mesh.shape
    return {a: int(shape[a]) for a in mesh.axis_names}


def _axes_of(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def _part(axes: tuple[str, ...]):
    return None if not axes else (axes[0] if len(axes) == 1 else axes)


def _trim(parts: list) -> PartitionSpec:
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def spec_for(logical_axes: tuple[str | None, ...], rules: Mapping[str, Any]) -> PartitionSpec:
    parts = []
    for ax in logical_axes:
        if ax is None:
            parts.append(None)
        else:
            if ax not in rules:
                raise KeyError(f"no sharding rule for logical axis {ax!r}")
            parts.append(rules[ax])
    return _trim(parts)


def prune_spec(spec: PartitionSpec, mesh) -> PartitionSpec:
    """Remove mesh axes that don't exist in ``mesh`` (single-pod has no 'pod')."""
    names = mesh_axes(mesh)
    parts = [_part(tuple(a for a in _axes_of(part) if a in names)) for part in spec]
    return _trim(parts)


def fit_spec(spec: PartitionSpec, shape: tuple[int, ...], mesh) -> PartitionSpec:
    """Make a spec legal for ``shape`` on ``mesh``.

    * drops mesh axes whose product does not evenly divide the dim
      (e.g. 20 q-heads or a 50280-row tied vocab on model=16 — the dim
      stays replicated), and
    * de-duplicates mesh axes across positions (first occurrence wins).
    """
    spec = prune_spec(spec, mesh)
    sizes = mesh_axes(mesh)
    used: set[str] = set()
    parts = []
    for d, part in enumerate(list(spec) + [None] * (len(shape) - len(spec))):
        axes = tuple(a for a in _axes_of(part) if a not in used)
        # drop axes from the right until the product divides the dim
        while axes and shape[d] % math.prod(sizes[a] for a in axes) != 0:
            axes = axes[:-1]
        used.update(axes)
        parts.append(_part(axes))
    return _trim(parts)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements for ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where that mesh axis shards tensor dim ``d``, else
    ``Replicate()``.

    A dim sharded over a tuple of axes is split major to minor in the
    tuple's order, as JAX splits it; DTensor splits a dim that several
    mesh dims shard in mesh-dim order, so the tuple's axes must come in
    the mesh's order (every rule set's tuples do) and any other order
    raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for d, part in enumerate(prune_spec(spec, mesh)):
        axes = _axes_of(part)
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(
                f"spec {spec} splits dim {d} over {axes}, not in the mesh's "
                f"axis order {tuple(names)}"
            )
        for a in axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)


def _fitted(s: ParamSpec, rules, mesh) -> PartitionSpec:
    return fit_spec(spec_for(s.logical_axes, rules), s.shape, mesh)


def param_pspecs(layout: PyTree, rules: Mapping[str, Any], mesh) -> PyTree:
    return map_tree(lambda s: _fitted(s, rules, mesh), layout)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and the placements of one leaf on it (with the spec they
    come from): the counterpart of ``jax.sharding.NamedSharding``.  It
    unpacks as the pair ``(mesh, placements)`` that ``distribute_tensor``
    takes, and is one leaf of a pytree."""

    mesh: Any
    placements: tuple
    spec: PartitionSpec

    def __iter__(self):
        return iter((self.mesh, self.placements))


def param_shardings(layout: PyTree, rules: Mapping[str, Any], mesh) -> PyTree:
    """A :class:`NamedSharding` -- ``(mesh, placements)`` -- per leaf."""
    def one(s: ParamSpec) -> NamedSharding:
        spec = _fitted(s, rules, mesh)
        return NamedSharding(mesh, placements(spec, mesh), spec)

    return map_tree(one, layout)


# The mesh ``maybe_constrain`` shards onto, set by :func:`set_mesh`.  The
# model's hooks read it first, so that without a mesh a hook costs one
# global read.
ACTIVE_MESH = None


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the one the model's sharding
    hooks constrain onto, for the ``with`` block (the reference's
    ``compat.set_mesh``).  An :class:`AbstractMesh` redistributes
    nothing; the MoE dispatch still blocks by its data shards, as the
    reference's does under an abstract mesh."""
    global ACTIVE_MESH
    prev, ACTIVE_MESH = ACTIVE_MESH, mesh
    try:
        yield mesh
    finally:
        ACTIVE_MESH = prev


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor under a mesh set by :func:`set_mesh`
    (never, without one: one global read)."""
    return ACTIVE_MESH is not None and is_dtensor(x)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor; imports nothing of ``torch.distributed``
    that is not loaded yet (no DTensor can exist before it is)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def distribute(x, mesh, placements_):
    """``distribute_tensor`` of a tensor every rank holds whole: each rank
    keeps its own shard of its copy, with no communication."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, mesh, list(placements_), src_data_rank=None)


def replicate_plain_tensors():
    """Under a mesh, a context in which a plain tensor that meets a
    DTensor counts as replicated over the mesh (DTensor's
    ``implicit_replication``); without one, a context that does
    nothing."""
    if ACTIVE_MESH is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def local_shard(x, spec: PartitionSpec, partial_grad_over: tuple[str, ...] = ()):
    """This rank's shard of the DTensor ``x`` laid out as ``spec`` on the
    mesh set (a redistribute, then ``to_local``), for work done on the
    local shard that DTensor cannot do, or not in this layout.  Where the
    rank's local result varies over mesh axes ``x`` is replicated on (a
    weight that meets each data rank's own tokens), name them in
    ``partial_grad_over``: the gradient that comes back is then summed
    over them."""
    from torch.distributed.tensor import Partial

    mesh = ACTIVE_MESH
    pl = placements(spec, mesh)
    names = list(mesh_axes(mesh))
    grad = [Partial() if names[i] in partial_grad_over else p for i, p in enumerate(pl)]
    return x.redistribute(mesh, pl).to_local(grad_placements=grad)


def from_local(local, spec: PartitionSpec):
    """The DTensor on the mesh set whose shard on this rank is ``local``,
    laid out as ``spec`` (even shards: its global shape is the local one
    times the shards of each dim)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, ACTIVE_MESH, placements(spec, ACTIVE_MESH),
                              run_check=False)


def on_shards(fn, x, *args):
    """``fn(shard, *args)`` on each rank's shard of the DTensor ``x``, the
    result laid out as ``x`` is: for an op that acts only along dims ``x``
    is not sharded on (a cumulative sum along an unsharded dim), where
    DTensor lacks a strategy for it or its backward."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(fn(x.to_local(), *args), x.device_mesh, x.placements,
                              run_check=False)


def maybe_constrain(x, spec: PartitionSpec):
    """``with_sharding_constraint``, a no-op when no mesh is set.

    Returns ``x`` itself unless a mesh is set by :func:`set_mesh` and
    ``x`` is a DTensor; then ``x`` is redistributed to ``spec``'s
    placements, fitted to ``x``'s shape (axes the mesh lacks pruned, and
    axes whose sizes do not divide a dim dropped: GSPMD pads an uneven
    shard, DTensor's views refuse one).  ``REPRO_NO_CONSTRAIN=1`` turns
    every constraint off, as in the reference.

    The reference also drops the manual axes of a partial-manual
    ``shard_map`` region (its stream-future pipeline).  The port's
    pipeline across ranks sets the stage's sub-mesh, which lacks the
    pipeline axis, as the mesh (``launch.pipeline_demo``), so the
    pruning above drops it the same way.
    """
    mesh = ACTIVE_MESH
    if mesh is None:
        return x
    if os.environ.get("REPRO_NO_CONSTRAIN") == "1":
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    # a redistribute even to the placements x has: its backward pins the
    # gradient too, as the reference's constraint binds the cotangent
    return x.redistribute(mesh, placements(fit_spec(spec, tuple(x.shape), mesh), mesh))


def shard_activation(x, logical_axes, rules, mesh=None):
    """``maybe_constrain`` by logical axes; with ``mesh`` given, onto that
    mesh whether or not one is set."""
    spec = spec_for(logical_axes, rules)
    if mesh is not None:
        with set_mesh(mesh):
            return maybe_constrain(x, prune_spec(spec, mesh))
    return maybe_constrain(x, spec)
