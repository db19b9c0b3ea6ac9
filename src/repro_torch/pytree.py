"""Nested containers of tensors ("pytrees"), flattened in JAX's order.

The port's one pytree helper.  Containers are ``None`` (no leaves),
tuples (named ones too), lists, dicts and the dataclasses registered
with :func:`register_dataclass`; anything else is a leaf, and so is a
tuple whose class sets ``pytree_leaf = True`` (``parallel.sharding.
PartitionSpec``, which ``jax.tree`` keeps whole too).  Dicts flatten
in sorted-key order and rebuild with their keys sorted, as ``jax.tree``
does, so that leaf order -- which ``leading_axis_size``, structure
checks and zipped ``tree_map`` calls observe -- is the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

PyTree = Any

_DATACLASSES: dict[type, tuple[str, ...]] = {}


def register_dataclass(cls: type) -> type:
    """Register a dataclass as a container of its fields (a class
    decorator, like ``jax.tree_util.register_dataclass``)."""
    _DATACLASSES[cls] = tuple(f.name for f in dataclasses.fields(cls))
    return cls


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """The structure of a pytree: its containers with the leaves cut out."""

    kind: Any  # None for a leaf, else the container type
    aux: Any  # dict keys, dataclass fields or tuple type
    children: tuple["TreeDef", ...]

    def __repr__(self) -> str:
        if self.kind is None:
            return "*"
        if self.kind is dict:
            body = ", ".join(f"{k!r}: {c!r}" for k, c in zip(self.aux, self.children))
            return "{" + body + "}"
        if self.kind is type(None):
            return "None"
        inner = ", ".join(repr(c) for c in self.children)
        if self.kind is list:
            return f"[{inner}]"
        if self.kind is tuple:
            return f"({inner}{',' if len(self.children) == 1 else ''})"
        return f"{self.kind.__name__}({inner})"


_LEAF = TreeDef(None, None, ())


def _children(tree) -> tuple[Any, Any, tuple]:
    """(kind, aux, children) of a container, or None for a leaf."""
    if tree is None:
        return type(None), None, ()
    t = type(tree)
    if t is dict:
        keys = tuple(sorted(tree))
        return dict, keys, tuple(tree[k] for k in keys)
    if t is list:
        return list, None, tuple(tree)
    if isinstance(tree, tuple) and not getattr(t, "pytree_leaf", False):
        return tuple if t is tuple else t, t, tuple(tree)
    if t in _DATACLASSES:
        fields = _DATACLASSES[t]
        return t, fields, tuple(getattr(tree, f) for f in fields)
    return None


# The walkers below are module-level functions that take their
# accumulators as arguments: a nested function that calls itself sits in
# a reference cycle (function -> closure cell -> function), and any list
# of leaves it closed over would stay alive, tensors and all, until the
# cyclic garbage collector ran.


def _walk(node, leaves: list) -> TreeDef:
    parts = _children(node)
    if parts is None:
        leaves.append(node)
        return _LEAF
    kind, aux, kids = parts
    return TreeDef(kind, aux, tuple(_walk(k, leaves) for k in kids))


def flatten(tree: PyTree) -> tuple[list, TreeDef]:
    leaves: list = []
    return leaves, _walk(tree, leaves)


def _build(td: TreeDef, it):
    if td.kind is None:
        return next(it)
    kids = [_build(c, it) for c in td.children]
    if td.kind is type(None):
        return None
    if td.kind is dict:
        return dict(zip(td.aux, kids))
    if td.kind is list:
        return kids
    if td.kind is tuple:
        return tuple(kids)
    if td.kind in _DATACLASSES:
        return td.kind(**dict(zip(td.aux, kids)))
    return td.kind(*kids)  # a named tuple


def unflatten(treedef: TreeDef, leaves) -> PyTree:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("too many leaves for the tree structure")
    return out


def _walk_paths(node, path: str, out: list) -> None:
    parts = _children(node)
    if parts is None:
        out.append((path, node))
        return
    kind, aux, kids = parts
    if kind is dict:
        names = [f"[{k!r}]" for k in aux]
    elif kind in _DATACLASSES:
        names = [f".{f}" for f in aux]
    elif isinstance(aux, type) and hasattr(aux, "_fields"):  # a named tuple
        names = [f".{f}" for f in aux._fields]
    else:
        names = [f"[{i}]" for i in range(len(kids))]
    for name, kid in zip(names, kids):
        _walk_paths(kid, path + name, out)


def flatten_with_paths(tree: PyTree) -> list[tuple[str, Any]]:
    """``(path, leaf)`` for every leaf, in flattening order; ``path`` is
    what ``jax.tree_util.keystr`` prints for it (``['params']['w']``,
    ``[0]``, ``.field``), so a file keyed by paths is keyed alike by
    both packages."""
    out: list[tuple[str, Any]] = []
    _walk_paths(tree, "", out)
    return out


def leaves(tree: PyTree) -> list:
    return flatten(tree)[0]


def structure(tree: PyTree) -> TreeDef:
    return flatten(tree)[1]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and of ``rest`` (which must share
    its structure), rebuilt in ``tree``'s structure."""
    flat, td = flatten(tree)
    others = []
    for r in rest:
        rl, rtd = flatten(r)
        if rtd != td:
            raise ValueError(f"tree_map: structures differ, {td!r} vs {rtd!r}")
        others.append(rl)
    return unflatten(td, [fn(*xs) for xs in zip(flat, *others)])
