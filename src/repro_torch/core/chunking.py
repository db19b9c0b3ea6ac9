"""Chunking of a stream axis (PyTorch): the reshapes the paper's
algorithms use to cut a stream into items.

The port of ``chunk_axis`` / ``unchunk_axis`` of ``repro.core.chunking``;
the closed-form model of the pipeline schedules there is not ported yet.
"""
from __future__ import annotations

from repro_torch import pytree as P


def chunk_axis(tree, num_chunks: int, axis: int = 0):
    """Reshape leading `axis` of every leaf into (num_chunks, chunk, ...)."""

    def _chunk(x):
        if x.shape[axis] % num_chunks != 0:
            raise ValueError(
                f"axis {axis} of shape {tuple(x.shape)} not divisible by {num_chunks}"
            )
        new_shape = (
            tuple(x.shape[:axis])
            + (num_chunks, x.shape[axis] // num_chunks)
            + tuple(x.shape[axis + 1 :])
        )
        x = x.reshape(new_shape)
        if axis != 0:
            x = x.movedim(axis, 0)
        return x

    return P.tree_map(_chunk, tree)


def unchunk_axis(tree, axis: int = 0):
    """Inverse of :func:`chunk_axis`."""

    def _unchunk(x):
        if axis != 0:
            x = x.movedim(0, axis)
        new_shape = tuple(x.shape[:axis]) + (-1,) + tuple(x.shape[axis + 2 :])
        return x.reshape(new_shape)

    return P.tree_map(_unchunk, tree)
