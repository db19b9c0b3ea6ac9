"""Production meshes (port of ``repro.launch.mesh``).

Single pod: (data=16, model=16) -- 256 chips.
Multi-pod:  (pod=2, data=16, model=16) -- 512 chips; the ``pod`` axis is
used either for cross-pod data parallelism (gradient all-reduce,
compressed) or as the stream-future pipeline axis.

``make_production_mesh`` returns an :class:`~repro_torch.parallel.
sharding.AbstractMesh`: axis names and sizes, with no devices and no
process group (the reference's 512 host-platform placeholders).  The dry
run lays its abstract inputs out on it.  ``make_mesh`` and
``make_host_mesh`` build a live ``DeviceMesh`` over the process group
the caller has initialised (``torch.distributed.init_process_group``).
"""
from __future__ import annotations

from repro_torch.parallel.sharding import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...], device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the live
    process group (its world size is ``prod(shape)``); ``device_type``
    defaults to ``cuda`` on an NCCL group, else ``cpu``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_host_mesh(axis_name: str = "pod"):
    """Every rank of the process group on one axis (CPU tests / examples)."""
    import torch.distributed as dist

    return make_mesh((dist.get_world_size(),), (axis_name,))
