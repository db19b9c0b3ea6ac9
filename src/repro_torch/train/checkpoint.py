"""Checkpointing with asynchronous (future) writes, in the reference's layout.

Port of ``repro.train.checkpoint``.  Layout:
``<dir>/step_<N>/{manifest.json, arrays_p<P>.npz}``, written atomically
(a ``.tmp<P>`` directory renamed into place), so a crash mid-write never
corrupts the latest checkpoint: a restore picks the newest complete
manifest.  The arrays are keyed by the paths ``jax.tree_util.keystr``
prints (``['params']['blocks']['block0']['attn']['wq']``), and a bf16
leaf is stored as the reference stores it, 2-byte records (numpy's
``|V2``), read back as ``torch.bfloat16`` without ``ml_dtypes``: a
checkpoint the JAX package writes restores here, and one written here
reads in the JAX package.

The device->host copy happens at ``save`` (so the train loop may go on
and replace the state); the file I/O happens on a
:class:`~repro_torch.core.future.HostFuture`, one write in flight
(``wait()`` is the Await.result before the next save and before exit).
The process index is a constructor argument (0): the port has no
multi-host runtime yet, and the layout carries the key so that one will
be the same code.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import struct
import time
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch import pytree as P
from repro_torch import resolve_device
from repro_torch.core.future import HostFuture
from repro_torch.parallel import sharding as SH

PyTree = Any

# The reference's bf16 leaves on disk: ml_dtypes' bfloat16 saves as
# 2-byte void records.
_BF16_RECORD = np.dtype("V2")


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's host copy as the reference writes it (bf16 as ``|V2``);
    a DTensor is gathered whole first (a collective: every rank of its
    mesh calls it), as ``np.asarray`` gathers a sharded ``jax.Array``."""
    if SH.is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_RECORD)
    return t.numpy()


def from_numpy(a: np.ndarray) -> torch.Tensor:
    """The inverse of :func:`to_numpy`; 2-byte records (the reference's
    bf16, or ``ml_dtypes.bfloat16`` itself) come back as bf16."""
    a = np.require(a, requirements="C")  # keeps a 0-d leaf 0-d
    if a.dtype == _BF16_RECORD or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def read_arrays(path: str) -> dict[str, np.ndarray]:
    """The arrays of an ``.npz`` file, read straight from each stored
    member's offset.  ``np.load`` reads a member through ``zipfile``,
    which checks its CRC32 and copies it again: restoring full-width
    OLMo-1B's 11.8 GB of params and AdamW state took 27 s that way and
    12 s this way (``chip_smoke.py`` step 10 on an H100 machine).
    Members the writer compressed are read through ``zipfile``."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            key = info.filename.removesuffix(".npy")
            header = None
            if info.compress_type == zipfile.ZIP_STORED:
                f.seek(info.header_offset)
                local = f.read(30)  # the local file header; name and extra follow
                name_len, extra_len = struct.unpack("<HH", local[26:30])
                f.seek(info.header_offset + 30 + name_len + extra_len)
                header = _NPY_HEADERS.get(np.lib.format.read_magic(f))
            if header is None:
                with zf.open(info) as member:
                    out[key] = np.lib.format.read_array(member)
                continue
            shape, fortran, dtype = header(f)
            a = np.fromfile(f, dtype=dtype, count=int(np.prod(shape)))
            out[key] = a.reshape(shape, order="F" if fortran else "C")
    return out


_NPY_HEADERS = {
    (1, 0): np.lib.format.read_array_header_1_0,
    (2, 0): np.lib.format.read_array_header_2_0,
}


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, process_index: int = 0):
        self.directory = directory
        self.keep = keep
        self.process_index = process_index
        self._inflight: HostFuture | None = None
        self._inflight_step: int | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: PyTree, blocking: bool = False):
        """Queue an asynchronous write of ``state`` at ``step``."""
        self.wait()  # back-pressure: one in flight
        # Device->host copy now (the train loop may replace the state);
        # file I/O on the future.
        host_state = [(path, to_numpy(leaf)) for path, leaf in P.flatten_with_paths(state)]

        def write():
            self._write_sync(step, host_state)
            return step

        self._inflight = HostFuture(write)
        self._inflight_step = step
        if blocking:
            self.wait()

    def _write_sync(self, step: int, host_state: list):
        proc = self.process_index
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + f".tmp{proc}"
        os.makedirs(tmp, exist_ok=True)
        arrays = dict(host_state)
        np.savez(os.path.join(tmp, f"arrays_p{proc}.npz"), **arrays)
        manifest = {
            "step": step,
            "time": time.time(),
            "process": proc,
            "num_arrays": len(arrays),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self):
        if self._inflight is not None:
            self._inflight.force()
            self._inflight = None
            self._inflight_step = None

    def latest_step_or_inflight(self) -> int | None:
        """The step of the write in flight, else :meth:`latest_step`."""
        if self._inflight_step is not None:
            return self._inflight_step
        return self.latest_step()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True
            )

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            # A crash mid-write leaves a stale ``step_N.tmpP`` dir: only
            # exact ``step_<digits>`` names are complete checkpoints.
            if not re.fullmatch(r"step_\d+", name):
                continue
            path = os.path.join(self.directory, name, "manifest.json")
            if os.path.exists(path):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        template: PyTree,
        step: int | None = None,
        device: str | torch.device | None = None,
    ) -> tuple[PyTree, int]:
        """Restore into the structure of ``template``.

        Each leaf comes back in its template leaf's dtype, on the template
        leaf's device, or on ``device`` for a meta template leaf
        (:func:`repro_torch.models.params.abstract_params`,
        :func:`repro_torch.train.optimizer.abstract_opt_state`).  A
        template leaf that is a DTensor gives a DTensor on its mesh with
        its placements, each rank keeping its shard of the array it read
        (the reference ``device_put``s onto ``leaf.sharding``).
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(
            self.directory, f"step_{step:08d}", f"arrays_p{self.process_index}.npz"
        )
        arrays = read_arrays(path)
        leaves = []
        for key, leaf in P.flatten_with_paths(template):
            if key not in arrays:
                raise KeyError(f"checkpoint missing {key}")
            if SH.is_dtensor(leaf):
                mesh = leaf.device_mesh
                value = from_numpy(arrays.pop(key)).to(device=mesh.device_type,
                                                       dtype=leaf.dtype)
                leaves.append(SH.distribute(value, mesh, leaf.placements))
                continue
            target = leaf.device
            if target.type == "meta":
                target = resolve_device(device or "cuda")
            leaves.append(from_numpy(arrays.pop(key)).to(device=target, dtype=leaf.dtype))
        return P.unflatten(P.structure(template), leaves), step
