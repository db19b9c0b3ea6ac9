"""PyTorch + CUDA port of the ``repro`` JAX package, for NVIDIA Hopper.

Same module layout and names as ``repro`` (``repro_torch.models.
transformer`` <-> ``repro.models.transformer``); plain functions on
tensors over the same parameter trees, with the TPU's Pallas kernels
replaced by CUDA kernels written for ``sm_90a``
(``repro_torch/kernels/csrc``).  Nothing here imports ``jax`` or
``repro``.

Entry points (``init_params``, ``init_cache``, ``Engine``) run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises instead of falling back.

    A CUDA device that is not present is an error: the caller asks for
    the CPU explicitly (``device="cpu"``), as the tests do.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device
