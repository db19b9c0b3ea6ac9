"""Hopper kernel library, its build helper and the per-op dispatch registry.

Each op lives in its own package (``ref.py`` = the plain PyTorch version
that follows the JAX ``ref.py`` op for op, ``ops.py`` = the wrapper that
checks its operands and launches the kernel); the CUDA sources are under
``csrc/``:

* ``decode_attention`` -- the serving hot path: the new K/V row is
  substituted into the cache page on chip and one query row is read
  against it, so no updated cache page is written before the read.
* ``emit_norm_logits`` -- decode-emit epilogue: final norm + LM-head
  product in one pass over vocab tiles.
* ``attention`` (``flash_attention``) -- the prompt path: tiled
  online-softmax attention, causal or not, GQA, with chunked prefill's
  ``q_offset`` and ``kv_len``; ``layers.attention(impl="flash")`` and
  through it ``forward`` and ``prefill_step`` dispatch it.
* ``ssd`` -- Mamba-2 SSD: the intra-chunk kernel plus the cross-chunk
  recurrence (``ssd_chunked_cuda``); ``models.ssm.ssm_block`` dispatches
  it on every prefill chunk and full-sequence forward.
* ``rmsnorm`` -- row-wise RMSNorm, with an optional fused gate
  ``x * silu(z)``; under ``"cuda"`` ``ssm_block`` dispatches it for the
  Mamba-2 gated norm and ``models.transformer`` for every block pre-norm
  of an rmsnorm model.  Final norms and OLMo's layernorm stay plain
  PyTorch (on the decode path the emit kernel computes the final norm).

Model code selects implementations through :func:`get_impl` driven by the
``kernels`` config knob (``"plain" | "cuda" | "auto"``).  ``"auto"``
resolves to ``"cuda"`` for tensors on a CUDA device and to ``"plain"``
on the CPU; ``"cuda"`` without a CUDA device raises.  A wrapper given a
CPU tensor runs the plain version; given a CUDA tensor it launches its
kernel or raises -- it never falls back.

Kernels are compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` at the repo root (content-addressed, so an edited
source is rebuilt) and loaded with ``ctypes``; each C entry point
returns ``cudaGetLastError()`` after its launch.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

KERNEL_MODES = ("plain", "cuda", "auto")

# op -> (module path, attr) of the CUDA wrapper and of the plain version
# (same call signature).
_CUDA_IMPLS = {
    "decode_attention": (
        "repro_torch.kernels.decode_attention.ops", "fused_decode_attention"
    ),
    "emit_norm_logits": (
        "repro_torch.kernels.emit_norm_logits.ops", "emit_norm_logits"
    ),
    "attention": (
        "repro_torch.kernels.flash_attention.ops", "flash_attention"
    ),
    "ssd": ("repro_torch.kernels.ssd.ops", "ssd_chunked_cuda"),
    "rmsnorm": ("repro_torch.kernels.rmsnorm.ops", "rmsnorm"),
}
_PLAIN_IMPLS = {
    "decode_attention": (
        "repro_torch.kernels.decode_attention.ref", "decode_attention_ref"
    ),
    "emit_norm_logits": (
        "repro_torch.kernels.emit_norm_logits.ref", "emit_norm_logits_ref"
    ),
    "attention": (
        "repro_torch.kernels.flash_attention.ref", "flash_attention_ref"
    ),
    "ssd": ("repro_torch.kernels.ssd.ref", "ssd_chunked_ref"),
    "rmsnorm": ("repro_torch.kernels.rmsnorm.ref", "rmsnorm_ref"),
}

OPS = tuple(_CUDA_IMPLS)

# Kernel launches per op, counted by each wrapper where it launches its
# kernel (never for a CPU tensor's plain version): the proof that a run
# went through the kernels.
LAUNCHES = {op: 0 for op in OPS}


def reset_launches() -> None:
    for op in LAUNCHES:
        LAUNCHES[op] = 0


def resolve_mode(mode: str, device: str | torch.device) -> str:
    """Validate the ``kernels`` knob and collapse ``auto`` for ``device``."""
    if mode not in KERNEL_MODES:
        raise ValueError(f"kernels={mode!r}; expected one of {KERNEL_MODES}")
    device = torch.device(device)
    if mode == "auto":
        return "cuda" if device.type == "cuda" else "plain"
    if mode == "cuda" and device.type != "cuda":
        raise ValueError(f"kernels='cuda' needs tensors on a CUDA device, not {device}")
    return mode


def get_impl(op: str, mode: str = "auto"):
    """The implementation of ``op`` under the ``kernels`` mode.

    ``"cuda"`` returns the kernel's wrapper behind :func:`no_backward`
    and raises when no CUDA device is present (it never hands back the plain version);
    ``"plain"`` returns the PyTorch version with the same signature;
    ``"auto"`` is ``"cuda"`` when a CUDA device is present.  Imports
    lazily.
    """
    if mode == "auto":
        mode = "cuda" if torch.cuda.is_available() else "plain"
    elif mode not in KERNEL_MODES:
        raise ValueError(f"kernels={mode!r}; expected one of {KERNEL_MODES}")
    if mode == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the {op!r} CUDA kernel needs a CUDA device; none is available")
    table = _CUDA_IMPLS if mode == "cuda" else _PLAIN_IMPLS
    if op not in table:
        raise ValueError(f"unknown kernel op {op!r}; have {OPS}")
    module_path, attr = table[op]
    fn = getattr(importlib.import_module(module_path), attr)
    return _guarded(op, fn) if mode == "cuda" else fn


@functools.lru_cache(maxsize=None)
def _guarded(op: str, fn):
    return no_backward(op, fn)


# ---------------------------------------------------------------------------
# Build: nvcc -> shared library with a plain C interface -> ctypes
# ---------------------------------------------------------------------------

def no_backward(op: str, fn):
    """``fn`` behind the training guard: a call raises when autograd is
    recording and a tensor argument requires grad.  A kernel wrapper
    computes through raw pointers into a fresh output, which has no
    ``grad_fn``; under autograd its result would cut the gradient at the
    op without an error.  Every CUDA wrapper :func:`get_impl` hands out
    is behind it; the serving paths pass no tensor that requires grad."""

    @functools.wraps(fn)
    def guarded(*args, **kwargs):
        if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad
            for a in (*args, *kwargs.values())
        ):
            raise RuntimeError(
                f"the {op!r} CUDA kernel was called under autograd with an input that "
                "requires grad: the port's kernels have no backward.  Train with "
                "kernels='plain' (make_train_step resolves 'auto' to it), or call the "
                "kernel under torch.no_grad()"
            )
        return fn(*args, **kwargs)

    return guarded


CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("decode_attention", "emit_norm_logits", "flash_attention", "ssd", "rmsnorm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to; the name hashes the source, the
    shared headers (``csrc/*.cuh``) and the flags, so an edited source or
    header never loads a stale library."""
    text = (CSRC / f"{name}.cu").read_bytes()
    text += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library of ``names`` not built yet: one ``nvcc`` per
    source, all started together.  Returns each new build's compiler
    output (``-Xptxas -v``: registers, shared memory, spills); raises
    with the output of every source that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        started[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in started.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name}.cu: nvcc exited {proc.returncode}\n{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def kernel_function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of library ``name``, built on first
    use.  Pointers and the stream must be ``ctypes.c_void_p`` in
    ``argtypes``, or ctypes would pass them as 32-bit ints."""
    key = (name, symbol)
    if key not in _FUNCS:
        build([name])
        fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[key] = fn
    return _FUNCS[key]


_TICKETS: dict[tuple[torch.device, int], torch.Tensor] = {}
# Tickets for launches captured into CUDA graphs: a zeroed buffer per
# device and the offset of its first ticket not yet handed out.
_CAPTURE_RESERVE: dict[torch.device, list] = {}
# Each captured launch takes a slice of its own; the reserve keeps room
# for this many launches at the count of the last call outside a capture.
CAPTURE_LAUNCHES = 256
# Buffers replaced by larger ones: kept for the life of the process, since
# a CUDA graph captured earlier may still point at them.
_RETIRED: list[torch.Tensor] = []


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def merge_tickets(device: torch.device, count: int, stream: int) -> torch.Tensor:
    """At least ``count`` int32 merge tickets for one launch on ``stream``
    (the ``cuda_stream`` handle the kernel is launched on) of ``device``.

    The attention kernels that split a row over blocks count finished
    splits here with atomics; the split that merges resets its ticket, so
    every launch leaves its tickets zeroed (a CUDA-graph replay finds them
    so).  Eager launches on one stream run in order and share its buffer;
    two streams never share one.  A launch captured into a CUDA graph
    takes tickets of its own, a slice of a buffer reserved outside any
    capture: a graph may be replayed on any stream, beside eager work or
    another graph, and meets no other launch's tickets.  Nothing is
    allocated while capturing: each call outside a capture keeps room in
    the reserve for :data:`CAPTURE_LAUNCHES` launches of its count, and a
    capture that finds too little raises.  No buffer that was handed out
    is ever freed (a graph may still use it)."""
    device = torch.device(device)
    if _capturing(device):
        reserve = _CAPTURE_RESERVE.get(device)
        if reserve is None or reserve[0].numel() - reserve[1] < count:
            raise RuntimeError(
                f"merge tickets: {count} needed in a capture, "
                f"{0 if reserve is None else reserve[0].numel() - reserve[1]} reserved; "
                f"call the wrapper once at the largest shape before capture"
            )
        start = reserve[1]
        reserve[1] += count
        return reserve[0][start:start + count]
    key = (device, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < count:
        if t is not None:
            _RETIRED.append(t)
        t = _TICKETS[key] = torch.zeros(max(count, 4096), dtype=torch.int32, device=device)
    reserve = _CAPTURE_RESERVE.get(device)
    if reserve is None or reserve[0].numel() - reserve[1] < CAPTURE_LAUNCHES * count:
        if reserve is not None:
            _RETIRED.append(reserve[0])
        _CAPTURE_RESERVE[device] = [
            torch.zeros(max(CAPTURE_LAUNCHES * count, 65536), dtype=torch.int32, device=device), 0]
    return t


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device, which the split-choosing functions fill."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_launch(name: str, code: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {code}")
