"""Random weights from the run's seed, made on the device.

The benchmark makes the weights; the port and the reference are handed
the same values.  The tree has the keys and shapes of the port's
parameter tree (``repro_torch.models.transformer.model_layout``), which
:func:`check_against` verifies, and is drawn in a few large calls: one
normal draw over a flat buffer that holds every random matrix, one
uniform draw for the Mamba-2 per-head vectors, then each leaf scaled in
place.  The same seed gives the same values, so the reference draws
them again after the program's state is freed (:func:`make` with
``dtype=torch.float32`` upcasts the drawn bf16 values exactly).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

_ALIGN = 64  # elements: every leaf starts 128-byte aligned in its buffer


class Spec(NamedTuple):
    shape: tuple
    dtype: str  # "model" (the configuration's dtype) or "float32"
    init: str   # "normal" | "zeros" | "ones" | "a_log" | "dt_bias"
    scale: float = 1.0


def layout(cfg: dict) -> dict:
    """The parameter tree of ``cfg`` as :class:`Spec` leaves."""
    n, d = cfg["n_layers"], cfg["d_model"]
    rms = cfg["norm"] == "rmsnorm"

    def norm(*lead):
        return {"scale": Spec((*lead, d), "float32", "ones")} if rms else {}

    if cfg["block"] == "attention":
        h, kv, dh, f = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["d_ff"]
        block = {
            "norm_mixer": norm(n),
            "attn": {
                "wq": Spec((n, d, h, dh), "model", "normal", d ** -0.5),
                "wk": Spec((n, d, kv, dh), "model", "normal", d ** -0.5),
                "wv": Spec((n, d, kv, dh), "model", "normal", d ** -0.5),
                "wo": Spec((n, h, dh, d), "model", "normal", (h * dh) ** -0.5),
            },
            "norm_ffn": norm(n),
            "mlp": {
                "w_gate": Spec((n, d, f), "model", "normal", d ** -0.5),
                "w_up": Spec((n, d, f), "model", "normal", d ** -0.5),
                "w_down": Spec((n, f, d), "model", "normal", f ** -0.5),
            },
        }
    elif cfg["block"] == "mamba2":
        s = cfg["ssm"]
        d_inner = s["expand"] * d
        heads = d_inner // s["head_dim"]
        gn = s["n_groups"] * s["d_state"]
        conv_dim = d_inner + 2 * gn
        block = {
            "norm_mixer": norm(n),
            "mamba": {
                "in_proj": Spec((n, d, 2 * d_inner + 2 * gn + heads), "model", "normal", d ** -0.5),
                "conv_w": Spec((n, s["d_conv"], conv_dim), "model", "normal", s["d_conv"] ** -0.5),
                "conv_b": Spec((n, conv_dim), "model", "zeros"),
                "A_log": Spec((n, heads), "float32", "a_log"),
                "D": Spec((n, heads), "float32", "ones"),
                "dt_bias": Spec((n, heads), "float32", "dt_bias"),
                "norm_scale": Spec((n, d_inner), "float32", "ones"),
                "out_proj": Spec((n, d_inner, d), "model", "normal", d_inner ** -0.5),
            },
        }
    else:
        raise ValueError(f"unknown block {cfg['block']!r}")
    return {
        "embed": {"embedding": Spec((cfg["table_rows"], d), "model", "normal", 0.02)},
        "blocks": {"block0": block},
        "final_norm": norm(),
        "head": {},
    }


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def _set(tree, path, value):
    *parents, last = path.split("/")
    for p in parents:
        tree = tree[p]
    tree[last] = value


def _skeleton(tree):
    return {k: _skeleton(v) if isinstance(v, dict) else None for k, v in tree.items()}


def make(cfg: dict, seed: int, device, dtype: torch.dtype | None = None) -> dict:
    """The weights of ``cfg`` for ``seed`` on ``device``: matrices in the
    configuration's dtype (or all leaves upcast to ``dtype``)."""
    model_dtype = getattr(torch, cfg["dtype"])
    specs = list(_leaves(layout(cfg)))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = _skeleton(layout(cfg))

    def pack(kind, buf_dtype):
        chosen = [(p, s) for p, s in specs if s.init in kind]
        offsets, total = [], 0
        for _, s in chosen:
            offsets.append(total)
            total += -(-math.prod(s.shape) // _ALIGN) * _ALIGN
        return chosen, offsets, torch.empty(total, dtype=buf_dtype, device=device)

    normal, offs, buf = pack(("normal",), model_dtype)
    buf.normal_(generator=gen)
    for (path, s), o in zip(normal, offs):
        _set(out, path, buf[o:o + math.prod(s.shape)].view(s.shape).mul_(s.scale))
    uniform, offs, ubuf = pack(("a_log", "dt_bias"), torch.float32)
    if uniform:
        ubuf.uniform_(generator=gen)
    for (path, s), o in zip(uniform, offs):
        u = ubuf[o:o + math.prod(s.shape)].view(s.shape)
        if s.init == "a_log":  # A = -exp(A_log) uniform in [-16, -1]
            leaf = torch.log(1 + 15 * u)
        else:  # dt log-uniform in [1e-3, 1e-1]; dt_bias = softplus^-1(dt)
            dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
            leaf = dt + torch.log(-torch.expm1(-dt))
        _set(out, path, leaf)
    for path, s in specs:
        if s.init in ("zeros", "ones"):
            t = torch.zeros if s.init == "zeros" else torch.ones
            _set(out, path, t(s.shape, device=device,
                              dtype=model_dtype if s.dtype == "model" else torch.float32))
    if dtype is not None:
        for path, _ in specs:
            _set(out, path, get(out, path).to(dtype))
    return out


def get(tree, path):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def paths(cfg: dict) -> list[str]:
    return [p for p, _ in _leaves(layout(cfg))]


def check_against(tree: dict, port_layout: dict) -> None:
    """Raise unless ``tree`` has the port's keys, shapes and dtypes
    (``port_layout``: the port's tree of ``ParamSpec``)."""
    mine = {p: (tuple(t.shape), t.dtype) for p, t in _leaves(tree)}
    theirs = {p: (tuple(s.shape), s.dtype) for p, s in _leaves(port_layout)}
    if mine != theirs:
        diff = sorted(set(mine.items()) ^ set(theirs.items()), key=str)
        raise ValueError(f"the benchmark's weights do not match the port's layout: {diff}")
