"""repro_torch.train.train_step against the JAX package, on the CPU.

Smoke configs of one arch per block kind -- olmo-1b (dense),
mamba2-1.3b (SSM), moonshot-v1-16b-a3b (MoE, with its auxiliary
losses), llama-3.2-vision-90b (cross-attention, gates set nonzero) and
musicgen-medium (embedding inputs) -- on the weights the numpy bridge
carries over, with the same batch (B 2, S 16) made with numpy:

* ``lm_loss`` and its gradients against ``jax.value_and_grad(lm_loss)``,
  fp32: the loss to rtol 1e-5, every gradient leaf to
  ``max|Δ| <= 1e-4 · max|g_jax|``;
* bf16: one step's loss finite and within 2e-2 relative of the JAX bf16
  loss (the JAX side compiled with XLA's excess precision off).

tests/test_torch_train_accum.py holds ``accumulate_grads`` at M = 2 and
three ``make_train_step`` steps against the JAX step, on these models
(a file of its own: each file's JAX compiles stay under two minutes of
the parallel test run).  jamba stays out of the JAX comparisons (its JAX train step alone takes
minutes here); every arch of the zoo, jamba included, takes one fp32
smoke step in the port (finite loss, changed params), as
tests/test_models_zoo.py::test_smoke_train_step asks of the reference.
Also: remat on and off give bitwise-equal gradients; ``kernels="cuda"``
is refused and ``"auto"`` resolves to ``"plain"``; the kernel guard on
CPU tensors.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_one_thread import one_torch_thread  # noqa: F401  (one torch thread)
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.models.params import init_params as jax_init_params
from repro.train import train_step as JS
from repro_torch import kernels as K
from repro_torch import pytree as P
from repro_torch.configs.registry import ARCH_IDS, get_config, smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS

ARCHS = ["olmo-1b", "mamba2-1.3b", "moonshot-v1-16b-a3b", "llama-3.2-vision-90b",
         "musicgen-medium"]
B, S = 2, 16
EXACT_BF16 = {"xla_allow_excess_precision": False}
LOSS_RTOL, GRAD_TOL, BF16_RTOL = 1e-5, 1e-4, 2e-2

_MODELS: dict = {}
_JAX: dict = {}


def models(arch, dtype="f32"):
    """Both sides of the smoke model on the same weights; a cross
    block's gate gets a seeded value in [0.5, 1.5] (``init_params``
    gives zeros, and tanh(0) makes the block add 0)."""
    key = (arch, dtype)
    if key not in _MODELS:
        jdt, tdt = {"f32": (jnp.float32, torch.float32),
                    "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
        jcfg = jax_smoke_config(jax_get_config(arch)).with_overrides(dtype=jdt)
        tcfg = smoke_config(get_config(arch)).with_overrides(dtype=tdt, kernels="plain")
        jp = jax_init_params(jax.random.PRNGKey(0), JT.model_layout(jcfg))
        rng = np.random.default_rng(1)
        for blk in jp["blocks"].values():
            if "xattn_gate" in blk:
                g = blk["xattn_gate"]["gate"]
                blk["xattn_gate"]["gate"] = jnp.asarray(rng.uniform(0.5, 1.5, g.shape), g.dtype)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[key] = (jcfg, tcfg, jp, tp)
    return _MODELS[key]


def batch_np(cfg, seed=0, rows=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.embeds_input:
        b["embeds"] = rng.normal(size=(rows, S, cfg.d_model)).astype(np.float32)
    if cfg.vision_tokens:
        b["vision_embeds"] = rng.normal(size=(rows, cfg.vision_tokens, cfg.d_model)).astype(
            np.float32)
    return b


def to_jax(b, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype if v.dtype == np.float32 else v.dtype) for k, v in b.items()}


def to_torch(b, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32 else torch.from_numpy(v)
            for k, v in b.items()}


def assert_tree_close(got, want, tol, what):
    """Every leaf within ``tol * max|want leaf|``."""
    gl, wl = P.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        assert g.shape == w.shape, (what, i)
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= tol * scale, (what, i, np.abs(g - w).max(), scale)


def jax_results(arch):
    """The JAX side, once per arch: the M = 1 loss and gradients, and the
    bf16 loss (tests/test_torch_train_accum.py holds the M = 2 gradients
    and the three steps)."""
    if arch in _JAX:
        return _JAX[arch]
    jcfg, _, jp, _ = models(arch)
    tcfg = JS.TrainConfig()
    (_, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, bb: JS.lm_loss(p, jcfg, bb, tcfg), has_aux=True))(jp, to_jax(batch_np(jcfg)))
    bcfg, _, bjp, _ = models(arch, "bf16")
    bf16_loss = jax.jit(lambda p, bb: JS.lm_loss(p, bcfg, bb, tcfg)[1]["loss"],
                        compiler_options=EXACT_BF16)(bjp, to_jax(batch_np(jcfg), jnp.bfloat16))
    _JAX[arch] = dict(loss=float(aux["loss"]), grads=grads, bf16_loss=float(bf16_loss))
    return _JAX[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    jcfg, tcfg, _, tp = models(arch)
    want = jax_results(arch)
    (total, metrics), grads = TS.value_and_grad(tp, tcfg, to_torch(batch_np(jcfg)),
                                                TS.TrainConfig())
    assert float(metrics["loss"]) == pytest.approx(want["loss"], rel=LOSS_RTOL)
    assert torch.isfinite(total)
    if tcfg.moe is not None:  # the auxiliary losses are in the total
        assert float(metrics["moe_lb_loss"]) > 0
    assert_tree_close(grads, want["grads"], GRAD_TOL, f"{arch} grads")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_step_loss_matches_jax(arch):
    jcfg, tcfg, _, tp = models(arch, "bf16")
    want = jax_results(arch)["bf16_loss"]
    ocfg = O.AdamWConfig()
    step_fn = TS.make_train_step(tcfg, TS.TrainConfig(), ocfg)
    params, opt, m = step_fn(tp, O.init_opt_state(tp, ocfg), to_torch(batch_np(jcfg),
                                                                   torch.bfloat16))
    loss = float(m["loss"])
    assert np.isfinite(loss) and loss == pytest.approx(want, rel=BF16_RTOL)
    assert [p.dtype for p in P.leaves(params)] == [p.dtype for p in P.leaves(tp)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_takes_a_smoke_step(arch):
    """One fp32 step of each smoke config of the zoo, jamba included:
    the loss is finite and every leaf the loss reaches moved."""
    cfg = smoke_config(get_config(arch)).with_overrides(dtype=torch.float32, kernels="plain")
    params = init_params(T.model_layout(cfg), seed=0, device="cpu")
    ocfg = O.AdamWConfig(learning_rate=1e-2, warmup_steps=0)
    new, opt, m = TS.make_train_step(cfg, TS.TrainConfig(), ocfg)(
        params, O.init_opt_state(params, ocfg), to_torch(batch_np(cfg)))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    moved = [not torch.equal(a, b) for a, b in zip(P.leaves(params), P.leaves(new))]
    assert sum(moved) >= len(moved) - 1, moved  # a cross gate's zero init may stay put
    assert int(opt["step"]) == 1


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-1.3b", "moonshot-v1-16b-a3b"])
def test_remat_on_and_off_give_the_same_bits(arch):
    jcfg, tcfg, _, tp = models(arch)
    b = to_torch(batch_np(jcfg))
    (l1, _), g1 = TS.value_and_grad(tp, tcfg, b, TS.TrainConfig(remat=True))
    (l0, _), g0 = TS.value_and_grad(tp, tcfg, b, TS.TrainConfig(remat=False))
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, c) for a, c in zip(P.leaves(g1), P.leaves(g0)))


def test_make_train_step_refuses_cuda_and_resolves_auto():
    cfg = smoke_config(get_config("olmo-1b"))
    with pytest.raises(ValueError, match="not supported for training"):
        TS.make_train_step(cfg, TS.TrainConfig(kernels="cuda"), O.AdamWConfig())
    with pytest.raises(ValueError, match="pipeline_backward='planned'"):
        TS.make_train_step(cfg, TS.TrainConfig(kernels="cuda", pipeline_backward="planned"),
                           O.AdamWConfig())
    with pytest.raises(ValueError, match="expected one of"):
        TS.make_train_step(cfg, TS.TrainConfig(kernels="xla"), O.AdamWConfig())
    assert TS.resolve_train_kernels(TS.TrainConfig(kernels="auto")) == "plain"


def test_train_step_passes_plain_kernels_to_forward(monkeypatch):
    """``cfg.kernels="cuda"`` is not inherited: the step's forward is
    handed ``kernels="plain"``."""
    seen = []
    real = T.forward

    def spy(*a, **kw):
        seen.append(kw.get("kernels"))
        return real(*a, **kw)

    monkeypatch.setattr(T, "forward", spy)
    cfg = smoke_config(get_config("olmo-1b")).with_overrides(dtype=torch.float32,
                                                             kernels="cuda")
    params = init_params(T.model_layout(cfg), device="cpu")
    ocfg = O.AdamWConfig()
    TS.make_train_step(cfg, TS.TrainConfig(kernels="auto", num_microbatches=2), ocfg)(
        params, O.init_opt_state(params, ocfg), to_torch(batch_np(cfg)))
    assert seen == ["plain", "plain"]


def test_kernel_guard_on_cpu_tensors():
    """Every CUDA wrapper ``get_impl`` hands out is behind
    ``no_backward``: a call under autograd with an argument (positional
    or keyword) that requires grad raises; without one, or under
    ``no_grad``, it runs."""
    guarded = K.no_backward("attention", lambda x, *, scale=1.0: x * scale)
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="'attention' CUDA kernel.*no backward"):
        guarded(x)
    with pytest.raises(RuntimeError, match="no backward"):
        guarded(torch.ones(3), scale=torch.ones(3, requires_grad=True))
    with torch.no_grad():
        assert torch.equal(guarded(x), torch.ones(3))
    assert torch.equal(guarded(torch.ones(3), scale=2.0), torch.full((3,), 2.0))
    assert guarded.__name__ == "<lambda>"


def test_get_impl_wraps_every_cuda_entry(monkeypatch):
    """``get_impl(op, "cuda")`` returns the wrapper behind the guard for
    each of the five ops (the CUDA device check is bypassed here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for op in K.OPS:
        fn = K.get_impl(op, "cuda")
        module, attr = K._CUDA_IMPLS[op]
        assert fn.__wrapped__ is getattr(importlib.import_module(module), attr)
        with pytest.raises(RuntimeError, match=f"'{op}' CUDA kernel"):
            fn(torch.ones(2, requires_grad=True))
