"""repro_torch.core.pipeline and the planned backward, on the CPU.

``pipeline_apply`` at 4 logical stages x 4 microbatches under gpipe,
one_f_one_b and interleaved (2 virtual stages a stage): in the port the
outputs and the gradients (stage params and input) are bitwise equal
across the Lazy evaluator, the Future evaluator with
``backward="autodiff"`` and with ``backward="planned"``; against the
JAX package's ``pipeline_apply(mesh=None)`` and ``jax.grad`` within
1e-5.  The same for a pipeline of transformer stages (olmo-1b's smoke
config, 8 layers).  The planned backward refuses what the reference's
refuses.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_one_thread import one_torch_thread  # noqa: F401  (one torch thread)
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core import pipeline as JP
from repro.models import transformer as JT
from repro.models.params import init_params as jax_init_params
from repro_torch import pytree as P
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.core import FutureEvaluator, LazyEvaluator, Stream, StreamProgram, evaluate
from repro_torch.core.pipeline import (
    PipelineConfig,
    merge_stages,
    pipeline_apply,
    pipeline_evaluator,
    split_stages,
)
from repro_torch.models import transformer as T
from repro_torch.models.params import params_from_numpy

# (schedule, interleave, stage streams): 4 logical stages each
SCHEDULES = [("gpipe", 1, 4), ("one_f_one_b", 1, 4), ("interleaved", 2, 2)]
RUNS = [("lazy", "autodiff", None), ("autodiff", "autodiff", "D"), ("planned", "planned", "D")]
D_MODEL, BATCH = 6, 8


def _np_params(num_stages=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(num_stages, D_MODEL, D_MODEL)) * 0.5).astype(np.float32),
            "b": (rng.normal(size=(num_stages, D_MODEL)) * 0.1).astype(np.float32)}


def _np_x(seed=1):
    return np.random.default_rng(seed).normal(size=(BATCH, 3, D_MODEL)).astype(np.float32)


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"]) + x


def jax_stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"]) + x


def port_run(params, x, cfg, stages, fn=stage_fn):
    """The output and the gradients of a mean-of-squares loss with respect
    to the stage params and the input."""
    leaves, td = P.flatten(params)
    sp = [t.detach().clone().requires_grad_(True) for t in leaves]
    xx = x.detach().clone().requires_grad_(True)
    out = pipeline_apply(fn, P.unflatten(td, sp), xx, cfg, stages=stages)
    grads = torch.autograd.grad(out.float().square().mean(), sp + [xx])
    return [out.detach()] + list(grads)


def assert_bitwise(a, b, what):
    assert len(a) == len(b)
    for i, (u, v) in enumerate(zip(a, b)):
        assert u.dtype == v.dtype and torch.equal(u, v), (what, i)


@pytest.mark.parametrize("schedule,interleave,devices", SCHEDULES)
def test_pipeline_apply_runs_agree_bitwise_and_with_jax(schedule, interleave, devices):
    p_np, x_np = _np_params(), _np_x()
    params, x = P.tree_map(torch.from_numpy, p_np), torch.from_numpy(x_np)
    base = PipelineConfig(num_stages=4, num_microbatches=4, schedule=schedule,
                          interleave=interleave)
    results = {}
    for label, backward, stages in RUNS:
        cfg = dataclasses.replace(base, backward=backward)
        results[label] = port_run(params, x, cfg, devices if stages else None)
    assert_bitwise(results["autodiff"], results["lazy"], "future/autodiff vs lazy")
    assert_bitwise(results["planned"], results["lazy"], "future/planned vs lazy")

    jcfg = JP.PipelineConfig(num_stages=4, num_microbatches=4, schedule=schedule,
                             interleave=interleave)

    def loss(p, xx):
        out = JP.pipeline_apply(jax_stage_fn, p, xx, jcfg, mesh=None)
        return jnp.mean(jnp.square(out)), out

    (_, jout), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(x_np))
    want = [jout] + jax.tree.leaves(gp) + [gx]
    for got, w in zip(results["planned"], want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("schedule,interleave", [("one_f_one_b", 1), ("interleaved", 2)])
def test_transformer_stages_planned_equals_autodiff(schedule, interleave):
    """olmo-1b's smoke config at 8 layers as a pipeline of stages (the
    layout ``chip_smoke.py`` runs at full width): Lazy, Future/autodiff
    and Future/planned bitwise equal, and the JAX package's
    ``pipeline_apply`` within 1e-5."""
    jcfg = jax_smoke_config(jax_get_config("olmo-1b")).with_overrides(num_layers=8,
                                                                      dtype=jnp.float32)
    tcfg = smoke_config(get_config("olmo-1b")).with_overrides(num_layers=8, dtype=torch.float32,
                                                              kernels="plain")
    jp = jax_init_params(jax.random.PRNGKey(0), JT.model_layout(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    num_stages = 4 * interleave
    plans = T.block_plans(tcfg)
    jplans = JT.block_plans(jcfg)

    def tfn(sp, x):
        positions = torch.arange(x.shape[1])[None, :]
        for i in range(next(iter(sp["block0"]["attn"].values())).shape[0]):
            x, _, _ = T._apply_group(T._group(sp, i), x, tcfg, plans, positions=positions,
                                     attn_impl="chunked", q_chunk=4, kv_chunk=8)
        return x

    def jfn(sp, x):
        positions = jnp.arange(x.shape[1])[None, :]

        def body(x, gp):
            x, _, _ = JT._apply_group(gp, x, jcfg, jplans, positions=positions,
                                      attn_impl="chunked", q_chunk=4, kv_chunk=8)
            return x, None

        return jax.lax.scan(body, x, sp)[0]

    rng = np.random.default_rng(2)
    x_np = rng.normal(size=(8, 16, tcfg.d_model)).astype(np.float32)
    split = split_stages(tp["blocks"], 8, num_stages)
    assert P.leaves(merge_stages(split))[0].shape == P.leaves(tp["blocks"])[0].shape
    base = PipelineConfig(num_stages=num_stages, num_microbatches=4, schedule=schedule,
                          interleave=interleave)
    results = {label: port_run(split, torch.from_numpy(x_np),
                               dataclasses.replace(base, backward=backward),
                               4 if stages else None, fn=tfn)
               for label, backward, stages in RUNS}
    assert_bitwise(results["autodiff"], results["lazy"], "future/autodiff vs lazy")
    assert_bitwise(results["planned"], results["lazy"], "future/planned vs lazy")

    jcfg_p = JP.PipelineConfig(num_stages=num_stages, num_microbatches=4, schedule=schedule,
                               interleave=interleave)
    jsplit = JP.split_stages(jp["blocks"], 8, num_stages)

    def loss(p, xx):
        out = JP.pipeline_apply(jfn, p, xx, jcfg_p, mesh=None)
        return jnp.mean(jnp.square(out)), out

    (_, jout), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jsplit, jnp.asarray(x_np))
    for got, w in zip(results["planned"], [jout] + jax.tree.leaves(gp) + [gx]):
        w = np.asarray(w)
        assert np.abs(got.numpy() - w).max() <= 1e-5 * max(np.abs(w).max(), 1.0)


def test_pipeline_config_matches_jax():
    for sched, v in (("gpipe", 1), ("one_f_one_b", 1), ("interleaved", 2)):
        for backward in ("autodiff", "planned"):
            for m in (1, 4, 8):
                kw = dict(num_stages=4 * v, num_microbatches=m, schedule=sched, interleave=v,
                          backward=backward)
                got, want = PipelineConfig(**kw), JP.PipelineConfig(**kw)
                assert got.bubble_fraction == pytest.approx(want.bubble_fraction)
                assert got.peak_stash_items == want.peak_stash_items
    with pytest.raises(ValueError, match="not divisible by interleave"):
        PipelineConfig(num_stages=3, schedule="interleaved", interleave=2)
    with pytest.raises(ValueError):
        PipelineConfig(backward="other")
    with pytest.raises(ValueError, match="not divisible"):
        split_stages({"w": torch.zeros(6, 2)}, 6, 4)


def test_pipeline_evaluator_and_time_units_on_the_cpu():
    cfg = PipelineConfig(num_stages=4, num_microbatches=2, schedule="one_f_one_b",
                         backward="planned")
    assert isinstance(pipeline_evaluator(cfg), LazyEvaluator)
    assert isinstance(pipeline_evaluator(dataclasses.replace(cfg, num_stages=1), 4),
                      LazyEvaluator)
    ev = pipeline_evaluator(cfg, 4, time_units=True)
    assert isinstance(ev, FutureEvaluator) and ev.backward == "planned" and ev.time_units
    params, x = P.tree_map(torch.from_numpy, _np_params()), torch.from_numpy(_np_x())
    out = pipeline_apply(stage_fn, params, x, cfg, evaluator=ev)
    assert out.shape == x.shape and ev.unit_times() == []


def test_planned_without_autograd_runs_the_forward_only(monkeypatch):
    """No input requires grad (or autograd is off): the plain tick loop,
    no stash, no autograd node; the values are the Lazy run's."""
    from repro_torch.core import stream as S

    calls = []
    monkeypatch.setattr(S._Planned, "apply", lambda *a: calls.append(a))
    params, x = P.tree_map(torch.from_numpy, _np_params()), torch.from_numpy(_np_x())
    cfg = PipelineConfig(num_stages=4, num_microbatches=4, schedule="one_f_one_b",
                         backward="planned")
    lazy = pipeline_apply(stage_fn, params, x, cfg)
    assert torch.equal(pipeline_apply(stage_fn, params, x, cfg, stages=4), lazy)
    with torch.no_grad():
        leaves, td = P.flatten(params)
        rg = P.unflatten(td, [t.clone().requires_grad_(True) for t in leaves])
        assert torch.equal(pipeline_apply(stage_fn, rg, x, cfg, stages=4), lazy)
    assert calls == []


def test_planned_gradients_of_a_mapped_and_finalized_chain():
    """Source maps (fused into the injection) and tail maps (the
    finalize) stay outside the planned node; integer state leaves get no
    gradient; an unused state leaf gets zeros."""
    w = torch.randn(8, 3, 3, generator=torch.Generator().manual_seed(0))
    items = torch.randn(6, 4, 3, generator=torch.Generator().manual_seed(1))

    def run(ev):
        wl = w.clone().requires_grad_(True)
        unused = torch.ones(8, 2, requires_grad=True)
        xi = items.clone().requires_grad_(True)
        state = {"w": wl, "unused": unused, "idx": torch.arange(8)}
        s = (Stream.source(xi).map(lambda a: a * 2.0)
             .through(lambda st, a: (st, torch.tanh(a @ st["w"])), state, mutable_state=False)
             .map(torch.sin))
        out = s.collect(ev).items
        return [out.detach()] + list(torch.autograd.grad(
            out.sum(), [wl, unused, xi], allow_unused=True, materialize_grads=True))

    want = run(LazyEvaluator())
    for sched, v in (("gpipe", 1), ("one_f_one_b", 1), ("interleaved", 2)):
        got = run(FutureEvaluator(4 // v, schedule=sched, interleave=v, backward="planned"))
        assert_bitwise(got, want, sched)
    assert torch.equal(want[2], torch.zeros(8, 2))


def _cell(s, x):
    return s, torch.tanh(x @ s)


def test_planned_refusals_match_the_reference():
    ev = FutureEvaluator(2, backward="planned")
    w = torch.randn(4, 3, 3)
    a = torch.randn(4, 2, 3)
    with pytest.raises(ValueError, match="does not support feedback chains"):
        Stream.feedback(a[:2], 4, lambda x: x * 0.5).through(_cell, w, mutable_state=False) \
            .collect(ev)
    with pytest.raises(ValueError, match="single-source chains only"):
        Stream.source(a).through(_cell, w[:2], mutable_state=False) \
            .zip(Stream.source(a), lambda f, x: f + x) \
            .through(_cell, w[2:], mutable_state=False).collect(ev)
    with pytest.raises(ValueError, match="requires immutable cell state"):
        evaluate(StreamProgram(lambda s, x: (s + 1, x * 2), w, 4), a, ev)
    with pytest.raises(ValueError, match="does not support const_state"):
        Stream.source(a).through(lambda c, s, x: (s, x @ c), torch.zeros(4, 1),
                                 const_state=w, mutable_state=False).collect(ev)
    with pytest.raises(ValueError, match="floating-point source"):
        Stream.source(torch.arange(8).reshape(4, 2)).through(
            lambda s, x: (s, x + 1), torch.zeros(4), mutable_state=False).collect(ev)
    with pytest.raises(ValueError, match="not divisible"):
        Stream.source(a).through(_cell, w[:3], mutable_state=False).collect(ev)
