"""repro_torch's microbatch accumulation and train step against the JAX
package, on the CPU.

The smoke configs and batches of tests/test_torch_train_step.py (one
arch per block kind, weights through the numpy bridge, B 2, S 16):

* ``accumulate_grads`` at M = 2 against the JAX one: the loss to rtol
  1e-5, every gradient leaf to ``max|Δ| <= 1e-4 · max|g_jax|``;
* three ``make_train_step`` steps (M = 2) against the JAX step
  (``accumulate_grads`` + ``adamw_update``): params and moments within
  ``2e-5 · max|p|`` per leaf.  AdamW's ``m / (sqrt(v) + eps)`` is near
  ``sign(g)`` wherever ``|g| >> eps``: at the default eps 1e-8 a
  cancelling gradient element that the two packages round to 7e-8 and
  1.6e-7 (1e-6 of the leaf's largest gradient) moves its parameter by
  a different share of lr each step, over the bound at smoke widths
  (max|p| ~0.08).  The steps run with eps 1e-3, where the update is a
  smooth function of the gradient, at lr 1e-3.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_one_thread import one_torch_thread  # noqa: F401  (one torch thread)
from repro.train import optimizer as JO
from repro.train import train_step as JS
from repro_torch import pytree as P
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS
from test_torch_train_step import (
    ARCHS,
    GRAD_TOL,
    LOSS_RTOL,
    assert_tree_close,
    batch_np,
    models,
    to_jax,
    to_torch,
)

PARAM_TOL = 2e-5
STEP_LR, STEP_EPS = 1e-3, 1e-3

_JAX: dict = {}


def jax_steps(arch):
    """The JAX side, once per arch: the M = 2 accumulated gradients and
    three train steps (M = 2)."""
    if arch in _JAX:
        return _JAX[arch]
    jcfg, _, jp, _ = models(arch)
    accum = jax.jit(lambda p, bb: JS.accumulate_grads(
        p, jcfg, bb, JS.TrainConfig(num_microbatches=2)))
    acc_grads, acc_metrics = accum(jp, to_jax(batch_np(jcfg)))
    ocfg = JO.AdamWConfig(learning_rate=STEP_LR, eps=STEP_EPS, warmup_steps=1,
                          total_steps=10)
    update = jax.jit(lambda p, g, o: JO.adamw_update(p, g, o, ocfg))
    params, opt, losses = jp, JO.init_opt_state(jp, ocfg), []
    for step in range(3):
        g, m = accum(params, to_jax(batch_np(jcfg, seed=10 + step)))
        params, opt, _ = update(params, g, opt)
        losses.append(float(m["loss"]))
    _JAX[arch] = dict(acc_grads=acc_grads, acc_loss=float(acc_metrics["loss"]),
                      params=params, opt=opt, losses=losses)
    return _JAX[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_accumulate_grads_m2_matches_jax(arch):
    jcfg, tcfg, _, tp = models(arch)
    want = jax_steps(arch)
    grads, metrics = TS.accumulate_grads(
        tp, tcfg, to_torch(batch_np(jcfg)), TS.TrainConfig(num_microbatches=2))
    assert float(metrics["loss"]) == pytest.approx(want["acc_loss"], rel=LOSS_RTOL)
    assert all(g.dtype == torch.float32 for g in P.leaves(grads))
    assert_tree_close(grads, want["acc_grads"], GRAD_TOL, f"{arch} accumulated grads")


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch):
    jcfg, tcfg, _, tp = models(arch)
    want = jax_steps(arch)
    ocfg = O.AdamWConfig(learning_rate=STEP_LR, eps=STEP_EPS, warmup_steps=1,
                          total_steps=10)
    step_fn = TS.make_train_step(tcfg, TS.TrainConfig(num_microbatches=2), ocfg)
    params, opt, losses = tp, O.init_opt_state(tp, ocfg), []
    for step in range(3):
        params, opt, m = step_fn(params, opt, to_torch(batch_np(jcfg, seed=10 + step)))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want["losses"], rtol=LOSS_RTOL)
    assert int(opt["step"]) == 3
    for name, got, ref in (("params", params, want["params"]), ("m", opt["m"], want["opt"]["m"]),
                           ("v", opt["v"], want["opt"]["v"])):
        gl, wl = P.leaves(got), jax.tree.leaves(ref)
        for i, (g, w, p) in enumerate(zip(gl, wl, jax.tree.leaves(want["params"]))):
            bound = PARAM_TOL * max(np.abs(np.asarray(p)).max(), 1e-30)
            assert np.abs(g.numpy() - np.asarray(w)).max() <= bound, (arch, name, i)
