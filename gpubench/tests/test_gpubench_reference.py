"""The plain fp32 reference agrees with the port at a small size: the
forward pass of each block kind, and the train step with AdamW."""

import numpy as np
import pytest
import torch
from conftest import SMALL_CONFIG


def _config(harness, name):
    cfg = harness.load_json(harness.ROOT / "gpubench" / "configs" / f"{name}.json")
    return {**cfg, **SMALL_CONFIG[name], "dtype": "float32"}


@pytest.mark.parametrize("name", sorted(SMALL_CONFIG))
def test_reference_forward_matches_the_port(harness, name):
    from gpubench import weights
    from gpubench.reference import model
    from repro_torch.models import transformer as T

    cfg = _config(harness, name)
    arch = harness.port_arch(cfg, "plain")
    w = weights.make(cfg, 2**32 + 3, "cpu")
    weights.check_against(w, T.model_layout(arch))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg["vocab_size"], (2, 24)))
    ours, _, _ = T.forward(w, arch, tokens=tokens, attn_impl="dense", kernels="plain", remat=False)
    with torch.no_grad():
        ref = model.logits(cfg, w, model.hidden(cfg, w, tokens))
    torch.testing.assert_close(ours, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(SMALL_CONFIG))
def test_reference_train_steps_match_the_port(harness, name):
    from gpubench import generate, weights
    from gpubench.reference import train
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = _config(harness, name)
    arch = harness.port_arch(cfg, "plain")
    mix = harness.load_json(harness.ROOT / "gpubench" / "traffic" / "train_8x2048.json")
    mix = {**mix, "batch": 2, "seq_len": 16}
    ocfg = O.AdamWConfig(moment_dtype=torch.float32, **mix["optimizer"])
    step = make_train_step(arch, TrainConfig(attn_impl="dense", z_loss_coef=1e-4), ocfg)
    data = generate.TrainData(mix, 9, cfg["vocab_size"])
    batches = [data.batch(i) for i in range(2)]
    w = weights.make(cfg, 9, "cpu")
    params, opt, losses = w, O.init_opt_state(w, ocfg), []
    for b in batches:
        params, opt, m = step(params, opt, {k: torch.as_tensor(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    ref_params = {p: weights.get(weights.make(cfg, 9, "cpu"), p) for p in weights.paths(cfg)}
    ref = train.run(cfg, ref_params, batches, mix["optimizer"], z_loss=1e-4, rows_per_block=1)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for p in weights.paths(cfg):
        torch.testing.assert_close(weights.get(params, p), ref_params[p].detach(),
                                   rtol=1e-4, atol=1e-6)
