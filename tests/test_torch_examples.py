"""The port's examples (``examples/torch_*.py``) at ``--device cpu``, at the
smallest size their flags allow, against the reference's examples.

Each example's own checks must pass.  Where the output is deterministic
it must equal the reference example's: the quickstart's stream items
(fp32, to 1e-6), its chunk count, primes and its served tokens; the
polynomial products term for term; the serve example's tokens.  The
served tokens are compared on the reference's weights with the served
model in fp32: the two packages' bf16 paths round apart, so bf16 greedy
tokens part at near-ties, and the reference's examples have no dtype
flag.  Training draws its own weights and data order, so only the loss
check is held there, at 2 layers of 64 tokens.
"""
import importlib.util
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from _torch_one_thread import one_torch_thread  # noqa: F401
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models.params import init_params as jax_init_params
from repro_torch.configs.registry import smoke_config
from repro_torch.models.params import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _floats(text):
    return np.array([float(x) for x in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", text)])


def test_quickstart_matches_the_reference(capsys, monkeypatch):
    """Both quickstarts with their served model in fp32 (the two packages'
    bf16 paths round apart, so bf16 greedy tokens part at near-ties) and
    the port's on the reference's weights."""
    import repro.configs.registry as jreg
    import repro_torch.configs.registry as treg
    from repro.models import transformer as JT

    monkeypatch.setattr(jreg, "smoke_config",
                        lambda cfg: jax_smoke_config(cfg).with_overrides(dtype=jax.numpy.float32))
    monkeypatch.setattr(treg, "smoke_config",
                        lambda cfg: smoke_config(cfg).with_overrides(dtype=torch.float32))
    ref = _load("quickstart")
    ref.main()
    want = capsys.readouterr().out

    jcfg = jreg.smoke_config(jreg.get_config("olmo-1b")).with_overrides(num_layers=4)
    jp = jax_init_params(jax.random.PRNGKey(0), JT.model_layout(jcfg))
    ex = _load("torch_quickstart")
    monkeypatch.setattr(ex, "build_params", lambda layout, device: params_from_numpy(
        jax.tree.map(np.asarray, jp), device=device))
    got = ex.main(["--device", "cpu"])
    out = capsys.readouterr().out

    assert "lazy == future: True" in out and "zip: lazy == future: True" in out
    np.testing.assert_array_equal(got["lazy"], got["future"])
    line = {k: next(x for x in want.splitlines() if x.startswith(k))
            for k in ("lazy:", "feedback:", "optimal #chunks", "primes < 200")}
    np.testing.assert_allclose(got["lazy"][0], _floats(line["lazy:"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["feedback"][-1], _floats(line["feedback:"]), rtol=1e-6,
                               atol=1e-7)
    assert line["optimal #chunks"].endswith(f": {got['chunks']}")
    primes_ref = [int(x) for x in re.findall(r"\d+", want.split("primes < 200")[1].split("served")[0])]
    assert primes_ref[0] == len(got["primes"]) == 46
    assert primes_ref[1:] == got["primes"].tolist()
    served = {int(u): [int(t) for t in toks.split(",")]
              for u, toks in re.findall(r"served req (\d+): \[([\d, ]+)\]", want)}
    assert got["served"] == served and all(len(t) == 6 for t in served.values())


def test_polynomial_products_match_the_reference():
    from repro.algorithms import polynomial as jpoly

    ex = _load("torch_polynomial_multiplication")
    got = ex.main(["--power", "2", "--device", "cpu"])
    for tag, limbs, big in (("stream", 4, 1), ("stream_big", 12, 100000000001)):
        # the reference example's inputs and its oracle (capacity 32 at power 2)
        x = jpoly.fateman_poly(2, 32, limbs, big_factor=big)
        want = jpoly.reference_product(jpoly.to_dict(x), jpoly.to_dict(x))
        for variant in ("lazy", "future", "list"):
            assert got[tag][variant] == want, (tag, variant)


@pytest.fixture
def fp32_serve(monkeypatch):
    """The serve CLIs on the reference's weights in fp32: both packages'
    ``smoke_config`` give fp32 configs, and the port's CLI draws the JAX
    weights."""
    from repro.launch import serve as jserve
    from repro.models import transformer as JT
    from repro_torch.launch import serve as tserve

    monkeypatch.setattr(jserve, "smoke_config",
                        lambda cfg: jax_smoke_config(cfg).with_overrides(dtype=jax.numpy.float32))
    monkeypatch.setattr(tserve, "smoke_config",
                        lambda cfg: smoke_config(cfg).with_overrides(dtype=torch.float32))
    def reference_weights(layout, seed, device):
        from repro.configs.registry import get_config as jax_get_config

        jcfg = jax_smoke_config(jax_get_config("qwen3-32b")).with_overrides(
            dtype=jax.numpy.float32)
        jp = jax_init_params(jax.random.PRNGKey(seed), JT.model_layout(jcfg))
        return params_from_numpy(jax.tree.map(np.asarray, jp), device=device)

    monkeypatch.setattr(tserve, "init_params", reference_weights)


def test_serve_lm_matches_the_reference(fp32_serve, capsys):
    from repro.launch.serve import main as jax_serve_main

    ref_argv = ["--arch", "qwen3-32b", "--smoke", "--requests", "12",
                "--max-batch", "4", "--max-new", "8", "--prompt-len", "20"]
    want = {r.uid: list(r.out_tokens) for r in jax_serve_main(ref_argv)}
    src = (ROOT / "examples" / "serve_lm.py").read_text()
    assert all(a in src for a in ref_argv)  # the reference example's own argv
    ex = _load("torch_serve_lm")
    assert ex.ARGV == ref_argv
    got = {r.uid: list(r.out_tokens) for r in ex.main(["--device", "cpu"])}
    out = capsys.readouterr().out
    assert "[sequential] 12 requests, 96 tokens" in out
    assert got == want and all(len(t) == 8 for t in got.values())


def test_train_lm_loss_decreases(tmp_path, capsys):
    ex = _load("torch_train_lm")
    history = ex.main(["--device", "cpu", "--steps", "20", "--layers", "2", "--seq-len", "64",
                       "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert len(history) == 20 and "OK: loss decreased" in out
    assert "arch=olmo-1b" in out and "device=cpu" in out


def test_examples_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, argv in (("torch_quickstart", []), ("torch_polynomial_multiplication", [])):
        with pytest.raises(RuntimeError, match="--device cpu"):
            _load(name).main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load("torch_serve_lm").main([])
