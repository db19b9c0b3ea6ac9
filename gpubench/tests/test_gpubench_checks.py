"""The check that decides ``correct``: at a small size on the CPU the
control (the reference in fp8 in the program's place) reads above the
program, and a run with the timed path broken underneath comes out not
correct -- the harness's look for a card skipped, the rest of the run
driven as the benchmark drives it.  Serving runs at OLMo-1B's width
(``WIDE_CONFIG``), where its logits have their scale."""
import numpy as np
import pytest
from conftest import SMALL_CONFIG, WIDE_CONFIG, small

SERVE = "olmo1b-serve-long"
TRAIN = ("olmo1b-train-8x2048",)


def _run(harness, name, **kw):
    cell = harness.resolve(name)
    configs, seconds = (WIDE_CONFIG, 2.0) if name == SERVE else (SMALL_CONFIG, 0.3)
    return harness.run_cell(name, 2**31 + 99, seconds, False, device="cpu",
                            overrides=small(cell, configs), **kw)


def test_the_serving_control_reads_above_the_program(harness):
    r = _run(harness, SERVE, control=True)
    assert r["control"]["fp8"]["logit_gap"] > 3 * r["checks"]["logit_gap"]["value"]


@pytest.mark.parametrize("name", TRAIN)
def test_the_training_control_reads_above_the_program(harness, name):
    r = _run(harness, name, control=True)
    prog = {k: c["value"] for k, c in r["checks"].items()}
    for fault in ("fp8", "half_batch"):
        assert any(r["control"][fault][k] > 3 * prog[k] for k in prog), (fault, r)


def test_a_served_token_altered_where_it_is_produced_fails(harness, monkeypatch):
    from repro_torch.serve import engine as E

    calls = []
    orig = E.sample_token

    def altered(logits, *args):
        tok = orig(logits, *args)
        calls.append(1)
        return (tok + 1) % np.asarray(logits).shape[-1] if len(calls) % 3 == 0 else tok

    monkeypatch.setattr(E, "sample_token", altered)
    assert not _run(harness, SERVE)["correct"]


def test_a_decode_step_that_leaves_the_cache_unchanged_fails(harness, monkeypatch):
    from repro_torch.models import transformer as T

    monkeypatch.setattr(T, "scatter_decode_rows", lambda *a, **k: None)
    assert not _run(harness, SERVE)["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_train_step_that_returns_its_state_unchanged_fails(harness, monkeypatch, name):
    from repro_torch.train import train_step as TS

    make = TS.make_train_step

    def unchanged(*a, **k):
        step = make(*a, **k)

        def run(params, opt, batch):
            return (params, opt, step(params, opt, batch)[2])

        return run

    monkeypatch.setattr(TS, "make_train_step", unchanged)
    r = _run(harness, name)
    assert not r["correct"] and r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_a_train_step_on_half_the_batch_fails(harness, monkeypatch, name):
    from repro_torch.train import train_step as TS

    make = TS.make_train_step

    def halved(*a, **k):
        step = make(*a, **k)

        def run(params, opt, batch):
            half = {key: v[: v.shape[0] // 2] for key, v in batch.items()}
            return step(params, opt, half)

        return run

    monkeypatch.setattr(TS, "make_train_step", halved)
    assert not _run(harness, name)["correct"]
