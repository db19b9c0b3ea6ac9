"""The port's serving CLI, ``python -m repro_torch.launch.serve``, in
process on the CPU (``--device cpu``) at smoke size.

The sequential engine and the StreamEngine under the Future evaluator
(``--devices 2``: two stages) give the same greedy tokens at fp32 (the
smoke config with its dtype set to fp32 here: the CLI keeps the
reference's flags, which have none for the dtype); ``--chaos raise@1``
gives the fault-free tokens with no request lost.  Also: the flags the
port changes (``--device``, ``--kernels``), the MoE archs at smoke size,
llama-3.2-vision (served without vision embeds) and musicgen (which it
cannot serve: embedding inputs), the schedule suggestion and
``param_count`` against the JAX package's for every arch of the zoo.
"""
import ast
import re
import signal

import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import transformer as JT
from repro.models.params import param_count as jax_param_count
from repro_torch.configs.registry import ARCH_IDS, get_config, smoke_config
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.params import param_count
from repro_torch.serve.engine import suggest_decode_pipeline

BASE = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--num-layers", "4",
        "--requests", "6", "--max-new", "5", "--max-batch", "4", "--max-len", "64",
        "--prompt-len", "9", "--prefill-chunk", "4", "--round-steps", "3",
        "--admit-per-round", "2"]
STREAM = ["--engine", "stream", "--cells", "4", "--microbatches", "2"]


@pytest.fixture
def fp32(monkeypatch):
    monkeypatch.setattr(serve, "smoke_config",
                        lambda cfg: smoke_config(cfg).with_overrides(dtype=torch.float32))


def _tokens(done):
    return {r.uid: r.out_tokens for r in done}


def _supervisor_stats(out: str) -> dict:
    return ast.literal_eval(re.search(r"supervisor: (\{.*\})", out).group(1))


def test_sequential_and_future_stream_give_the_same_tokens(fp32, capsys):
    seq = _tokens(serve.main(BASE))
    assert len(seq) == 6 and all(len(t) == 5 for t in seq.values())
    for extra in (["--devices", "2"], ["--devices", "2", "--schedule", "interleaved",
                                       "--interleave", "2"], ["--devices", "1"]):
        assert _tokens(serve.main(BASE + STREAM + extra)) == seq, extra
    out = capsys.readouterr().out
    assert "[sequential]" in out and "stream/interleavedxV2 D=2 S=4 M=2 T=3" in out


@pytest.mark.parametrize("engine", [[], STREAM + ["--devices", "2"]], ids=["sequential", "stream"])
def test_chaos_raise_replays_to_the_fault_free_tokens(fp32, capsys, engine):
    want = _tokens(serve.main(BASE + engine))
    prev = signal.getsignal(signal.SIGTERM)
    got = _tokens(serve.main(BASE + engine + ["--chaos", "raise@1", "--watchdog-ms", "60000"]))
    assert signal.getsignal(signal.SIGTERM) is prev  # main hands SIGTERM back
    out = capsys.readouterr().out
    stats = _supervisor_stats(out)
    assert "+supervised" in out
    assert stats["requests_lost"] == 0 and stats["faults"] == stats["restarts"] == 1
    assert got == want


def test_chaos_nan_on_the_bf16_smoke_model(capsys):
    want = _tokens(serve.main(BASE))
    got = _tokens(serve.main(BASE + ["--chaos", "nan@2"]))
    stats = _supervisor_stats(capsys.readouterr().out)
    assert stats["requests_lost"] == 0 and stats["restarts"] == 1
    assert got == want


def test_suggest_schedule_prints_the_models_pick(capsys):
    serve.main(BASE + STREAM + ["--devices", "2", "--suggest-schedule", "--requests", "1"])
    out = capsys.readouterr().out
    cfg = smoke_config(get_config("olmo-1b")).with_overrides(num_layers=4, kernels="auto")
    pick = suggest_decode_pipeline(cfg, devices=2, work_per_item=1e-3, per_tick_overhead=1e-5,
                                   microbatch=2, num_cells=4, max_len=64,
                                   copy_bytes_per_second=50e9, max_chunks=4)
    assert f"{pick.schedule} M={pick.num_chunks} V={pick.interleave}" in out
    serve.main(BASE + STREAM + ["--suggest-schedule", "--requests", "1"])
    assert "suggest-schedule: skipped" in capsys.readouterr().out


def test_kernels_flag_takes_the_ports_modes():
    serve.main(BASE + ["--kernels", "plain", "--requests", "1"])
    with pytest.raises(SystemExit):
        serve.main(BASE + ["--kernels", "pallas"])
    with pytest.raises(ValueError, match="needs tensors on a CUDA device"):
        serve.main(BASE + ["--kernels", "cuda", "--requests", "1"])


def test_device_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in BASE if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(argv)


@pytest.mark.parametrize("arch,layers", [("jamba-1.5-large-398b", 16),
                                         ("llama4-maverick-400b-a17b", 4),
                                         ("moonshot-v1-16b-a3b", 2)])
def test_moe_archs_serve_at_smoke_size(arch, layers, capsys):
    """The MoE families serve through the CLI, sequential and over two
    Future stages, with the same greedy tokens at fp32 (``layers``: two
    layer groups, one a cell)."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--num-layers", str(layers),
            "--requests", "3", "--max-new", "3", "--max-batch", "2", "--max-len", "32",
            "--prompt-len", "9", "--prefill-chunk", "4"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serve, "smoke_config",
                   lambda cfg: smoke_config(cfg).with_overrides(dtype=torch.float32))
        seq = _tokens(serve.main(argv))
        stream = _tokens(serve.main(argv + ["--engine", "stream", "--devices", "2",
                                            "--cells", "2", "--microbatches", "2"]))
    assert len(seq) == 3 and all(len(t) == 3 for t in seq.values())
    assert stream == seq
    assert f"arch={arch}" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "musicgen-medium"])
def test_vision_arch_serves_and_embeds_arch_exits(arch, capsys):
    """llama-3.2-vision serves text prompts at smoke size, sequential and
    over two Future stages with the same greedy tokens at fp32 (no vision
    embeds, as the JAX engines serve it: tests/test_torch_cross_attn.py);
    musicgen exits, as the reference's CLI does, naming the embedding
    frontend stub (tests/test_torch_embeds.py)."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3", "--max-new", "3",
            "--max-batch", "2", "--max-len", "32", "--prompt-len", "9", "--prefill-chunk", "4"]
    if arch == "musicgen-medium":
        with pytest.raises(SystemExit, match="embedding frontend stub"):
            serve.main(argv)
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serve, "smoke_config",
                   lambda cfg: smoke_config(cfg).with_overrides(dtype=torch.float32))
        seq = _tokens(serve.main(argv))
        stream = _tokens(serve.main(argv + ["--engine", "stream", "--devices", "2",
                                            "--cells", "2", "--microbatches", "2"]))
    assert len(seq) == 3 and all(len(t) == 3 for t in seq.values())
    assert stream == seq
    assert f"arch={arch}" in capsys.readouterr().out


def test_bad_chaos_spec_exits():
    with pytest.raises(SystemExit, match="KIND@ROUND"):
        serve.main(BASE + ["--chaos", "raise"])
    with pytest.raises(SystemExit, match="KIND@ROUND"):
        serve.main(BASE + ["--chaos", "meteor@1"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_equals_jax(arch):
    got = param_count(T.model_layout(get_config(arch)))
    assert got == jax_param_count(JT.model_layout(jax_get_config(arch))) > 0
