"""The port stands alone: repro_torch and chip_smoke.py import neither
``jax`` nor the JAX package, and the entry points refuse to run on a
CUDA device that is not there instead of falling back to the CPU."""
import os
import pathlib
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.serve.engine import Engine, ServeConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import jax\b|from jax\b|import repro\b|from repro\b|import repro\.|from repro\.)", re.M)


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], prefix="repro_torch.")
    )


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.serve.engine" in mods and "repro_torch.kernels.decode_attention.ops" in mods
    assert {"repro_torch.models.ssm", "repro_torch.kernels.ssd.ops", "repro_torch.kernels.ssd.ref",
            "repro_torch.kernels.rmsnorm.ops", "repro_torch.kernels.rmsnorm.ref"} <= set(mods)
    assert {"repro_torch.train.train_step", "repro_torch.train.optimizer",
            "repro_torch.train.checkpoint", "repro_torch.train.fault",
            "repro_torch.train.compression", "repro_torch.data.pipeline",
            "repro_torch.core.pipeline", "repro_torch.launch.train"} <= set(mods)
    assert {"repro_torch.parallel.sharding", "repro_torch.parallel.collectives",
            "repro_torch.launch.mesh", "repro_torch.launch.specs", "repro_torch.launch.dryrun",
            "repro_torch.train.elastic", "repro_torch.launch.pipeline_demo"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'repro' or k.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)  # keeps JAX_PLATFORMS
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        stdin=subprocess.DEVNULL, env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_source_scan_finds_no_jax_or_repro_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "scripts" / "time_emit.py",
                                         ROOT / "scripts" / "profile_train.py",
                                         ROOT / "scripts" / "time_engine.py",
                                         ROOT / "scripts" / "engine_tokens.py",
                                         ROOT / "scripts" / "pipeline_ranks.py",
                                         ROOT / "scripts" / "serve_ranks.py",
                                         *sorted((ROOT / "examples").glob("torch_*.py"))]
    assert len(files) > 15 and PKG / "models" / "ssm.py" in files
    assert PKG / "roofline" / "trace.py" in files
    assert {PKG / "parallel" / "sharding.py", PKG / "parallel" / "collectives.py",
            PKG / "launch" / "mesh.py", PKG / "launch" / "specs.py",
            PKG / "launch" / "dryrun.py", PKG / "train" / "elastic.py"} <= set(files)
    assert {f.name for f in files} >= {"torch_quickstart.py", "torch_serve_lm.py",
                                       "torch_train_lm.py",
                                       "torch_polynomial_multiplication.py"}
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, (f, hits)


def _cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(monkeypatch):
    _cuda_absent(monkeypatch)
    cfg = smoke_config(get_config("olmo-1b"))
    layout = T.model_layout(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(layout, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": torch.zeros(2).numpy()})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.resolve_device()
    mamba = smoke_config(get_config("mamba2-1.3b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_cache(mamba, 2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.init_ssm_cache(mamba, mamba.ssm, 2, mamba.dtype)
    params = init_params(layout, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(params, cfg, ServeConfig(max_batch=2, max_len=16))
    # the explicit CPU choice runs
    eng = Engine(params, cfg, ServeConfig(max_batch=2, max_len=16, prefill_chunk=4,
                                          max_new_tokens=2), device="cpu")
    req = eng.submit([1, 2, 3])
    eng.run_until_drained()
    assert req.done and len(req.out_tokens) == 2


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits non-zero and prints no result line without a card."""
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True, text=True,
        stdin=subprocess.DEVNULL, env=env, timeout=120, cwd=ROOT,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_init_params_shapes_dtypes_and_seed():
    cfg = smoke_config(get_config("qwen3-32b"))
    layout = T.model_layout(cfg)
    a = init_params(layout, seed=3, device="cpu")
    b = init_params(layout, seed=3, device="cpu")
    c = init_params(layout, seed=4, device="cpu")
    wq = a["blocks"]["block0"]["attn"]["wq"]
    assert wq.shape == (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim)
    assert wq.dtype == torch.bfloat16
    assert a["blocks"]["block0"]["attn"]["q_norm"].dtype == torch.float32
    assert torch.equal(wq, b["blocks"]["block0"]["attn"]["wq"])
    assert not torch.equal(wq, c["blocks"]["block0"]["attn"]["wq"])
    # fan-in scale, as in the JAX package: the product of the non-stacked
    # axes but the last, here d_model * num_heads for wq (d, H, dh)
    fan_in = cfg.d_model * cfg.num_heads
    assert abs(float(wq.float().std()) * fan_in**0.5 - 1.0) < 0.1


def test_stream_core_and_algorithms_are_walked():
    """The Stream core, the algorithms and the sampler are among the
    modules the import test walks."""
    assert {
        "repro_torch.pytree", "repro_torch.core", "repro_torch.core.graph",
        "repro_torch.core.stream", "repro_torch.core.future", "repro_torch.core.schedules",
        "repro_torch.core.chunking", "repro_torch.algorithms.limb",
        "repro_torch.algorithms.sieve", "repro_torch.algorithms.polynomial",
        "repro_torch.configs.paper_stream", "repro_torch.serve.prng",
    } <= set(_modules())


def test_algorithm_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.algorithms import limb, polynomial, sieve

    _cuda_absent(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sieve.run_sieve(100)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        polynomial.fateman_poly(2, 16, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        polynomial.from_dict({(1, 0, 0): 3}, 4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        limb.from_int(5, 4)
    p, count = sieve.run_sieve(100, block_size=16, primes_per_cell=2, device="cpu")
    assert int(count) == 25 and p.device.type == "cpu"


def test_future_evaluator_and_stream_engine_are_walked():
    """The modules that hold the FutureEvaluator, the ring hand-off, the
    decode cells, the tensor sampler and the StreamEngine are among the
    modules the import test walks (none imports jax or repro)."""
    import importlib

    mods = set(_modules())
    for mod, names in (
        ("repro_torch.core.stream", ("FutureEvaluator",)),
        ("repro_torch.core.future", ("ppermute_future", "stage_stream")),
        ("repro_torch.models.transformer", ("make_decode_cell", "make_decode_emit",
                                            "split_decode_cells", "stack_admission_payload")),
        ("repro_torch.serve.prng", ("threefry2x32_t", "categorical_t")),
        ("repro_torch.serve.engine", ("StreamEngine", "sample_token_t")),
        ("repro_torch.configs.base", ("DecodePipelineConfig",)),
    ):
        assert mod in mods
        assert all(hasattr(importlib.import_module(mod), n) for n in names), mod


def test_stream_engine_and_future_evaluator_raise_without_cuda(monkeypatch):
    from repro_torch.configs.base import DecodePipelineConfig
    from repro_torch.core import FutureEvaluator
    from repro_torch.serve.engine import StreamEngine

    _cuda_absent(monkeypatch)
    cfg = smoke_config(get_config("olmo-1b"))
    params = init_params(T.model_layout(cfg), seed=0, device="cpu")
    scfg = ServeConfig(max_batch=2, max_len=16, prefill_chunk=4, max_new_tokens=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamEngine(params, cfg, scfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FutureEvaluator(2, device="cuda")
    pcfg = DecodePipelineConfig(num_cells=2, microbatches=2, round_steps=2)
    eng = StreamEngine(params, cfg, scfg, pcfg, stages=2, device="cpu")
    req = eng.submit([1, 2, 3])
    eng.run_until_drained()
    assert req.done and len(req.out_tokens) == 2


def test_supervisor_resilience_chunking_and_cli_are_walked():
    """The supervised serving stack, the resilience runbook, the chunk-size
    model and the serve CLI are among the modules the import test walks
    (none imports jax or repro); importing the CLI parses no arguments."""
    import importlib

    mods = set(_modules())
    for mod, names in (
        ("repro_torch.resilience", ("Heartbeat", "InjectedFault", "OneShotInjector",
                                    "RestartBudget", "RestartPolicy", "StragglerTracker")),
        ("repro_torch.resilience.injection", ("call_injector",)),
        ("repro_torch.resilience.heartbeat", ("Heartbeat",)),
        ("repro_torch.resilience.restart", ("RestartBudget",)),
        ("repro_torch.resilience.straggler", ("StragglerTracker",)),
        ("repro_torch.serve.supervisor", ("ServeSupervisor", "SupervisorConfig", "Snapshot",
                                          "chaos_injector", "poison_cache", "NumericsFault",
                                          "WatchdogTimeout", "DrainingError", "RoundFault")),
        ("repro_torch.core.chunking", ("optimal_schedule", "schedule_ticks", "ChunkPolicy")),
        ("repro_torch.serve.engine", ("suggest_decode_pipeline",)),
        ("repro_torch.models.params", ("param_count",)),
        ("repro_torch.launch", ()),
        ("repro_torch.launch.serve", ("main",)),
    ):
        assert mod in mods, mod
        assert all(hasattr(importlib.import_module(mod), n) for n in names), mod


def test_roofline_modules_are_walked():
    """The roofline library (analytic, analysis, trace) is among the
    modules the import test walks: none imports jax or repro."""
    import importlib

    mods = set(_modules())
    for mod, names in (
        ("repro_torch.roofline.analytic", ("forward_flops", "step_flops", "bound_ms",
                                           "decode_kernel_rooflines", "predicted_tick_seconds",
                                           "decode_attention_work", "emit_work", "flash_work",
                                           "ssd_work", "ssd_bound_ms", "rmsnorm_work")),
        ("repro_torch.roofline.analysis", ("RooflineTerms", "model_flops", "active_param_count",
                                           "PEAK_FLOPS_BF16", "HBM_BW")),
        ("repro_torch.roofline.trace", ("records_from_profile", "busy_us", "idle_share",
                                        "longest_gaps", "kernel_time_by_name", "launches",
                                        "launch_streams", "slab_copies", "collective_bytes")),
    ):
        assert mod in mods, mod
        assert all(hasattr(importlib.import_module(mod), n) for n in names), mod
