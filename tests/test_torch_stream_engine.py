"""repro_torch's StreamEngine on the CPU, against the JAX package's
StreamEngine(mesh=None) and its Engine.

The workloads are tests/test_serve.py's TestStreamEngineLazy ones on its
4-group smoke OLMo: greedy with (microbatches, round_steps) (2, 4) and
(4, 3), temperature 0.9 with seed 11, and the max_len boundary.  The
port's engine runs under its LazyEvaluator and under its FutureEvaluator
(gpipe over 2 stages, interleaved over 2 stages of 2 virtual stages) and
must emit the JAX engines' tokens, in fp32 and in bf16 (the JAX side
compiled with XLA's excess precision off, so that it rounds where
PyTorch rounds).  Both sides get the same weights (the numpy bridge).

Also: the decode-cell helpers (views, not copies), rounds that hand back
the cache they were given, and Mamba2 smoke rounds on chunk-aligned
prompts against the port's Engine.
"""
from functools import partial

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import DecodePipelineConfig as JaxPipelineConfig
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.models.params import init_params as jax_init_params
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import StreamEngine as JaxStreamEngine
from repro.serve.engine import decode_copy_bytes_per_tick as jax_copy_bytes
from repro_torch.configs.base import DecodePipelineConfig
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.serve.engine import (
    Engine, ServeConfig, StreamEngine, decode_copy_bytes_per_tick,
)

DTYPES = {"f32": (jax.numpy.float32, torch.float32), "bf16": (jax.numpy.bfloat16, torch.bfloat16)}
EXACT_BF16 = {"xla_allow_excess_precision": False}

# name -> (ServeConfig kwargs, pipeline kwargs, prompts, budgets)
_PROMPTS6 = [[5, 9, 2, 7, 11], [3, 1, 4], [2] * 6, [8, 8], [1, 2, 3, 4], [7]]
WORKLOADS = {
    "greedy_m2_t4": (dict(max_batch=4, max_len=64, prefill_chunk=4, max_new_tokens=6),
                     dict(num_cells=4, microbatches=2, round_steps=4, admit_per_round=3),
                     _PROMPTS6, [6, 3, 5, 1, 6, 4]),
    "greedy_m4_t3": (dict(max_batch=4, max_len=64, prefill_chunk=4, max_new_tokens=6),
                     dict(num_cells=4, microbatches=4, round_steps=3, admit_per_round=3),
                     _PROMPTS6, [6, 3, 5, 1, 6, 4]),
    "temperature": (dict(max_batch=2, max_len=64, prefill_chunk=4, max_new_tokens=5,
                         temperature=0.9, seed=11),
                    dict(num_cells=2, microbatches=2, round_steps=3, admit_per_round=2),
                    [[5, 9, 2], [4, 4], [1, 2, 3]], [None] * 3),
    "max_len": (dict(max_batch=2, max_len=16, prefill_chunk=4, max_new_tokens=64),
                dict(num_cells=2, microbatches=2, round_steps=4, admit_per_round=2),
                [list(range(1, 14)), [2, 3]], [None] * 2),
}
# The port's evaluators: (stages, pipeline overrides).  Interleaving 2
# virtual stages on each of 2 stages needs 4 cells: the cell model has 4
# layer groups.
EVALUATORS = {
    "lazy": (None, {}),
    "future_gpipe": (2, dict(schedule="gpipe")),
    "future_interleaved": (2, dict(schedule="interleaved", interleave=2, num_cells=4)),
}


def _models(dtype):
    jdt, tdt = DTYPES[dtype]
    jcfg = jax_smoke_config(jax_get_config("olmo-1b")).with_overrides(num_layers=4, dtype=jdt)
    tcfg = smoke_config(get_config("olmo-1b")).with_overrides(num_layers=4, dtype=tdt)
    jp = jax_init_params(jax.random.PRNGKey(0), JT.model_layout(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


_MODELS: dict = {}
_JAX_TOKENS: dict = {}


def models(dtype):
    if dtype not in _MODELS:
        _MODELS[dtype] = _models(dtype)
    return _MODELS[dtype]


def _serve(eng, prompts, budgets):
    reqs = [eng.submit(np.array(p), b) for p, b in zip(prompts, budgets)]
    done = eng.run_until_drained()
    assert len(done) == len(reqs) and all(r.done and r.status == "ok" for r in reqs)
    return [r.out_tokens for r in reqs]


def jax_tokens(workload, dtype):
    """Tokens of the JAX Engine and of the JAX StreamEngine(mesh=None)."""
    key = (workload, dtype)
    if key not in _JAX_TOKENS:
        jcfg, _, jp, _ = models(dtype)
        serve, pipe, prompts, budgets = WORKLOADS[workload]
        scfg = JaxServeConfig(**serve)
        prefill = jax.jit(partial(JT.prefill_step, cfg=jcfg, attn_impl="dense"),
                          compiler_options=EXACT_BF16)
        eng = JaxEngine(jp, jcfg, scfg)
        eng._prefill = prefill
        eng._decode = jax.jit(partial(JT.decode_step, cfg=jcfg, attn_impl="dense"),
                              compiler_options=EXACT_BF16)
        seq = _serve(eng, prompts, budgets)
        st = JaxStreamEngine(jp, jcfg, scfg, JaxPipelineConfig(**pipe))
        st._prefill = prefill
        st._round = jax.jit(st._round.__wrapped__, compiler_options=EXACT_BF16)
        _JAX_TOKENS[key] = (seq, _serve(st, prompts, budgets))
    return _JAX_TOKENS[key]


@pytest.mark.parametrize("evaluator", sorted(EVALUATORS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_stream_engine_matches_jax_engines(workload, dtype, evaluator):
    _, tcfg, _, tp = models(dtype)
    serve, pipe, prompts, budgets = WORKLOADS[workload]
    stages, over = EVALUATORS[evaluator]
    eng = StreamEngine(tp, tcfg, ServeConfig(**serve), DecodePipelineConfig(**{**pipe, **over}),
                       stages=stages, device="cpu")
    max_len = serve["max_len"]
    reqs = [eng.submit(np.array(p), b) for p, b in zip(prompts, budgets)]
    for _ in range(100):
        eng.step()
        assert int(eng.lengths.max()) <= max_len - 1  # no write past the cache
        if not eng.queue and all(r is None for r in eng.active):
            break
    assert all(r.done and r.status == "ok" for r in reqs)
    got = [r.out_tokens for r in reqs]
    seq, stream = jax_tokens(workload, dtype)
    assert seq == stream  # the reference's own claim, at this precision
    assert got == stream


def test_stream_engine_matches_the_port_engine():
    """The port's two engines on test_torch_engine.py's 14-request
    workload through 8 slots (4 microbatches, rounds of 3 steps)."""
    _, tcfg, _, tp = models("f32")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 512, size=int(rng.integers(1, 9))) for _ in range(14)]
    budgets = [int(b) for b in rng.integers(1, 8, size=14)]
    scfg = ServeConfig(max_batch=8, max_len=64, prefill_chunk=4, max_new_tokens=6)
    want = _serve(Engine(tp, tcfg, scfg, device="cpu"), prompts, budgets)
    pcfg = DecodePipelineConfig(num_cells=4, microbatches=4, round_steps=3, admit_per_round=4)
    for stages in (None, 4):
        got = _serve(StreamEngine(tp, tcfg, scfg, pcfg, stages=stages, device="cpu"),
                     prompts, budgets)
        assert got == want


@pytest.mark.parametrize("stages,schedule,interleave", [(None, "gpipe", 1), (2, "gpipe", 1),
                                                       (2, "interleaved", 2)])
def test_mamba_rounds_match_the_port_engine(stages, schedule, interleave):
    """Mamba2 smoke (4 layer groups, SSD chunk 8) on chunk-aligned
    prompts: the cells write their sequences' conv and SSD state in
    place."""
    cfg = smoke_config(get_config("mamba2-1.3b")).with_overrides(num_layers=4,
                                                                 dtype=torch.float32)
    params = init_params(T.model_layout(cfg), seed=0, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 512, size=n) for n in (8, 16, 8, 24, 16)]
    budgets = [5, 3, 6, 4, 5]
    scfg = ServeConfig(max_batch=4, max_len=64, prefill_chunk=8, max_new_tokens=6)
    want = _serve(Engine(params, cfg, scfg, device="cpu"), prompts, budgets)
    pcfg = DecodePipelineConfig(num_cells=4, microbatches=2, round_steps=3, admit_per_round=2,
                                schedule=schedule, interleave=interleave)
    got = _serve(StreamEngine(params, cfg, scfg, pcfg, stages=stages, device="cpu"),
                 prompts, budgets)
    assert got == want


# ---------------------------------------------------------------------------
# The decode cells' helpers and the round's memory
# ---------------------------------------------------------------------------


def test_split_and_merge_are_views():
    _, tcfg, _, tp = models("f32")
    cache = T.init_cache(tcfg, 4, 16, device="cpu")
    consts, states = T.split_decode_cells(tp, cache, 2)
    for a, b in zip(jax.tree.leaves(states["cache"]), jax.tree.leaves(cache)):
        assert a.shape[:2] == (2, 2) and a.data_ptr() == b.data_ptr()
    merged = T.merge_decode_caches(states)
    for a, b in zip(jax.tree.leaves(merged), jax.tree.leaves(cache)):
        assert a.shape == b.shape and a.data_ptr() == b.data_ptr()
    leaf = jax.tree.leaves(consts["blocks"])[0]
    assert leaf.data_ptr() == jax.tree.leaves(tp["blocks"])[0].data_ptr()
    with pytest.raises(ValueError, match="not divisible by num_cells=3"):
        T.split_decode_cells(tp, cache, 3)


def test_admission_payload_layout():
    _, tcfg, _, _ = models("f32")
    singles = [T.init_cache(tcfg, 1, 16, device="cpu") for _ in range(3)]
    for i, s in enumerate(singles):
        s["block0"]["k"] += i
    adm = T.stack_admission_payload(singles, [1, 3, 0], [0, 2, 1], [0, 1, 0], 2)
    k = adm["cache"]["block0"]["k"]
    assert k.shape == (2, 3, 2, 16, tcfg.num_kv_heads, tcfg.head_dim)
    assert all(float(k[:, a].max()) == a for a in range(3))
    assert adm["slot"].shape == (2, 3) and adm["slot"].device.type == "cpu"
    assert adm["step"][1].tolist() == [0, 2, 1]
    empty = T.stack_admission_payload([], [], [], [], 2)
    assert "cache" not in empty and empty["slot"].shape == (2, 0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_copy_bytes_per_tick_matches_jax(dtype):
    jcfg, tcfg, _, _ = models(dtype)
    for rs in (True, False):
        assert (decode_copy_bytes_per_tick(tcfg, 2, 4, row_scatter=rs, max_len=64)
                == jax_copy_bytes(jcfg, 2, 4, row_scatter=rs, max_len=64))


@pytest.mark.parametrize("stages", [None, 2])
def test_a_round_keeps_the_cache_in_place(stages):
    """The cache the engine made is the one every round writes: each
    round hands back the very state tensors it was given."""
    _, tcfg, _, tp = models("f32")
    eng = StreamEngine(tp, tcfg, ServeConfig(max_batch=4, max_len=64, prefill_chunk=4,
                                             max_new_tokens=6),
                       DecodePipelineConfig(num_cells=4, microbatches=2, round_steps=4),
                       stages=stages, device="cpu")
    ptrs = [leaf.data_ptr() for leaf in jax.tree.leaves(eng.cache)]
    states = eng.cell_states
    _serve(eng, _PROMPTS6, [6, 3, 5, 1, 6, 4])
    assert eng.rounds >= 2
    assert [leaf.data_ptr() for leaf in jax.tree.leaves(eng.cache)] == ptrs
    for a, b in zip(jax.tree.leaves(eng.cell_states), jax.tree.leaves(states)):
        assert a is b


def test_engine_knobs():
    _, tcfg, _, tp = models("f32")
    scfg = ServeConfig(max_batch=4, max_len=64)
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        StreamEngine(tp, tcfg, scfg, DecodePipelineConfig(microbatches=3), device="cpu")
    with pytest.raises(ValueError, match="admit_per_round"):
        StreamEngine(tp, tcfg, scfg, DecodePipelineConfig(admit_per_round=0), device="cpu")
    with pytest.raises(ValueError, match="not divisible by num_cells"):
        StreamEngine(tp, tcfg, scfg, DecodePipelineConfig(num_cells=3), device="cpu")
    with pytest.raises(ValueError, match="kernels='cuda' needs"):
        StreamEngine(tp, tcfg, scfg, DecodePipelineConfig(kernels="cuda"), device="cpu")
    eng = StreamEngine(tp, tcfg, scfg, DecodePipelineConfig(kernels="auto"), stages=2,
                       device="cpu")
    assert eng.kernels == "plain" and eng.evaluator.num_stages == 2
    assert eng.evaluator.axis_name == "pod"


@pytest.mark.parametrize("stages", [None, 2])
def test_cells_hand_the_attention_aligned_positions(stages, monkeypatch):
    """The decode-attention kernel takes 16-byte aligned operands; the
    positions a cell passes on (here seen by the row writes, which take
    the same tensor) are aligned even where the item's ``pos`` is a row
    of the round's first items at an 8-byte offset (2 rows a
    microbatch)."""
    _, tcfg, _, tp = models("f32")
    seen = []
    real = T.scatter_decode_rows

    def check(cache, rows_k, rows_v, pos):
        seen.append(pos.data_ptr() % 16)
        return real(cache, rows_k, rows_v, pos)

    monkeypatch.setattr(T, "scatter_decode_rows", check)
    eng = StreamEngine(tp, tcfg, ServeConfig(max_batch=4, max_len=64, prefill_chunk=4,
                                             max_new_tokens=6),
                       DecodePipelineConfig(num_cells=4, microbatches=2, round_steps=4),
                       stages=stages, device="cpu")
    _serve(eng, _PROMPTS6, [6, 3, 5, 1, 6, 4])
    assert seen and not any(seen)
