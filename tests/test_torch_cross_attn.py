"""Cross-attention to vision tokens (llama-3.2-vision-90b) in repro_torch
against the JAX package on the CPU.

The smoke config (one cross-attention block in a period of 5 layers,
16 vision tokens), and the same with ``qk_norm=True`` and with
``qkv_bias=True`` to reach the norm branch and the cross block's
missing biases.  Both sides run on the weights the numpy bridge carries
over and on vision embeddings made with numpy.  ``init_params`` gives
every ``xattn_gate.gate`` zeros, and ``tanh(0)`` makes a cross block
add exactly 0 (``test_zero_gate_makes_the_vision_input_irrelevant``), so
every other test sets the gates, and the qk-norm scales and qkv biases,
to seeded nonzero values first.

The JAX engines pass no vision embeds: served tokens read the zero
vision K/V of a fresh cache, whose cross blocks add 0.  The port's
engines are held to the JAX ``Engine``'s tokens on that contract; the
cross-attention itself is held by ``forward``, ``prefill_step`` and
``decode_step`` with ``vision_embeds``.
"""
from functools import cache, partial

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
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import decode_copy_bytes_per_tick as jax_copy_bytes
from repro_torch.configs.base import DecodePipelineConfig
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.serve.engine import (
    Engine, ServeConfig, StreamEngine, decode_copy_bytes_per_tick,
)
from repro_torch.serve.supervisor import ServeSupervisor, chaos_injector


ARCH = "llama-3.2-vision-90b"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
VARIANTS = {"base": {}, "qk_norm": {"qk_norm": True}, "qkv_bias": {"qkv_bias": True}}
EXACT_BF16 = {"xla_allow_excess_precision": False}
# fp32: the same ops on both sides, sums in another order: a few fp32
# ulps per op through ~10 ops of depth on logits of magnitude < 1
# (tests/test_torch_transformer.py's tolerance).
FP32_ATOL = 2e-5
CROSS = "block4"  # the smoke period's cross-attention block


def bf16_ulp(x) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(x))) - 7))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def both(a: np.ndarray, jdt):
    """The same values on both sides: a jnp array of ``jdt`` and the
    tensor of its exact fp32 image, cast back to ``jdt``'s torch dtype."""
    j = jnp.asarray(a, jdt)
    if jdt == jnp.int32:  # tokens
        return j, torch.as_tensor(np.array(j), dtype=torch.long)
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[jdt]
    return j, torch.from_numpy(np.array(_np(j))).to(tdt)


def build(dtype="f32", variant="base", num_layers=None, gates=True):
    """Both sides of the smoke model on the same weights.  With
    ``gates``, every cross block's gate gets a seeded value in [0.5, 1.5]
    (tanh 0.46-0.91), and the qk-norm scales and qkv biases, where the
    variant has them, seeded values of order 1 and 0.5."""
    jdt, tdt = DTYPES[dtype]
    over = dict(VARIANTS[variant], dtype=jdt)
    if num_layers:
        over["num_layers"] = num_layers
    jcfg = jax_smoke_config(jax_get_config(ARCH)).with_overrides(**over)
    tcfg = smoke_config(get_config(ARCH)).with_overrides(**dict(over, dtype=tdt),
                                                         kernels="plain")
    jp = jax_init_params(jax.random.PRNGKey(0), JT.model_layout(jcfg))
    rng = np.random.default_rng(1)
    if gates:
        for blk in jp["blocks"].values():
            if "xattn_gate" in blk:
                g = blk["xattn_gate"]["gate"]
                blk["xattn_gate"]["gate"] = jnp.asarray(rng.uniform(0.5, 1.5, g.shape), g.dtype)
            attn = blk["attn"]
            for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
                if name in attn:
                    a = attn[name]
                    val = (rng.normal(size=a.shape) * 0.5 if name[0] == "b"
                           else rng.uniform(0.5, 1.5, a.shape))
                    attn[name] = jnp.asarray(val, a.dtype)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def vision(cfg, b, seed, jdt):
    a = np.random.default_rng(seed).normal(size=(b, cfg.vision_tokens, cfg.d_model))
    return both(a, jdt)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def check_greedy(got, want):
    """bf16: the greedy token wherever JAX's top-2 margin is wider than
    one bf16 ulp of its top logit (tests/test_torch_transformer.py);
    returns the number compared."""
    got, want = _np(got), _np(want)
    compared = 0
    for g, w in zip(got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])):
        top2 = np.sort(w)[-2:]
        if top2[1] - top2[0] <= bf16_ulp(top2[1]):
            continue
        compared += 1
        assert g.argmax() == w.argmax()
    return compared


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_layout_and_cache_layout_match_jax(variant):
    """Every parameter and cache leaf, shape and dtype: the cross block
    has ``xattn_gate.gate`` (fp32, one a group), keeps q_norm/k_norm and
    drops the qkv biases; its cache holds the vision K/V."""
    jcfg, tcfg, _, _ = build("bf16", variant, gates=False)
    jl, tl = _flat(JT.model_layout(jcfg)), _flat(T.model_layout(tcfg))
    assert jl.keys() == tl.keys()
    for key, spec in jl.items():
        assert tuple(tl[key].shape) == tuple(spec.shape), key
        assert _dtype_name(tl[key].dtype) == jnp.dtype(spec.dtype).name, key
    assert tl["blocks", CROSS, "xattn_gate", "gate"].dtype == torch.float32
    assert tl["blocks", CROSS, "xattn_gate", "gate"].init == "zeros"
    assert not any(k[-1] in ("bq", "bk", "bv") for k in tl if k[1] == CROSS)
    if variant == "qkv_bias":
        assert ("blocks", "block0", "attn", "bq") in tl
    if variant == "qk_norm":
        assert ("blocks", CROSS, "attn", "q_norm") in tl
    jc, tc = _flat(JT.cache_layout(jcfg, 3, 24)), _flat(T.cache_layout(tcfg, 3, 24))
    assert jc.keys() == tc.keys()
    for key, s in jc.items():
        assert tuple(tc[key].shape) == tuple(s.shape), key
        assert _dtype_name(tc[key].dtype) == jnp.dtype(s.dtype).name, key
    assert tuple(tc[CROSS, "k"].shape) == (2, 3, tcfg.vision_tokens, 2, 16)


def test_init_gives_zero_gates():
    _, tcfg, _, _ = build(gates=False)
    tp = init_params(T.model_layout(tcfg), seed=0, device="cpu")
    assert torch.equal(tp["blocks"][CROSS]["xattn_gate"]["gate"], torch.zeros(2, 1))


# ---------------------------------------------------------------------------
# _cross_attn, forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["dense", "chunked", "flash"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cross_attn_fresh_and_cached_match_jax(variant, impl):
    """The block alone, group 0's weights, fp32: fresh embeds (projected,
    then k_norm) and the K/V they give read back as a cache."""
    jcfg, tcfg, jp, tp = build("f32", variant)
    rng = np.random.default_rng(3)
    jx, tx = both(rng.normal(size=(2, 5, jcfg.d_model)), jnp.float32)
    jv, tv = vision(jcfg, 2, 4, jnp.float32)
    jblk = jax.tree.map(lambda a: a[0], jp["blocks"][CROSS])
    tblk = T._group(tp["blocks"], 0)[CROSS]
    jimpl = "chunked" if impl == "chunked" else "dense"
    jout, jkv = JT._cross_attn(jblk["attn"], jblk["xattn_gate"], jx, jcfg,
                               vision_embeds=jv, attn_impl=jimpl)
    tout, tkv = T._cross_attn(tblk["attn"], tblk["xattn_gate"], tx, tcfg,
                              vision_embeds=tv, attn_impl=impl)
    np.testing.assert_allclose(_np(tout), _np(jout), atol=FP32_ATOL, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tkv[k]), _np(jkv[k]), atol=FP32_ATOL, rtol=0)
    jout2, _ = JT._cross_attn(jblk["attn"], jblk["xattn_gate"], jx, jcfg, vision_kv=jkv,
                              attn_impl=jimpl)
    tout2, tkv2 = T._cross_attn(tblk["attn"], tblk["xattn_gate"], tx, tcfg, vision_kv=tkv,
                                attn_impl=impl)
    np.testing.assert_allclose(_np(tout2), _np(jout2), atol=FP32_ATOL, rtol=0)
    assert tkv2["k"] is tkv["k"]  # cached K/V read as they are, no norm again
    assert float(np.abs(_np(tout)).max()) > 1e-3  # the gate lets the block through


@cache
def _jax_forward(jcfg):
    return jax.jit(lambda p, t, ve: JT.forward(p, jcfg, tokens=t, vision_embeds=ve,
                                               attn_impl="dense", remat=False),
                   compiler_options=EXACT_BF16)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_fp32_matches_jax(variant):
    jcfg, tcfg, jp, tp = build("f32", variant)
    jt, tt = both(np.random.default_rng(5).integers(1, jcfg.vocab_size, (2, 9)), jnp.int32)
    jv, tv = vision(jcfg, 2, 6, jnp.float32)
    jl, _, _ = _jax_forward(jcfg)(jp, jt, jv)
    for impl in ("dense", "chunked", "flash"):
        tl, _, _ = T.forward(tp, tcfg, tokens=tt, vision_embeds=tv, attn_impl=impl)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=FP32_ATOL, rtol=0, err_msg=impl)


def test_forward_bf16_greedy_matches_jax():
    """bf16 weights and embeds: the greedy token at every decided
    position of 2 x 12."""
    jcfg, tcfg, jp, tp = build("bf16")
    jt, tt = both(np.random.default_rng(7).integers(1, jcfg.vocab_size, (2, 12)), jnp.int32)
    jv, tv = vision(jcfg, 2, 8, jnp.bfloat16)
    jl, _, _ = _jax_forward(jcfg)(jp, jt, jv)
    tl, _, _ = T.forward(tp, tcfg, tokens=tt, vision_embeds=tv)
    assert check_greedy(tl, jl) >= 18


def test_bf16_vision_embeds_promote_in_an_fp32_model():
    """The JAX zoo tests feed bf16 vision embeds: jnp.einsum promotes
    them against fp32 weights to fp32, and so does the port."""
    jcfg, tcfg, jp, tp = build("f32")
    jt, tt = both(np.random.default_rng(9).integers(1, jcfg.vocab_size, (2, 6)), jnp.int32)
    jv, tv = vision(jcfg, 2, 10, jnp.bfloat16)
    assert tv.dtype == torch.bfloat16
    jl, jkv, _ = jax.jit(lambda p, t, ve: JT.forward(p, jcfg, tokens=t, vision_embeds=ve,
                                                     collect_kv=True, remat=False))(jp, jt, jv)
    tl, tkv, _ = T.forward(tp, tcfg, tokens=tt, vision_embeds=tv, collect_kv=True)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=FP32_ATOL, rtol=0)
    assert tkv[CROSS]["k"].dtype == torch.float32 and jkv[CROSS]["k"].dtype == jnp.float32


def test_zero_gate_makes_the_vision_input_irrelevant():
    """With the gates ``init_params`` gives (zeros), two different vision
    inputs give the same logits bitwise, on both sides: why every other
    test sets the gates."""
    jcfg, tcfg, jp, tp = build("f32", gates=False)
    jt, tt = both(np.random.default_rng(11).integers(1, jcfg.vocab_size, (2, 6)), jnp.int32)
    outs = []
    for seed in (12, 13):
        jv, tv = vision(jcfg, 2, seed, jnp.float32)
        outs.append((_np(_jax_forward(jcfg)(jp, jt, jv)[0]),
                     _np(T.forward(tp, tcfg, tokens=tt, vision_embeds=tv)[0])))
    assert np.array_equal(outs[0][0], outs[1][0])
    assert np.array_equal(outs[0][1], outs[1][1])
    _, _, jg, tg = build("f32")
    jv, tv = vision(jcfg, 2, 12, jnp.float32)
    gated = _np(T.forward(tg, tcfg, tokens=tt, vision_embeds=tv)[0])
    assert not np.array_equal(gated, outs[0][1])


def test_collect_kv_pads_only_self_attention_kv():
    """``forward(collect_kv, cache_pad_to)``: the reference pads every
    5-d leaf shorter than ``cache_pad_to`` along axis 2, the cross
    block's vision K/V too (32 rows where ``cache_layout`` has 16: a
    fault of the reference, ROADMAP C); the port pads the self-attention
    K/V only, by block plan, and the vision K/V keep their 16 rows."""
    jcfg, tcfg, jp, tp = build("f32")
    jt, tt = both(np.random.default_rng(14).integers(1, jcfg.vocab_size, (2, 8)), jnp.int32)
    jv, tv = vision(jcfg, 2, 15, jnp.float32)
    _, jkv, _ = JT.forward(jp, jcfg, tokens=jt, vision_embeds=jv, collect_kv=True,
                           cache_pad_to=32, remat=False)
    _, tkv, _ = T.forward(tp, tcfg, tokens=tt, vision_embeds=tv, collect_kv=True,
                          cache_pad_to=32)
    layout = T.cache_layout(tcfg, 2, 32)
    assert jkv[CROSS]["k"].shape == (2, 2, 32, 2, 16)  # the reference's padded vision K/V
    assert tuple(tkv[CROSS]["k"].shape) == tuple(layout[CROSS]["k"].shape) == (2, 2, 16, 2, 16)
    np.testing.assert_allclose(_np(tkv[CROSS]["v"]), _np(jkv[CROSS]["v"])[:, :, :16],
                               atol=FP32_ATOL, rtol=0)
    assert not _np(jkv[CROSS]["v"])[:, :, 16:].any()  # zero keys past the vision tokens
    for name in ("block0", "block3"):
        assert tuple(tkv[name]["k"].shape) == jkv[name]["k"].shape == (2, 2, 32, 2, 16)
        np.testing.assert_allclose(_np(tkv[name]["k"]), _np(jkv[name]["k"]),
                                   atol=FP32_ATOL, rtol=0)


def test_cross_attention_without_vision_input_raises():
    _, tcfg, _, tp = build("f32")
    with pytest.raises(ValueError, match="vision_embeds"):
        T.forward(tp, tcfg, tokens=torch.ones((1, 3), dtype=torch.long))


# ---------------------------------------------------------------------------
# prefill_step, decode_step
# ---------------------------------------------------------------------------


@cache
def jax_steps(jcfg):
    """The JAX prefill and decode steps, jitted once per config (the
    tests of a config share the compiled shapes)."""
    chunk = jax.jit(lambda p, c, t, ve, pos, at, impl: JT.prefill_step(
        p, c, jcfg, tokens=t, pos=pos, vision_embeds=ve, attn_impl=impl, logits_at=at),
        static_argnums=(4, 5, 6), compiler_options=EXACT_BF16)
    decode = jax.jit(lambda p, c, t, n: JT.decode_step(
        p, c, jcfg, tokens=t, lengths=n, attn_impl="dense", kernels="xla"),
        compiler_options=EXACT_BF16)
    return chunk, decode


def _serve_steps(dtype, variant, impl, check):
    """A prefill chunk at pos 0 with fresh vision embeds, a ragged chunk
    at 8 without them (read at ``logits_at``), then three ragged decode
    steps, on both sides; ``check(port, jax)`` on each step's logits.
    Returns the two final caches."""
    jdt = DTYPES[dtype][0]
    jcfg, tcfg, jp, tp = build(dtype, variant)
    jchunk, jdecode = jax_steps(jcfg)
    jimpl = "chunked" if impl == "chunked" else "dense"
    rng = np.random.default_rng(16)
    b, max_len = 3, 24
    jc = JT.init_cache(jcfg, b, max_len)
    tc = T.init_cache(tcfg, b, max_len, device="cpu")
    jv, tv = vision(jcfg, b, 17, jdt)
    for pos, width, at, fresh in ((0, 8, None, True), (8, 8, 4, False)):
        jt, tt = both(rng.integers(1, jcfg.vocab_size, (b, width)), jnp.int32)
        jl, jc = jchunk(jp, jc, jt, jv if fresh else None, pos, at, jimpl)
        tl, tc = T.prefill_step(tp, tc, tcfg, tokens=tt, pos=pos, logits_at=at,
                                vision_embeds=tv if fresh else None, attn_impl=impl)
        check(tl, jl)
    lengths = np.array([13, 7, 0], np.int32)
    for _ in range(3):
        jt, tt = both(rng.integers(1, jcfg.vocab_size, (b,)), jnp.int32)
        jl, jc = jdecode(jp, jc, jt, jnp.asarray(lengths))
        tl, tc = T.decode_step(tp, tc, tcfg, tokens=tt, lengths=torch.as_tensor(lengths),
                               attn_impl=impl)
        check(tl, jl)
        lengths = lengths + 1
    return tc, jc


@pytest.mark.parametrize("impl", ["dense", "chunked", "flash"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_fp32_match_jax(variant, impl):
    """Logits of every step, then every cache leaf -- the vision K/V that
    the first chunk wrote among them -- agree with the JAX package's."""
    tc, jc = _serve_steps("f32", variant, impl, lambda t, j: np.testing.assert_allclose(
        _np(t), _np(j), atol=FP32_ATOL, rtol=0))
    for name, blk in jc.items():
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(tc[name][k]), _np(blk[k]), atol=FP32_ATOL, rtol=0,
                                       err_msg=f"{name}.{k}")
    assert np.abs(_np(tc[CROSS]["k"])).max() > 0  # the first chunk wrote the vision K/V


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_prefill_and_decode_bf16_greedy_match_jax(impl):
    compared = [0]

    def check(t, j):
        compared[0] += check_greedy(t, j)

    _serve_steps("bf16", "base", impl, check)
    assert compared[0] >= 10


def test_decode_step_leaves_vision_kv_untouched():
    """A decode step reads the cache's vision K/V and writes none: the
    leaves keep their bits (random values put there)."""
    _, tcfg, _, tp = build("f32")
    cache = T.init_cache(tcfg, 2, 16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for k in ("k", "v"):
        cache[CROSS][k].copy_(torch.randn(cache[CROSS][k].shape, generator=gen))
    before = {k: cache[CROSS][k].clone() for k in ("k", "v")}
    T.decode_step(tp, cache, tcfg, tokens=torch.tensor([3, 4]),
                  lengths=torch.tensor([2, 5], dtype=torch.int32))
    for k in ("k", "v"):
        assert torch.equal(cache[CROSS][k], before[k])
    assert cache["block0"]["k"][:, 0, 2].abs().sum() > 0  # the step wrote its rows


# ---------------------------------------------------------------------------
# Serving: the engines against the JAX Engine (no vision embeds)
# ---------------------------------------------------------------------------

LAYERS = 20  # 4 layer groups: the interleaved Future needs 4 cells
_PROMPTS6 = [[5, 9, 2, 7, 11], [3, 1, 4], [2] * 6, [8, 8], [1, 2, 3, 4], [7]]
# tests/test_serve.py's StreamEngine workloads: name -> (ServeConfig
# kwargs, pipeline kwargs, prompts, budgets)
WORKLOADS = {
    "greedy": (dict(max_batch=4, max_len=64, prefill_chunk=4, max_new_tokens=6),
               dict(num_cells=4, microbatches=2, round_steps=4, admit_per_round=3),
               _PROMPTS6, [6, 3, 5, 1, 6, 4]),
    "temperature": (dict(max_batch=2, max_len=64, prefill_chunk=4, max_new_tokens=5,
                         temperature=0.9, seed=11),
                    dict(num_cells=2, microbatches=2, round_steps=3, admit_per_round=2),
                    [[5, 9, 2], [4, 4], [1, 2, 3]], [None] * 3),
}
EVALUATORS = {
    "lazy": (None, {}),
    "future_gpipe": (2, dict(schedule="gpipe")),
    "future_interleaved": (2, dict(schedule="interleaved", interleave=2, num_cells=4)),
}
_MODELS: dict = {}
_JAX: dict = {}


def models(dtype):
    if dtype not in _MODELS:
        _MODELS[dtype] = build(dtype, num_layers=LAYERS)
    return _MODELS[dtype]


def _serve(eng, prompts, budgets):
    reqs = [eng.submit(np.array(p), b) for p, b in zip(prompts, budgets)]
    done = eng.run_until_drained()
    assert len(done) == len(reqs) and all(r.done and r.status == "ok" for r in reqs)
    return [r.out_tokens for r in reqs]


@cache
def _engine_steps(jcfg):
    """The JAX Engine's prefill and decode, jitted once per config: both
    workloads' oracles share the compiled shapes."""
    return (jax.jit(partial(JT.prefill_step, cfg=jcfg, attn_impl="dense"),
                    compiler_options=EXACT_BF16),
            jax.jit(partial(JT.decode_step, cfg=jcfg, attn_impl="dense"),
                    compiler_options=EXACT_BF16))


def jax_tokens(dtype, workload):
    key = (dtype, workload)
    if key not in _JAX:
        jcfg, _, jp, _ = models(dtype)
        serve, _, prompts, budgets = WORKLOADS[workload]
        eng = JaxEngine(jp, jcfg, JaxServeConfig(**serve))
        eng._prefill, eng._decode = _engine_steps(jcfg)
        _JAX[key] = _serve(eng, prompts, budgets)
    return _JAX[key]


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_engine_matches_jax(dtype, workload):
    _, tcfg, _, tp = models(dtype)
    serve, _, prompts, budgets = WORKLOADS[workload]
    eng = Engine(tp, tcfg, ServeConfig(**serve), device="cpu")
    assert _serve(eng, prompts, budgets) == jax_tokens(dtype, workload)
    assert eng.decode_steps > 0


@pytest.mark.parametrize("evaluator", sorted(EVALUATORS))
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_stream_engine_matches_jax(dtype, workload, evaluator):
    _, tcfg, _, tp = models(dtype)
    serve, pipe, prompts, budgets = WORKLOADS[workload]
    stages, over = EVALUATORS[evaluator]
    eng = StreamEngine(tp, tcfg, ServeConfig(**serve), DecodePipelineConfig(**{**pipe, **over}),
                       stages=stages, device="cpu")
    assert _serve(eng, prompts, budgets) == jax_tokens(dtype, workload)


def test_stream_round_leaves_vision_kv_untouched():
    """Random vision K/V put into every slot after the first round's
    admissions: the next round (no admission) decodes every slot and
    leaves those bits as they were."""
    _, tcfg, _, tp = models("f32")
    serve, pipe, prompts, _ = WORKLOADS["greedy"]
    eng = StreamEngine(tp, tcfg, ServeConfig(**dict(serve, max_new_tokens=20)),
                       DecodePipelineConfig(**dict(pipe, admit_per_round=4)), stages=2,
                       device="cpu")
    for p in prompts[:4]:
        eng.submit(np.array(p))
    eng.step()
    assert not eng.queue and all(r is not None for r in eng.active)
    gen = torch.Generator().manual_seed(1)
    cache = eng.cache
    for k in ("k", "v"):
        cache[CROSS][k].copy_(torch.randn(cache[CROSS][k].shape, generator=gen))
    before = {k: cache[CROSS][k].clone() for k in ("k", "v")}
    rows_before = eng.cache["block0"]["k"].clone()
    eng.step()
    for k in ("k", "v"):
        assert torch.equal(eng.cache[CROSS][k], before[k])
    assert not torch.equal(eng.cache["block0"]["k"], rows_before)


@pytest.mark.parametrize("engine", ["sequential", "stream"])
def test_supervised_raise_loses_nothing(engine):
    """``raise@2`` under ``ServeSupervisor``: no request lost, one
    restart, the unsupervised tokens (which are the JAX Engine's)."""
    _, tcfg, _, tp = models("f32")
    serve, pipe, prompts, budgets = WORKLOADS["greedy"]

    def make():
        if engine == "sequential":
            return Engine(tp, tcfg, ServeConfig(**serve), device="cpu")
        return StreamEngine(tp, tcfg, ServeConfig(**serve), DecodePipelineConfig(**pipe),
                            stages=2, device="cpu")

    want = jax_tokens("f32", "greedy")
    assert _serve(make(), prompts, budgets) == want
    sup = ServeSupervisor(make(), fail_injector=chaos_injector("raise", 2))
    reqs = [sup.submit(np.array(p), b) for p, b in zip(prompts, budgets)]
    sup.run_until_drained()
    assert sup.stats["requests_lost"] == 0 and sup.stats["restarts"] == 1, sup.stats
    assert [r.out_tokens for r in reqs] == want


@pytest.mark.parametrize("row_scatter", [True, False])
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_decode_copy_bytes_per_tick_equals_jax(size, row_scatter):
    """The decode cells never write vision K/V: the row set leaves the
    cross blocks out, as the reference's does (the slab scheme keeps
    them)."""
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    if size == "smoke":
        jcfg, tcfg = jax_smoke_config(jcfg), smoke_config(tcfg)
    for mb, cells in ((1, 1), (2, 2), (4, 1)):
        got = decode_copy_bytes_per_tick(tcfg, mb, cells, row_scatter=row_scatter, max_len=64)
        assert got == jax_copy_bytes(jcfg, mb, cells, row_scatter=row_scatter, max_len=64)
    if row_scatter:
        every_leaf = sum(t.numel() * t.element_size()
                         for blk in T.cache_layout(tcfg, 1, 1).values() for t in blk.values())
        assert decode_copy_bytes_per_tick(tcfg, 1, 1) < every_leaf
