"""Embedding inputs (musicgen-medium) in repro_torch against the JAX
package on the CPU.

An embedding-input arch takes ``embeds`` -- precomputed frame
embeddings, its frontend being a stub -- where the others take tokens:
``(B, S, d)`` in ``forward`` and ``prefill_step``, ``(B, 1, d)`` in
``decode_step``, cast to the model's dtype.  The musicgen smoke config
on the weights the numpy bridge carries over, with embeddings made with
numpy in fp32 (as the JAX zoo tests feed them), in an fp32 and a bf16
model.  The JAX engines serve token-input archs only, and so do the
port's: they refuse with the reason, and the CLI exits as the
reference's does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.models.params import init_params as jax_init_params
from repro_torch.configs.base import DecodePipelineConfig
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.engine import Engine, ServeConfig, StreamEngine

ARCH = "musicgen-medium"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
EXACT_BF16 = {"xla_allow_excess_precision": False}
# fp32: the same ops, sums in another order (tests/test_torch_transformer.py)
FP32_ATOL = 2e-5


def bf16_ulp(x) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(x))) - 7))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def build(dtype):
    jdt, tdt = DTYPES[dtype]
    jcfg = jax_smoke_config(jax_get_config(ARCH)).with_overrides(dtype=jdt)
    tcfg = smoke_config(get_config(ARCH)).with_overrides(dtype=tdt, kernels="plain")
    jp = jax_init_params(jax.random.PRNGKey(0), JT.model_layout(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def frames(cfg, shape, seed):
    """fp32 frame embeddings, on both sides."""
    a = np.random.default_rng(seed).normal(size=shape + (cfg.d_model,)).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def check(got, want, dtype):
    """fp32: ``FP32_ATOL``.  bf16: the greedy token wherever JAX's top-2
    margin is wider than one bf16 ulp of its top logit
    (tests/test_torch_transformer.py); returns the number compared."""
    got, want = _np(got), _np(want)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)
        return 0
    compared = 0
    for g, w in zip(got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])):
        top2 = np.sort(w)[-2:]
        if top2[1] - top2[0] <= bf16_ulp(top2[1]):
            continue
        compared += 1
        assert g.argmax() == w.argmax()
    return compared


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def test_layout_and_cache_layout_match_jax():
    """The embedding table stays in the layout (the reference keeps it:
    the weight bridge carries every leaf); an untied head."""
    jcfg, tcfg, _, _ = build("bf16")
    assert _shapes(T.model_layout(tcfg)) == _shapes(JT.model_layout(jcfg))
    assert _shapes(T.cache_layout(tcfg, 2, 16)) == _shapes(JT.cache_layout(jcfg, 2, 16))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_matches_jax(dtype):
    jcfg, tcfg, jp, tp = build(dtype)
    je, te = frames(jcfg, (2, 12), 1)
    jl, _, _ = jax.jit(lambda p, e: JT.forward(p, jcfg, embeds=e, attn_impl="dense",
                                                remat=False),
                       compiler_options=EXACT_BF16)(jp, je)
    for impl in ("dense", "chunked", "flash"):
        tl, _, _ = T.forward(tp, tcfg, embeds=te, attn_impl=impl)
        assert tl.shape == (2, 12, tcfg.vocab_size)
        assert check(tl, jl, dtype) >= 18 or dtype == "f32"
    assert torch.equal(T.Transformer(tcfg, tp)(embeds=te), T.forward(tp, tcfg, embeds=te)[0])


@pytest.mark.parametrize("impl", ["dense", "chunked", "flash"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_and_decode_match_jax(dtype, impl):
    """Two 8-frame prefill chunks (the second a ragged tail read at
    ``logits_at``), then three ragged decode steps of one frame a row:
    logits agree, and in fp32 every cache leaf."""
    jcfg, tcfg, jp, tp = build(dtype)
    jimpl = "chunked" if impl == "chunked" else "dense"
    chunk = jax.jit(lambda p, c, e, pos, at: JT.prefill_step(
        p, c, jcfg, embeds=e, pos=pos, attn_impl=jimpl, logits_at=at),
        static_argnums=(3, 4), compiler_options=EXACT_BF16)
    decode = jax.jit(lambda p, c, e, n: JT.decode_step(
        p, c, jcfg, embeds=e, lengths=n, attn_impl="dense", kernels="xla"),
        compiler_options=EXACT_BF16)
    b, max_len = 3, 24
    jc = JT.init_cache(jcfg, b, max_len)
    tc = T.init_cache(tcfg, b, max_len, device="cpu")
    compared = 0
    for i, (pos, at) in enumerate(((0, None), (8, 4))):
        je, te = frames(jcfg, (b, 8), 2 + i)
        jl, jc = chunk(jp, jc, je, pos, at)
        tl, tc = T.prefill_step(tp, tc, tcfg, embeds=te, pos=pos, logits_at=at, attn_impl=impl)
        compared += check(tl, jl, dtype)
    lengths = np.array([13, 7, 0], np.int32)
    for i in range(3):
        je, te = frames(jcfg, (b, 1), 4 + i)
        jl, jc = decode(jp, jc, je, jnp.asarray(lengths))
        tl, tc = T.decode_step(tp, tc, tcfg, embeds=te, lengths=torch.as_tensor(lengths),
                               attn_impl=impl)
        compared += check(tl, jl, dtype)
        lengths = lengths + 1
    if dtype == "f32":
        for name, blk in jc.items():
            for k in ("k", "v"):
                np.testing.assert_allclose(_np(tc[name][k]), _np(blk[k]), atol=FP32_ATOL, rtol=0)
    else:
        assert compared >= 10


def test_decode_step_takes_its_device_from_the_embeds():
    """No tokens are given: the mode resolves on the embeddings' device
    (a CPU tensor under ``kernels="cuda"`` is refused for that device),
    and the default lengths are made there."""
    _, tcfg, _, tp = build("f32")
    cache = T.init_cache(tcfg, 2, 8, device="cpu")
    e = torch.randn(2, 1, tcfg.d_model)
    with pytest.raises(ValueError, match="needs tensors on a CUDA device, not cpu"):
        T.decode_step(tp, cache, tcfg, embeds=e, kernels="cuda")
    lg, _ = T.decode_step(tp, cache, tcfg, embeds=e)
    assert lg.shape == (2, tcfg.vocab_size) and bool(torch.isfinite(lg).all())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_strided_embeds_reach_the_blocks_contiguous(dtype):
    """A window of a longer frame sequence is a strided view; the blocks
    get a contiguous input (the RMSNorm kernel refuses any other), with
    the same logits as a contiguous copy gives."""
    _, tcfg, _, tp = build(dtype)
    frames = torch.randn(2, 20, tcfg.d_model)
    window = frames[:, 4:12]
    assert not window.is_contiguous()
    x = T._embed_input(tp, tcfg, embeds=window)
    assert x.is_contiguous() and x.dtype == tcfg.dtype
    assert torch.equal(T.forward(tp, tcfg, embeds=window)[0],
                       T.forward(tp, tcfg, embeds=window.contiguous())[0])


def test_tokens_are_refused():
    _, tcfg, _, tp = build("f32")
    with pytest.raises(ValueError, match="takes embeddings"):
        T.forward(tp, tcfg, tokens=torch.ones((1, 4), dtype=torch.long))


@pytest.mark.parametrize("engine", ["sequential", "stream"])
def test_engines_refuse_with_the_reason(engine):
    _, tcfg, _, tp = build("f32")
    with pytest.raises(ValueError, match="takes embeddings.*token-input archs"):
        if engine == "sequential":
            Engine(tp, tcfg, ServeConfig(max_batch=2, max_len=32), device="cpu")
        else:
            StreamEngine(tp, tcfg, ServeConfig(max_batch=2, max_len=32),
                         DecodePipelineConfig(num_cells=2, microbatches=1), device="cpu")


def test_cli_exits_naming_the_frontend_stub():
    with pytest.raises(SystemExit, match="embedding frontend stub"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
