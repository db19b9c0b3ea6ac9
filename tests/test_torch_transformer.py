"""repro_torch.models.transformer against the JAX package on the CPU.

Smoke configs of the four attention-only archs: olmo-1b (non-parametric
layernorm, tied head), qwen1.5-4b (qkv bias), qwen3-32b (qk-norm, GQA)
and internlm2-20b (GQA).  Both sides run on identical weights (the
numpy weight bridge) and identical token inputs made with numpy.
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
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.params import params_from_numpy

ARCHS = ["olmo-1b", "qwen1.5-4b", "qwen3-32b", "internlm2-20b"]

# fp32: both sides run the same ops in fp32; matmuls and softmax reduce
# in another order in each framework, a few fp32 ulps per op through ~10
# ops of depth on logits of magnitude < 1.
FP32_ATOL = 2e-5
# bf16: by default XLA's CPU compiler keeps some bf16 intermediates at
# fp32 inside a fusion (excess precision), where PyTorch rounds every
# op's output to bf16.  The JAX steps here are compiled with
# xla_allow_excess_precision off, so both sides round at the same
# places; what is left is the order of fp32 sums, which moves a bf16
# rounding by one ulp now and then.  The greedy token is compared
# wherever the JAX top-2 margin is wider than one bf16 ulp of the top
# logit, i.e. wherever the two top logits are not the same or
# neighbouring bf16 values.
EXACT_BF16 = {"xla_allow_excess_precision": False}


def bf16_ulp(x) -> float:
    """One bf16 ulp at |x| (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(np.abs(x))) - 7))


def build(arch, dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = jax_smoke_config(jax_get_config(arch)).with_overrides(dtype=jdt)
    tcfg = smoke_config(get_config(arch)).with_overrides(dtype=tdt, kernels="plain")
    jp = jax_init_params(jax.random.PRNGKey(0), JT.model_layout(jcfg))
    # qkv biases are zero-initialised: give them values so they matter
    rng = np.random.default_rng(1)
    for blk in jp["blocks"].values():
        for name in ("bq", "bk", "bv"):
            if name in blk["attn"]:
                shape = blk["attn"][name].shape
                blk["attn"][name] = jnp.asarray(rng.normal(size=shape) * 0.5, jdt)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def jax_steps(jcfg):
    """Jitted JAX prefill/decode: one compile per shape, not per call."""
    chunk = jax.jit(lambda p, c, t, pos, at: JT.prefill_step(
        p, c, jcfg, tokens=t, pos=pos, attn_impl="dense", logits_at=at),
        static_argnums=(3, 4), compiler_options=EXACT_BF16)
    decode = jax.jit(lambda p, c, t, n: JT.decode_step(
        p, c, jcfg, tokens=t, lengths=n, kernels="xla"),
        compiler_options=EXACT_BF16)
    return chunk, decode


def to_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def cache_np(c):
    return {b: {k: v.float().numpy() for k, v in blk.items()} for b, blk in c.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_fp32(arch):
    """Two prefill chunks (the second a padded ragged tail read at
    logits_at) then ragged decode steps: logits and caches agree."""
    jcfg, tcfg, jp, tp = build(arch, "f32")
    jchunk, jdecode = jax_steps(jcfg)
    rng = np.random.default_rng(2)
    b, max_len = 3, 24
    jc = JT.init_cache(jcfg, b, max_len)
    tc = T.init_cache(tcfg, b, max_len, device="cpu")
    for pos, width, at in ((0, 8, None), (8, 8, 4)):
        toks = rng.integers(1, jcfg.vocab_size, size=(b, width))
        jl, jc = jchunk(jp, jc, jnp.asarray(toks), pos, at)
        tl, tc = T.prefill_step(tp, tc, tcfg, tokens=torch.as_tensor(toks), pos=pos,
                                logits_at=at)
        np.testing.assert_allclose(tl.numpy(), to_np(jl), atol=FP32_ATOL, rtol=0)
    lengths = np.array([13, 7, 0], np.int32)  # ragged, incl. a fresh row
    for _ in range(3):
        toks = rng.integers(1, jcfg.vocab_size, size=(b,))
        jl, jc = jdecode(jp, jc, jnp.asarray(toks), jnp.asarray(lengths))
        tl, tc = T.decode_step(tp, tc, tcfg, tokens=torch.as_tensor(toks),
                               lengths=torch.as_tensor(lengths))
        np.testing.assert_allclose(tl.numpy(), to_np(jl), atol=FP32_ATOL, rtol=0)
        lengths = lengths + 1
    tcn = cache_np(tc)
    for name, blk in jc.items():
        for k in ("k", "v"):
            np.testing.assert_allclose(tcn[name][k], to_np(blk[k]), atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_bf16(arch):
    """16 teacher-forced greedy decode steps at bf16 (the JAX tokens fed
    to both sides): argmax equal except where JAX's top-2 margin is
    at most one bf16 ulp -- those positions are listed."""
    jcfg, tcfg, jp, tp = build(arch, "bf16")
    jchunk, jdecode = jax_steps(jcfg)
    rng = np.random.default_rng(3)
    b, max_len = 4, 32
    jc = JT.init_cache(jcfg, b, max_len)
    tc = T.init_cache(tcfg, b, max_len, device="cpu")
    toks = rng.integers(1, jcfg.vocab_size, size=(b, 8))
    jl, jc = jchunk(jp, jc, jnp.asarray(toks), 0, None)
    tl, tc = T.prefill_step(tp, tc, tcfg, tokens=torch.as_tensor(toks), pos=0)
    lengths = np.array([8, 8, 5, 2], np.int32)
    exempt, compared = [], 0
    for step in range(17):
        jn, tn = to_np(jl), tl.numpy()
        for row in range(b):
            top2 = np.sort(jn[row])[-2:]
            margin, ulp = top2[1] - top2[0], bf16_ulp(top2[1])
            if margin <= ulp:
                exempt.append((step, row, margin / ulp))
                continue
            compared += 1
            assert tn[row].argmax() == jn[row].argmax(), (step, row, margin / ulp)
        if step == 16:
            break
        nxt = jn.argmax(-1).astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(nxt), jnp.asarray(lengths))
        tl, tc = T.decode_step(tp, tc, tcfg, tokens=torch.as_tensor(nxt),
                               lengths=torch.as_tensor(lengths))
        lengths = lengths + 1
    print(f"{arch}: {compared} compared, exempt (step, row, margin/ulp): {exempt}")
    assert compared >= 0.75 * b * 17, exempt


def test_forward_matches_jax_and_collects_kv():
    jcfg, tcfg, jp, tp = build("qwen3-32b", "f32")
    toks = np.random.default_rng(4).integers(1, jcfg.vocab_size, size=(2, 6))
    jl, jkv, _ = JT.forward(jp, jcfg, tokens=jnp.asarray(toks), attn_impl="dense",
                            collect_kv=True, cache_pad_to=10)
    tl, tkv, aux = T.forward(tp, tcfg, tokens=torch.as_tensor(toks), collect_kv=True,
                             cache_pad_to=10)
    np.testing.assert_allclose(tl.numpy(), to_np(jl), atol=FP32_ATOL, rtol=0)
    tkvn = cache_np(tkv)
    for name, blk in jkv.items():
        for k in ("k", "v"):
            assert tkvn[name][k].shape == blk[k].shape
            np.testing.assert_allclose(tkvn[name][k], to_np(blk[k]), atol=FP32_ATOL, rtol=0)
    assert set(aux) == {"moe_lb_loss", "moe_z_loss", "moe_drop_fraction"}


def test_module_owns_the_tree():
    """The thin nn.Module holds the same tensors under the same keys and
    runs the same forward."""
    _, tcfg, _, tp = build("qwen3-32b", "f32")
    model = T.Transformer(tcfg, tp)
    back = model.params
    assert back.keys() == tp.keys()
    assert back["blocks"]["block0"]["attn"]["wq"].data_ptr() == tp["blocks"]["block0"]["attn"]["wq"].data_ptr()
    assert "tree.blocks.block0.attn.wq" in model.state_dict()
    assert not any(p.requires_grad for p in model.parameters())
    toks = torch.as_tensor(np.random.default_rng(5).integers(1, tcfg.vocab_size, size=(2, 5)))
    assert torch.equal(model(toks), T.forward(tp, tcfg, tokens=toks)[0])


def test_prefill_past_cache_end_raises():
    """The JAX package's dynamic_update_slice clamps the offset; the
    port's in-place write raises instead."""
    _, tcfg, _, tp = build("olmo-1b", "f32")
    tc = T.init_cache(tcfg, 1, 10, device="cpu")
    with pytest.raises(ValueError, match="overruns"):
        T.prefill_step(tp, tc, tcfg, tokens=torch.ones((1, 4), dtype=torch.long), pos=8)


def test_block_plans_match_jax():
    from repro.configs.registry import ARCH_IDS
    for arch in ARCH_IDS:
        jplans = JT.block_plans(jax_get_config(arch))
        tplans = T.block_plans(get_config(arch))
        assert [(p.mixer, p.ffn) for p in jplans] == [(p.mixer, p.ffn) for p in tplans]
        assert JT.effective_period(jax_get_config(arch)) == T.effective_period(get_config(arch))
