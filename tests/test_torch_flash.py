"""The port's prompt path against the JAX package on the CPU: the flash
kernel's plain version, ``attention_chunked``, ``forward`` and the
``Engine`` under ``attn_impl="flash"`` and ``"chunked"``, and the
dispatch of the three implementations.

Inputs are made with numpy from a seed and fed to both sides.  The JAX
Pallas kernel runs in interpret mode and is an oracle only where it
keeps the contract of ``layers.attention``: queries from position 0 and
every key valid.  Under ``q_offset`` and ``kv_len`` the port is held
against JAX's ``attention_dense`` instead.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_bhsd as jax_flash_bhsd
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch import kernels as K
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine, ServeConfig
from test_torch_engine import WORKLOAD, _models, _workload

EXACT_BF16 = {"xla_allow_excess_precision": False}

# The cases of tests/test_kernels.py (b, h, kv, sq, sk, dh, causal,
# dtype, tol): JAX's own tolerances for its flash kernel against its
# oracle, 2e-5 in fp32 and 2e-2 in bf16.
FLASH_CASES = [
    (2, 4, 4, 128, 128, 64, True, "f32", 2e-5),
    (1, 8, 2, 256, 256, 64, True, "f32", 2e-5),
    (1, 4, 4, 128, 128, 128, True, "bf16", 2e-2),
    (2, 2, 1, 128, 256, 64, False, "f32", 2e-5),
    (1, 16, 4, 256, 256, 64, True, "bf16", 2e-2),
    (1, 2, 2, 384, 384, 32, True, "f32", 2e-5),
]
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(rng, shapes, dtype="f32"):
    """The same values on both sides (bf16 rounded once, by JAX)."""
    jdt, _ = DT[dtype]
    js = [jnp.asarray(rng.normal(size=s), jdt) for s in shapes]
    ts = [torch.tensor(np.asarray(j.astype(jnp.float32))).to(DT[dtype][1]) for j in js]
    return js, ts


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_plain_version_matches_pallas_kernel(case):
    """``attention_ref`` and the ``(B, S, H, dh)`` entry against the JAX
    Pallas kernel (interpret mode), queries from 0 and no kv_len."""
    b, h, kv, sq, sk, dh, causal, dtype, tol = case
    rng = np.random.default_rng(42)
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, [(b, h, sq, dh), (b, kv, sk, dh), (b, kv, sk, dh)], dtype)
    want = np.asarray(jax_flash_bhsd(jq, jk, jv, causal=causal, block_q=128, block_k=128,
                                     interpret=True).astype(jnp.float32))
    got = ref.attention_ref(tq, tk, tv, causal=causal)
    assert got.dtype == DT[dtype][1]
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=0)
    # the wrapper's entries run the same plain version on CPU tensors
    assert torch.equal(ops.flash_attention_bhsd(tq, tk, tv, causal=causal), got)
    flat = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
                               causal=causal)
    assert torch.equal(flat.transpose(1, 2), got)
    assert K.LAUNCHES["attention"] == 0  # a CPU tensor never counts a launch


@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("kv_len", ["int", "rows"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_keeps_the_contract(h, kv, kv_len, causal):
    """q_offset > 0 and a scalar or per-row kv_len (one row 0) against
    JAX's attention_dense, fp32 at 1e-5."""
    b, sq, sk, dh, q_offset = 3, 24, 80, 32, 37
    rng = np.random.default_rng(3)
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, [(b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)])
    lens = 61 if kv_len == "int" else np.array([61, 0, 80], np.int32)
    want = JL.attention_dense(jq, jk, jv, causal=causal, q_offset=q_offset,
                              kv_len=jnp.asarray(lens))
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal, q_offset=q_offset,
                                  kv_len=torch.as_tensor(lens))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=0)
    if kv_len == "rows":
        assert torch.all(got[1] == 0)


CHUNKED_CASES = [
    # b, sq, sk, h, kv, causal, q_chunk, kv_chunk, q_offset, kv_len, causal_skip
    (2, 32, 32, 4, 4, True, 8, 8, 0, None, None),   # triangular pair scan
    (2, 32, 32, 4, 4, True, 8, 8, 0, None, False),  # full scan, same result
    (1, 32, 32, 8, 2, True, 8, 16, 0, None, None),  # GQA, q_chunk < kv_chunk
    (2, 30, 30, 4, 2, True, 8, 8, 0, None, None),   # sq not a multiple of q_chunk
    (2, 12, 40, 4, 4, True, 8, 16, 17, 29, None),   # a prefill chunk at an offset
    (3, 12, 40, 4, 2, True, 4, 16, 9, "rows", None),  # per-row kv_len with a 0
    (2, 16, 40, 4, 4, False, 16, 8, 0, None, None),  # not causal
    (2, 16, 45, 4, 4, False, 8, 16, 0, 33, None),   # sk padded to kv_chunk
]


@pytest.mark.parametrize("case", CHUNKED_CASES, ids=str)
def test_attention_chunked_matches_jax(case):
    b, sq, sk, h, kv, causal, qc, kc, q_offset, kv_len, skip = case
    rng = np.random.default_rng(5)
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, [(b, sq, h, 16), (b, sk, kv, 16), (b, sk, kv, 16)])
    if kv_len == "rows":
        kv_len = np.array([[21], [0], [13]], np.int32)
    jlen = None if kv_len is None else jnp.asarray(kv_len)
    tlen = None if kv_len is None else torch.as_tensor(kv_len)
    kw = dict(causal=causal, q_chunk=qc, kv_chunk=kc, q_offset=q_offset, causal_skip=skip)
    want = JL.attention_chunked(jq, jk, jv, kv_len=jlen, **kw)
    got = L.attention_chunked(tq, tk, tv, kv_len=tlen, **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=0)
    dense = L.attention_dense(tq, tk, tv, causal=causal, q_offset=q_offset, kv_len=tlen)
    np.testing.assert_allclose(_np(got), _np(dense), atol=1e-5, rtol=0)


def test_causal_skip_with_q_chunk_above_kv_chunk():
    """The JAX pair list (kj <= qi) misses KV chunks when q_chunk >
    kv_chunk; the port visits every chunk a row can see."""
    rng = np.random.default_rng(6)
    _, (tq, tk, tv) = _qkv(rng, [(1, 32, 2, 16)] * 3)
    got = L.attention_chunked(tq, tk, tv, causal=True, q_chunk=16, kv_chunk=8)
    want = L.attention_dense(tq, tk, tv, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


def _olmo(dtype, seq=256):
    jcfg, tcfg, jp, tp = _models(dtype, num_layers=2)
    toks = np.random.default_rng(8).integers(1, jcfg.vocab_size, size=(2, seq))
    return jcfg, tcfg, jp, tp, toks


def test_forward_flash_matches_jax_pallas_fp32():
    """forward(attn_impl="flash") (the plain version on the CPU) against
    the JAX forward(attn_impl="pallas") (interpret), smoke OLMo at S 256:
    no cache, so the Pallas kernel keeps the contract here."""
    jcfg, tcfg, jp, tp, toks = _olmo("f32")
    jl, _, _ = jax.jit(lambda p, t: JT.forward(p, jcfg, tokens=t, attn_impl="pallas"))(
        jp, jnp.asarray(toks))
    for impl in ("flash", "chunked"):
        tl, _, _ = T.forward(tp, tcfg, tokens=torch.as_tensor(toks), attn_impl=impl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=0)


def test_forward_flash_greedy_tokens_bf16():
    """Greedy tokens at every position equal to JAX's pallas forward,
    except where JAX's top-2 margin is at most one bf16 ulp."""
    jcfg, tcfg, jp, tp, toks = _olmo("bf16")
    jl, _, _ = jax.jit(lambda p, t: JT.forward(p, jcfg, tokens=t, attn_impl="pallas"),
                       compiler_options=EXACT_BF16)(jp, jnp.asarray(toks))
    jl = np.asarray(jl.astype(jnp.float32))
    tl = T.forward(tp, tcfg, tokens=torch.as_tensor(toks), attn_impl="flash")[0].numpy()
    top2 = np.sort(jl, axis=-1)[..., -2:]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(top2[..., 1]))) - 7)
    decided = top2[..., 1] - top2[..., 0] > ulp
    assert decided.mean() > 0.9, decided.mean()
    np.testing.assert_array_equal(tl.argmax(-1)[decided], jl.argmax(-1)[decided])


_JAX_TOKENS = {}


def _jax_engine_tokens(dtype, impl):
    """The JAX Engine's out_tokens on the 14-request workload (computed
    once per dtype and attention implementation)."""
    if (dtype, impl) not in _JAX_TOKENS:
        jcfg, _, jp, _ = _models(dtype)
        eng = JaxEngine(jp, jcfg, JaxServeConfig(**WORKLOAD, attn_impl=impl))
        eng._prefill = jax.jit(partial(JT.prefill_step, cfg=jcfg, attn_impl=impl),
                               compiler_options=EXACT_BF16)
        eng._decode = jax.jit(partial(JT.decode_step, cfg=jcfg, attn_impl=impl),
                              compiler_options=EXACT_BF16)
        prompts, budgets = _workload()
        reqs = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
        eng.run_until_drained()
        _JAX_TOKENS[dtype, impl] = [r.out_tokens for r in reqs]
    return _JAX_TOKENS[dtype, impl]


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("impl", ["flash", "chunked"])
def test_engine_tokens_match_jax_engine(impl, dtype):
    """The 14-request workload (ragged prompts and budgets through 8
    slots, prefill chunk 4, so most prompts end in a padded tail) gives
    the JAX dense Engine's out_tokens.  One exception: chunked attention
    in bf16 rounds P to bf16 before P.V, in the JAX package as here, and
    the JAX chunked Engine itself parts from the JAX dense one in 3 of
    the 14 requests; there the port is held to the JAX chunked Engine."""
    _, tcfg, _, tp = _models(dtype)
    eng = Engine(tp, tcfg, ServeConfig(**WORKLOAD, attn_impl=impl), device="cpu")
    prompts, budgets = _workload()
    reqs = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    assert len(eng.run_until_drained()) == 14
    assert all(r.done and r.status == "ok" for r in reqs)
    oracle = "chunked" if (impl, dtype) == ("chunked", "bf16") else "dense"
    assert [r.out_tokens for r in reqs] == _jax_engine_tokens(dtype, oracle)


def test_ragged_tail_gives_the_kernel_its_offset_and_kv_len(monkeypatch):
    """Every prefill chunk reaches the flash entry with q_offset = pos and
    kv_len = pos + width, the padded tail included."""
    _, tcfg, _, tp = _models("f32", num_layers=2)
    seen, plain = [], ref.flash_attention_ref

    def spy(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1], kw["causal"], kw["q_offset"], kw["kv_len"]))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(ref, "flash_attention_ref", spy)
    eng = Engine(tp, tcfg, ServeConfig(max_batch=1, max_len=20, prefill_chunk=8,
                                       max_new_tokens=1, attn_impl="flash"), device="cpu")
    eng.submit(np.arange(1, 19, dtype=np.int32))  # 18 tokens: chunks at 0, 8; tail at 16
    eng.run_until_drained()
    # two layer groups per chunk; the tail is cut at the cache end: width 4
    assert seen == [(8, 20, True, 0, 8)] * 2 + [(8, 20, True, 8, 16)] * 2 \
        + [(4, 20, True, 16, 20)] * 2


def test_dispatch(monkeypatch):
    assert K.get_impl("attention", "plain") is ref.flash_attention_ref
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        K.get_impl("attention", "cuda")
    assert K.get_impl("attention", "auto") is ref.flash_attention_ref
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="bogus"):
        L.attention(q, q, q, impl="bogus", causal=True)
    with pytest.raises(ValueError, match="'flash'"):
        L.attention(q, q, q, impl="pallas", causal=True)
    _, tcfg, _, tp = _models("f32", num_layers=2)
    toks = torch.ones((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="'flash'"):
        T.forward(tp, tcfg, tokens=toks, attn_impl="pallas")
    with pytest.raises(ValueError, match="'flash'"):
        T.prefill_step(tp, T.init_cache(tcfg, 1, 8, device="cpu"), tcfg, tokens=toks,
                       attn_impl="pallas")
    with pytest.raises(ValueError, match="'flash'"):
        Engine(tp, tcfg, ServeConfig(attn_impl="pallas"), device="cpu")
    # kernels="cuda" needs CUDA tensors: a CPU forward under it raises
    with pytest.raises(ValueError, match="CUDA device"):
        T.forward(tp, tcfg, tokens=toks, attn_impl="flash", kernels="cuda")
