"""repro_torch.models.layers against repro.models.layers at fp32.

Inputs are made with numpy from a seed and fed to both sides.  Tolerance:
atol 1e-5 -- the same fp32 ops, reduced in another order by each
framework, on values of order 1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from types import SimpleNamespace

from repro.models import layers as JL
from repro_torch.models import layers as L

ATOL = 1e-5


def close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL, rtol=0)


def pair(a):
    return torch.as_tensor(a), jnp.asarray(a)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def test_norms(rng):
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3 + 0.5
    scale = rng.normal(size=(48,)).astype(np.float32)
    tx, jx = pair(x)
    close(L.rmsnorm({"scale": torch.as_tensor(scale)}, tx), JL.rmsnorm({"scale": jnp.asarray(scale)}, jx))
    close(L.layernorm_nonparam(tx), JL.layernorm_nonparam(jx))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(rng, theta):
    close(L.rope_frequencies(32, theta), JL.rope_frequencies(32, theta))
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 900, size=(2, 7))
    tx, jx = pair(x)
    out = L.apply_rope(tx, torch.as_tensor(pos), theta)
    # angles up to 900 rad: fp32 cos/sin of large arguments differ in the
    # last ulps between the two math libraries
    np.testing.assert_allclose(out.numpy(), np.asarray(JL.apply_rope(jx, jnp.asarray(pos), theta)),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)])
def test_attention_dense_prefill_offset_and_kv_len(rng, h, kv):
    """Causal chunk at q_offset with a per-row kv_len that masks every key
    of one row (the NaN scrub gives 0 there)."""
    b, sq, sk, dh = 3, 4, 10, 16
    q = rng.normal(size=(b, sq, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, sk, kv, dh)).astype(np.float32)
    v = rng.normal(size=(b, sk, kv, dh)).astype(np.float32)
    kv_len = np.array([[10], [6], [0]], np.int32)
    args_t = [torch.as_tensor(a) for a in (q, k, v)]
    args_j = [jnp.asarray(a) for a in (q, k, v)]
    out_t = L.attention_dense(*args_t, causal=True, q_offset=5, kv_len=torch.as_tensor(kv_len))
    out_j = JL.attention_dense(*args_j, causal=True, q_offset=5, kv_len=jnp.asarray(kv_len))
    close(out_t, out_j)
    assert torch.all(out_t[2] == 0)
    # scalar kv_len and no mask at all
    close(L.attention_dense(*args_t, causal=False, kv_len=7),
          JL.attention_dense(*args_j, causal=False, kv_len=7))
    close(L.attention_dense(*args_t, causal=False), JL.attention_dense(*args_j, causal=False))


def _cfg(**kw):
    base = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, norm_eps=1e-5,
                rope_theta=1e4, qkv_bias=False, qk_norm=False)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("bias,qk_norm", [(False, False), (True, False), (False, True)])
def test_attn_project_qkv_and_out(rng, bias, qk_norm):
    cfg = _cfg(qkv_bias=bias, qk_norm=qk_norm)
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (d, h, dh), "wk": (d, kv, dh), "wv": (d, kv, dh), "wo": (h, dh, d)}
    if bias:
        shapes.update(bq=(h, dh), bk=(kv, dh), bv=(kv, dh))
    if qk_norm:
        shapes.update(q_norm=(dh,), k_norm=(dh,))
    p = {k: (rng.normal(size=s) * 0.3).astype(np.float32) for k, s in shapes.items()}
    tp = {k: torch.as_tensor(a) for k, a in p.items()}
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    pos = np.arange(3, 8)[None].repeat(2, 0)
    tq = L.attn_project_qkv(tp, torch.as_tensor(x), cfg, torch.as_tensor(pos))
    jq = JL.attn_project_qkv(jp, jnp.asarray(x), cfg, jnp.asarray(pos))
    for a, b in zip(tq, jq):
        close(a, b)
    ctx = rng.normal(size=(2, 5, h, dh)).astype(np.float32)
    close(L.attn_out(tp, torch.as_tensor(ctx)), JL.attn_out(jp, jnp.asarray(ctx)))


def test_mlp(rng):
    p = {"w_gate": rng.normal(size=(32, 64)), "w_up": rng.normal(size=(32, 64)),
         "w_down": rng.normal(size=(64, 32))}
    p = {k: (a * 0.2).astype(np.float32) for k, a in p.items()}
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    close(L.mlp({k: torch.as_tensor(a) for k, a in p.items()}, torch.as_tensor(x)),
          JL.mlp({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x)))


@pytest.mark.parametrize("tied", [False, True])
def test_logits_and_embed_lookup(rng, tied):
    cfg = SimpleNamespace(tie_embeddings=tied)
    table = rng.normal(size=(50, 16)).astype(np.float32)
    head = rng.normal(size=(16, 50)).astype(np.float32)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    tl = L.logits({"w": torch.as_tensor(head)}, {"embedding": torch.as_tensor(table)},
                  torch.as_tensor(x), cfg)
    jl = JL.logits({"w": jnp.asarray(head)}, {"embedding": jnp.asarray(table)}, jnp.asarray(x), cfg)
    assert tl.dtype == torch.float32
    close(tl, jl)
    toks = rng.integers(0, 50, size=(2, 4))
    close(L.embed_lookup(torch.as_tensor(table), torch.as_tensor(toks)),
          JL.embed_lookup(jnp.asarray(table), jnp.asarray(toks)))
