"""The CUDA kernels of repro_torch against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports neither jax nor the JAX package, so that it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Shapes are small and odd on purpose (S not a multiple of the kernel's
64-row tile, V not a multiple of its vocab tile, B above its 8-row batch
chunk); chip_smoke.py covers the full widths.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels.decode_attention.ops import fused_decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.emit_norm_logits.ops import emit_norm_logits
from repro_torch.kernels.emit_norm_logits.ref import emit_norm_logits_ref
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_bhsd
from repro_torch.kernels.flash_attention.ref import attention_ref, flash_attention_ref

pytestmark = pytest.mark.cuda

DTYPES = [torch.bfloat16, torch.float32]
# Decode attention: one rounding of order-1 outputs to the output dtype,
# moved by fp32 differences between the online and the two-pass softmax:
# bf16 2 ulps at magnitude 1; fp32 sums of up to 100 terms in another order.
DECODE_TOL = {torch.bfloat16: 1.6e-2, torch.float32: 1e-5}


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    K.reset_launches()


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _decode_args(gen, b, s, h, kv, dh, dtype, pos):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    return (rnd(b, 1, h, dh), rnd(b, kv, dh), rnd(b, kv, dh), rnd(b, s, kv, dh),
            rnd(b, s, kv, dh)), pos, pos + 1


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("h,kv,dh", [(4, 4, 128), (16, 2, 128), (8, 4, 64), (12, 12, 32)])
def test_decode_attention_matches_plain(dtype, h, kv, dh):
    s = 100
    args, pos, kv_len = _decode_args(_gen(0), 4, s, h, kv, dh, dtype, [0, s - 1, 63, 64])
    got = fused_decode_attention(*args, pos=pos, kv_len=kv_len)
    want = decode_attention_ref(*args, pos=pos, kv_len=kv_len)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert K.LAUNCHES["decode_attention"] == 1


def test_decode_attention_edges():
    """kv_len 0 yields 0 (the NaN scrub); rows beyond kv_len are never
    read (NaN there leaves the output finite); the cache is not written."""
    args, pos, _ = _decode_args(_gen(1), 3, 70, 4, 2, 64, torch.float32, [5, 0, 69])
    args[3][0, 6:] = float("nan")
    args[4][0, 6:] = 1e4
    before = args[3].clone()
    kv_len = torch.tensor([6, 0, 70], dtype=torch.int32, device="cuda")
    got = fused_decode_attention(*args, pos=pos, kv_len=kv_len)
    want = decode_attention_ref(*args, pos=pos, kv_len=kv_len)
    assert torch.isfinite(got).all() and torch.all(got[1] == 0)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(args[3].isnan(), before.isnan())


def test_wrappers_raise_rather_than_fall_back():
    args, pos, kv_len = _decode_args(_gen(2), 2, 16, 4, 2, 64, torch.float32, [1, 2])
    q = args[0].transpose(2, 3).contiguous().transpose(2, 3)  # same values, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fused_decode_attention(q, *args[1:], pos=pos, kv_len=kv_len)
    with pytest.raises(TypeError):
        fused_decode_attention(*args, pos=pos.long(), kv_len=kv_len)
    x = torch.zeros(2, 1, 64, device="cuda")
    with pytest.raises(TypeError):
        emit_norm_logits(x, torch.zeros(64, 96, device="cuda", dtype=torch.bfloat16),
                         norm="layernorm_nonparam")
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(*(torch.zeros(1, 8, 2, 48, device="cuda") for _ in range(3)), causal=True)
    q = torch.zeros(1, 8, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), q, q, causal=True)
    with pytest.raises(TypeError):
        flash_attention(q, q.bfloat16(), q.bfloat16(), causal=True)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half(), causal=True)
    with pytest.raises(TypeError, match="q_offset"):
        flash_attention(q, q, q, causal=True, q_offset=torch.tensor(3))
    with pytest.raises(ValueError, match="on"):
        flash_attention(q, q.cpu(), q.cpu(), causal=True)
    with pytest.raises(TypeError, match="int32"):
        flash_attention(q, q, q, causal=True, kv_len=torch.tensor([3], device="cuda"))
    assert K.LAUNCHES == {"decode_attention": 0, "emit_norm_logits": 0, "attention": 0}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm_nonparam"])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("b", [1, 11])
def test_emit_matches_plain(dtype, norm, tied, b):
    gen = _gen(3)
    d, v = 256, 1000
    x = (torch.randn((b, 1, d), generator=gen, device="cuda") * 2 + 0.3).to(dtype)
    w = (torch.randn((v, d) if tied else (d, v), generator=gen, device="cuda") * d**-0.5).to(dtype)
    scale = torch.randn((d,), generator=gen, device="cuda") * 0.2 + 1.0
    kw = dict(norm=norm, tied=tied, scale=scale if norm == "rmsnorm" else None)
    got = emit_norm_logits(x, w, **kw)
    want = emit_norm_logits_ref(x, w, **kw)
    # bf16: 2 bf16 ulps of the row's largest |logit| (an element of the
    # normalised x may round one ulp apart); fp32: 1e-4 of it.
    top = want.abs().amax(-1, keepdim=True)
    allowed = (2 * torch.exp2(torch.floor(torch.log2(top)) - 7)
               if dtype == torch.bfloat16 else 1e-4 * top)
    assert ((got - want).abs() <= allowed).all()
    assert torch.equal(got, got.to(dtype).float())  # logits rounded to x's dtype
    assert K.LAUNCHES["emit_norm_logits"] == 1


def test_decode_step_kernels_match_plain():
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    cfg = get_config("qwen3-32b").with_overrides(
        num_layers=2, d_model=512, num_heads=8, num_kv_heads=2, d_ff=1024, vocab_size=1024)
    params = init_params(T.model_layout(cfg), seed=0, device="cuda")
    cache = T.init_cache(cfg, 4, 96, device="cuda")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(1, 1024, size=(4, 64)), device="cuda")
    T.prefill_step(params, cache, cfg, tokens=toks, pos=0)
    tokens = torch.as_tensor(rng.integers(1, 1024, size=4), device="cuda")
    lengths = torch.tensor([64, 10, 0, 63], dtype=torch.int32, device="cuda")
    copy = {n: {k: t.clone() for k, t in blk.items()} for n, blk in cache.items()}
    got, c_got = T.decode_step(params, cache, cfg, tokens=tokens, lengths=lengths)
    want, c_want = T.decode_step(params, copy, cfg, tokens=tokens, lengths=lengths,
                                 kernels="plain")
    assert K.LAUNCHES == {"decode_attention": 2, "emit_norm_logits": 1, "attention": 0}
    top = want.abs().amax(-1, keepdim=True)
    assert ((got - want).abs() <= 4 * torch.exp2(torch.floor(torch.log2(top)) - 7)).all()
    # the row written at each position is the same on both paths (layer 0)
    idx = torch.arange(4, device="cuda")
    for key in ("k", "v"):
        torch.testing.assert_close(c_got["block0"][key][0, idx, lengths.long()],
                                   c_want["block0"][key][0, idx, lengths.long()])


# Flash attention: outputs are convex combinations of order-1 values.
# bf16: P is rounded to bf16 for P.V on the tensor cores (the plain
# version keeps it in fp32), then the output is rounded once: JAX's own
# tolerance for its flash kernel, 2e-2.  fp32: sums of up to 200 terms in
# another order, 2e-5 (also JAX's).
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


def _flash_args(gen, b, sq, sk, h, kv, dh, dtype):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return rnd(b, sq, h, dh), rnd(b, sk, kv, dh), rnd(b, sk, kv, dh)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("h,kv,dh", [(4, 4, 128), (8, 2, 64), (6, 3, 32)])
@pytest.mark.parametrize("q_offset", [0, 37, 130])
@pytest.mark.parametrize("kv_len", ["none", "int", "ragged"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_plain(dtype, h, kv, dh, q_offset, kv_len, causal):
    """Sq = 70 query rows (not a multiple of the 64-row tile) at q_offset
    over a 200-row cache; kv_len none, one count, or ragged with a 0."""
    b, sq, sk = 3, 70, 200
    q, k, v = _flash_args(_gen(4), b, sq, sk, h, kv, dh, dtype)
    lens = {"none": None, "int": q_offset + sq,
            "ragged": torch.tensor([q_offset + sq, 0, 65], dtype=torch.int32, device="cuda")}[kv_len]
    kw = dict(causal=causal, q_offset=q_offset, kv_len=lens)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])
    assert K.LAUNCHES["attention"] == 1
    if kv_len == "ragged":
        assert torch.all(got[1] == 0)  # no valid key: 0, the NaN scrub


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_flash_attention_bhsd_and_poisoned_cache(dtype):
    """The (B, H, S, dh) entry; rows past kv_len are never read: NaN in K
    there (masked before the softmax) and 1e4 in V (multiplied by an
    exact 0 in the plain version, which a NaN would turn into NaN)."""
    b, h, kv, sq, sk, dh = 2, 8, 2, 96, 160, 64
    q, k, v = _flash_args(_gen(5), b, sq, sk, h, kv, dh, dtype)
    lens = torch.tensor([100, 31], dtype=torch.int32, device="cuda")
    for i, n in enumerate(lens.tolist()):
        k[i, n:] = float("nan")
        v[i, n:] = 1e4
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    got = flash_attention_bhsd(qt, kt, vt, causal=True, q_offset=4, kv_len=lens)
    want = attention_ref(qt, kt, vt, causal=True, q_offset=4, kv_len=lens)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])
    torch.testing.assert_close(flash_attention(q, k, v, causal=True, q_offset=4, kv_len=lens),
                               got.transpose(1, 2), atol=0, rtol=0)
    assert K.LAUNCHES["attention"] == 2


def test_prefill_flash_matches_plain():
    """Two prefill chunks (the second a padded ragged tail) through the
    flash kernel against the same chunks with its plain version."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    cfg = get_config("qwen3-32b").with_overrides(
        num_layers=2, d_model=512, num_heads=8, num_kv_heads=2, d_ff=1024, vocab_size=1024,
        dtype=torch.float32)
    params = init_params(T.model_layout(cfg), seed=0, device="cuda")
    rng = np.random.default_rng(1)
    caches = [T.init_cache(cfg, 1, 160, device="cuda") for _ in range(2)]
    for pos, at in ((0, None), (64, 40)):
        toks = torch.as_tensor(rng.integers(1, 1024, size=(1, 64)), device="cuda")
        got, _ = T.prefill_step(params, caches[0], cfg, tokens=toks, pos=pos,
                                attn_impl="flash", logits_at=at)
        want, _ = T.prefill_step(params, caches[1], cfg, tokens=toks, pos=pos,
                                 attn_impl="flash", logits_at=at, kernels="plain")
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert K.LAUNCHES == {"decode_attention": 0, "emit_norm_logits": 0, "attention": 4}
