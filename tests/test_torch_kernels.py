"""The decode-path kernels' plain versions against the JAX package, the
wrappers' dispatch, and the kernel registry (the flash kernel's plain
version is in tests/test_torch_flash.py, the SSD and RMSNorm kernels'
in tests/test_torch_ssm.py).

Each plain version (``ref.py``) is held against the JAX ``ref.py`` and
against the JAX ``ops.py`` wrapper run with ``interpret=True`` (the
Pallas kernel emulated on the CPU), on inputs made with numpy from a
seed.  The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import fused_decode_attention as jax_decode_ops
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref
from repro.kernels.emit_norm_logits.ops import emit_norm_logits as jax_emit_ops
from repro.kernels.emit_norm_logits.ref import emit_norm_logits_ref as jax_emit_ref
from repro_torch import kernels as K
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.emit_norm_logits import ops as emit_ops
from repro_torch.kernels.emit_norm_logits.ref import emit_norm_logits_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

# Decode attention.  fp32: the same fp32 ops reduced in another order,
# on outputs that are convex combinations of order-1 values: atol 1e-5.
# bf16: the inputs are the same bf16 values and both sides compute in
# fp32 and round once to bf16; the last fp32 bits can move that rounding
# by one bf16 ulp, which is at most 2**-7 of |ref| (atol covers outputs
# near 0, whose fp32 error is absolute).
DECODE_TOL = {"f32": dict(rtol=0, atol=1e-5), "bf16": dict(rtol=2**-7, atol=1e-5)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _decode_inputs(rng, b, s, h, kv, dh, pos):
    arrays = dict(
        q=rng.normal(size=(b, 1, h, dh)), k_new=rng.normal(size=(b, kv, dh)),
        v_new=rng.normal(size=(b, kv, dh)), k_cache=rng.normal(size=(b, s, kv, dh)),
        v_cache=rng.normal(size=(b, s, kv, dh)),
    )
    pos = np.asarray(pos, np.int32)
    return {k: a.astype(np.float32) for k, a in arrays.items()}, pos, pos + 1


def _check_decode(arrays, pos, kv_len, dtype):
    jdt, tdt = DTYPES[dtype]
    names = ("q", "k_new", "v_new", "k_cache", "v_cache")
    ja = [jnp.asarray(arrays[n], jdt) for n in names]
    ta = [torch.as_tensor(arrays[n]).to(tdt) for n in names]
    out = decode_attention_ref(*ta, pos=torch.as_tensor(pos), kv_len=torch.as_tensor(kv_len))
    ref = jax_decode_ref(*ja, pos=jnp.asarray(pos), kv_len=jnp.asarray(kv_len))
    emulated = jax_decode_ops(*ja, pos=jnp.asarray(pos), kv_len=jnp.asarray(kv_len),
                              interpret=True)
    assert out.dtype == tdt and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(_np(out), _np(ref), **DECODE_TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(emulated), **DECODE_TOL[dtype])
    return out


DECODE_CASES = {
    # every row at another depth, incl. a fresh row (pos 0) and pos = S-1
    "ragged_gqa": (4, 16, 4, 2, 16, [0, 5, 11, 15]),
    "ragged_mha": (4, 16, 4, 4, 16, [15, 0, 7, 3]),
    # every row writing the last cache slot (pos == max_len - 1)
    "max_len_boundary": (3, 8, 4, 2, 8, [7, 7, 7]),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attention_plain_matches_jax(case, dtype):
    rng = np.random.default_rng(0)
    arrays, pos, kv_len = _decode_inputs(rng, *DECODE_CASES[case])
    _check_decode(arrays, pos, kv_len, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_attention_admission_rows_over_poisoned_cache(dtype):
    """Freshly admitted rows (pos 0) beside deep rows, with the cache
    beyond kv_len poisoned: NaN in K (masked to -inf before the
    softmax) and 1e4 in V (multiplied by an exact 0).  The mask comes
    from kv_len, never from the cache contents."""
    rng = np.random.default_rng(2)
    arrays, pos, kv_len = _decode_inputs(rng, 4, 12, 4, 4, 16, [0, 9, 0, 3])
    for row in (0, 2):
        arrays["k_cache"][row, 1:] = np.nan
        arrays["v_cache"][row, 1:] = 1e4
    out = _check_decode(arrays, pos, kv_len, dtype)
    assert torch.isfinite(out.float()).all()


def test_decode_attention_row_without_valid_key_is_zero():
    """kv_len 0 masks every key: the NaN scrub yields 0, as in JAX."""
    rng = np.random.default_rng(3)
    arrays, pos, _ = _decode_inputs(rng, 2, 8, 4, 2, 8, [3, 0])
    out = _check_decode(arrays, pos, np.array([4, 0], np.int32), "f32")
    assert torch.all(out[1] == 0)


# Emit.  The JAX ``EMIT_CASES`` matrix filled out: norm x tied x dtype.
EMIT_CASES = [
    (norm, tied, dtype)
    for norm in ("rmsnorm", "layernorm_nonparam")
    for tied in (False, True)
    for dtype in sorted(DTYPES)
]


def _assert_emit_close(out, ref, dtype):
    """fp32: the same fp32 ops, sums over d in another order: rtol 1e-5.
    bf16: xn is rounded to bf16 on both sides from fp32 values that may
    differ in their last bits, so an element of xn can differ by one
    bf16 ulp; its effect on a logit is absolute, of the order of the
    row's largest logits; then each logit is rounded to bf16.  Allowed:
    two bf16 ulps of the row's largest |logit|."""
    if dtype == "f32":
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
        return
    top = np.abs(ref).max(axis=-1, keepdims=True)
    allowed = 2 * 2.0 ** (np.floor(np.log2(top)) - 7)
    err = np.abs(out - ref)
    assert (err <= allowed).all(), (err / allowed).max()


@pytest.mark.parametrize("norm,tied,dtype", EMIT_CASES, ids=str)
def test_emit_plain_matches_jax(norm, tied, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    b, d, v = 3, 32, 96  # v not a power of two
    x = rng.normal(size=(b, 1, d)).astype(np.float32) * 2 + 0.3
    w = (rng.normal(size=(v, d) if tied else (d, v)) * 0.1).astype(np.float32)
    scale = (rng.normal(size=(d,)) * 0.2 + 1.0).astype(np.float32)
    kw = dict(norm=norm, tied=tied)
    jscale = jnp.asarray(scale) if norm == "rmsnorm" else None
    tscale = torch.as_tensor(scale) if norm == "rmsnorm" else None
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    out = emit_norm_logits_ref(torch.as_tensor(x).to(tdt), torch.as_tensor(w).to(tdt),
                               scale=tscale, **kw)
    ref = _np(jax_emit_ref(jx, jw, scale=jscale, **kw))
    emulated = _np(jax_emit_ops(jx, jw, scale=jscale, interpret=True, **kw))
    assert out.dtype == torch.float32 and tuple(out.shape) == (b, v)
    _assert_emit_close(out.numpy(), ref, dtype)
    _assert_emit_close(out.numpy(), emulated, dtype)
    # each logit is a value of x's dtype, upcast: the rounding is kept
    assert torch.equal(out, out.to(tdt).float())


# ---------------------------------------------------------------------------
# Wrappers: a CPU tensor runs the plain version; no other device falls back
# ---------------------------------------------------------------------------


def _small_decode(device="cpu"):
    rng = np.random.default_rng(5)
    arrays, pos, kv_len = _decode_inputs(rng, 2, 8, 4, 2, 32, [2, 7])
    ta = [torch.as_tensor(arrays[n], device=device)
          for n in ("q", "k_new", "v_new", "k_cache", "v_cache")]
    return ta, torch.as_tensor(pos, device=device), torch.as_tensor(kv_len, device=device)


def test_wrappers_run_the_plain_version_on_cpu_without_counting():
    K.reset_launches()
    ta, pos, kv_len = _small_decode()
    out = da_ops.fused_decode_attention(*ta, pos=pos, kv_len=kv_len)
    assert torch.equal(out, decode_attention_ref(*ta, pos=pos, kv_len=kv_len))
    x = torch.randn(2, 1, 32, generator=torch.Generator().manual_seed(0))
    w = torch.randn(32, 64, generator=torch.Generator().manual_seed(1))
    got = emit_ops.emit_norm_logits(x, w, norm="layernorm_nonparam")
    assert torch.equal(got, emit_norm_logits_ref(x, w, norm="layernorm_nonparam"))
    q = torch.randn(1, 5, 2, 32, generator=torch.Generator().manual_seed(2))
    got = fa_ops.flash_attention(q, q, q, causal=True, q_offset=3, kv_len=4)
    assert torch.equal(got, flash_attention_ref(q, q, q, causal=True, q_offset=3, kv_len=4))
    got = rms_ops.rmsnorm(x, torch.ones(32))
    assert torch.equal(got, rmsnorm_ref(x, torch.ones(32)))
    xs = torch.randn(2, 3, 5, 8, generator=torch.Generator().manual_seed(3))
    dt, bc = torch.rand(2, 3, 5), torch.randn(2, 1, 5, 4)
    got = ssd_ops.ssd_intra_chunk(xs, dt, bc, bc, -torch.ones(3), torch.ones(3))
    want = ssd_intra_chunk_ref(xs, dt, bc, bc, -torch.ones(3), torch.ones(3))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert K.LAUNCHES == {"decode_attention": 0, "emit_norm_logits": 0, "attention": 0,
                          "ssd": 0, "rmsnorm": 0}


def test_wrappers_refuse_other_devices():
    ta, pos, kv_len = _small_decode("meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        da_ops.fused_decode_attention(*ta, pos=pos, kv_len=kv_len)
    x = torch.empty(2, 1, 32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        emit_ops.emit_norm_logits(x, torch.empty(32, 64, device="meta"), norm="layernorm_nonparam")
    with pytest.raises(ValueError):
        emit_ops.emit_norm_logits(x, torch.empty(32, 64), norm="batchnorm")


def test_decode_wrapper_checks_its_operands():
    """The checks a CUDA launch runs first (exercised on CPU tensors)."""
    ta, pos, kv_len = _small_decode()
    q, kn, vn, kc, vc = ta
    da_ops._check(q, kn, vn, kc, vc, pos, kv_len)  # the good case passes
    bad = [
        ((q.double(), kn, vn, kc, vc, pos, kv_len), TypeError),
        ((q, kn.double(), vn, kc, vc, pos, kv_len), TypeError),
        ((q, kn, vn, kc[:, :4], vc, pos, kv_len), ValueError),
        ((q, kn, vn, kc.transpose(1, 2).contiguous().transpose(1, 2), vc, pos, kv_len), ValueError),
        ((q, kn, vn, kc, vc, pos.long(), kv_len), TypeError),
        ((q[..., :24], kn[..., :24], vn[..., :24], kc[..., :24].contiguous(),
          vc[..., :24].contiguous(), pos, kv_len), ValueError),
    ]
    for args, err in bad:
        with pytest.raises(err):
            da_ops._check(*args)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def test_resolve_mode():
    assert K.KERNEL_MODES == ("plain", "cuda", "auto")
    assert K.resolve_mode("auto", "cpu") == "plain"
    assert K.resolve_mode("auto", torch.device("cuda", 0)) == "cuda"
    assert K.resolve_mode("plain", "cuda") == "plain"
    assert K.resolve_mode("cuda", "cuda") == "cuda"
    with pytest.raises(ValueError, match="CUDA device"):
        K.resolve_mode("cuda", "cpu")
    for bad in ("pallas", "xla", None):
        with pytest.raises(ValueError, match="expected one of"):
            K.resolve_mode(bad, "cpu")


def test_get_impl_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert K.get_impl("decode_attention", "plain") is decode_attention_ref
    assert K.get_impl("emit_norm_logits", "plain") is emit_norm_logits_ref
    assert K.get_impl("decode_attention", "auto") is decode_attention_ref
    # the hand kernel asked for where there is no card raises; it never
    # hands back the plain version
    for op in K.OPS:
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            K.get_impl(op, "cuda")
    with pytest.raises(ValueError, match="unknown kernel op"):
        K.get_impl("conv3d", "plain")
    with pytest.raises(ValueError, match="expected one of"):
        K.get_impl("decode_attention", "pallas")


def test_get_impl_with_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    # the wrappers, behind the training guard (kernels.no_backward)
    assert K.get_impl("decode_attention", "cuda").__wrapped__ is da_ops.fused_decode_attention
    assert K.get_impl("emit_norm_logits", "auto").__wrapped__ is emit_ops.emit_norm_logits


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """Building a kernel where there is no CUDA toolkit raises."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(K, "_FUNCS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.kernel_function("decode_attention", "decode_attention", da_ops._ARGTYPES)


def test_library_path_follows_the_source(monkeypatch, tmp_path):
    names = {K.library_path(n).name for n in K.SOURCES}
    assert len(names) == 5 and all(n.endswith(".so") for n in names)
    src = tmp_path / "decode_attention.cu"
    src.write_text("// edited\n")
    before = K.library_path("decode_attention")
    monkeypatch.setattr(K, "CSRC", tmp_path)
    assert K.library_path("decode_attention") != before


# ---------------------------------------------------------------------------
# Merge tickets: one buffer per (device, stream) for eager launches, a
# slice of their own for captured ones, never freed, no allocation while
# capturing (the bookkeeping, on CPU tensors)
# ---------------------------------------------------------------------------


@pytest.fixture
def tickets(monkeypatch):
    monkeypatch.setattr(K, "_TICKETS", {})
    monkeypatch.setattr(K, "_CAPTURE_RESERVE", {})
    monkeypatch.setattr(K, "_RETIRED", [])
    return torch.device("cpu")


def _retired(t):
    return any(r is t for r in K._RETIRED)


def test_merge_tickets_one_buffer_per_stream(tickets):
    a = K.merge_tickets(tickets, 10, stream=1)
    assert a.dtype == torch.int32 and a.numel() == 4096 and torch.all(a == 0)
    assert K.merge_tickets(tickets, 4096, stream=1) is a  # launches on one stream share it
    b = K.merge_tickets(tickets, 10, stream=2)
    assert b is not a and b.data_ptr() != a.data_ptr()
    assert K.merge_tickets(tickets, 10, stream=1) is a
    assert set(K._TICKETS) == {(tickets, 1), (tickets, 2)}


def test_merge_tickets_growth_keeps_the_old_buffer(tickets):
    a = K.merge_tickets(tickets, 100, stream=7)
    b = K.merge_tickets(tickets, 5000, stream=7)
    assert b.numel() == 5000 and torch.all(b == 0) and b is not a
    assert _retired(a)  # still referenced: a captured graph may point at it
    assert K.merge_tickets(tickets, 4096, stream=7) is b
    c = K.merge_tickets(tickets, 9000, stream=7)
    assert _retired(a) and _retired(b) and K._TICKETS[tickets, 7] is c


def test_merge_tickets_refuse_to_allocate_while_capturing(tickets, monkeypatch):
    a = K.merge_tickets(tickets, 100, stream=3)
    reserve = K._CAPTURE_RESERVE[tickets][0]
    assert reserve.numel() >= K.CAPTURE_LAUNCHES * 100 and torch.all(reserve == 0)
    monkeypatch.setattr(K, "_capturing", lambda device: True)
    got = [K.merge_tickets(tickets, 100, stream=s) for s in (3, 3, 4)]  # 4: no buffer yet
    for t in got:
        assert t.numel() == 100 and t.data_ptr() != a.data_ptr()
        assert t.untyped_storage().data_ptr() == reserve.untyped_storage().data_ptr()
    with pytest.raises(RuntimeError, match="before capture"):
        K.merge_tickets(tickets, reserve.numel(), stream=3)
    assert K._TICKETS == {(tickets, 3): a} and K._RETIRED == []
    assert K._CAPTURE_RESERVE[tickets][0] is reserve


def test_merge_tickets_captured_launches_own_their_tickets(tickets, monkeypatch):
    """Two captured launches never share a ticket, whatever the streams
    their graphs are replayed on: consecutive disjoint slices."""
    K.merge_tickets(tickets, 128, stream=5)
    monkeypatch.setattr(K, "_capturing", lambda device: True)
    spans = []
    for stream in (5, 5, 6, 5):
        t = K.merge_tickets(tickets, 128, stream=stream)
        start = (t.data_ptr() - K._CAPTURE_RESERVE[tickets][0].data_ptr()) // 4
        spans.append((start, start + t.numel()))
    assert spans == [(128 * i, 128 * (i + 1)) for i in range(4)]


def test_merge_tickets_reserve_is_kept_when_replaced(tickets, monkeypatch):
    """A call outside a capture that finds too little room in the reserve
    retires it (graphs captured earlier hold slices of it) and reserves
    anew; then a capture of the larger count fits."""
    K.merge_tickets(tickets, 100, stream=1)
    old = K._CAPTURE_RESERVE[tickets][0]
    monkeypatch.setattr(K, "_capturing", lambda device: True)
    K.merge_tickets(tickets, 100, stream=1)
    with pytest.raises(RuntimeError, match="before capture"):
        K.merge_tickets(tickets, old.numel(), stream=1)
    monkeypatch.setattr(K, "_capturing", lambda device: False)
    K.merge_tickets(tickets, old.numel(), stream=1)
    assert _retired(old) and K._CAPTURE_RESERVE[tickets][0] is not old
    assert K._CAPTURE_RESERVE[tickets][1] == 0
    monkeypatch.setattr(K, "_capturing", lambda device: True)
    assert K.merge_tickets(tickets, old.numel(), stream=1).numel() == old.numel()


def test_merge_tickets_capture_query_only_on_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert not K._capturing(torch.device("cpu"))
    assert K._capturing(torch.device("cuda", 0))
