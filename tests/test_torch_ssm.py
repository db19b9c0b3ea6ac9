"""repro_torch's Mamba-2 path against the JAX package on the CPU.

Covered: ``models.ssm`` (layout, ``causal_conv1d``, ``_ssd_decode_step``,
``ssd_chunked``, ``ssm_block``), the Mamba branches of
``models.transformer`` (layout, cache, weight bridge, ``forward``,
``prefill_step``, ``decode_step``), the SSD and RMSNorm kernels' plain
versions and wrappers (``kernels.ssd``, ``kernels.rmsnorm``) against the
JAX ``ref.py`` and the Pallas kernels run in interpret mode, and the
SSM ``Engine``.  Inputs are made with numpy from a seed; both sides run
on identical weights (the numpy weight bridge).

Tolerances: 1e-4 in fp32 where the port and JAX compute the same
function (the same fp32 ops, sums in another order); 2e-3 against the
naive recurrence ``ssd_ref`` (the chunked form reassociates a 128-step
recurrence; tests/test_kernels.py holds the Pallas kernel to the same);
2e-2 in bf16 (values of order 1 rounded to bf16 at the same places, one
rounding moved by the order of fp32 sums now and then).  The JAX bf16
side is compiled with XLA's excess precision off, so it rounds where
PyTorch rounds (see tests/test_torch_transformer.py).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.kernels.rmsnorm.kernel import rmsnorm_pallas as jax_rmsnorm_pallas
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm_ops
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro.kernels.ssd.kernel import ssd_intra_chunk as jax_ssd_intra_chunk
from repro.kernels.ssd.ops import ssd_chunked_pallas as jax_ssd_chunked_pallas
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models.params import init_params as jax_init_params
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch import kernels as K
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_intra_chunk_ref, ssd_ref
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.params import ParamSpec, params_from_numpy
from repro_torch.serve.engine import Engine, ServeConfig

ARCH = "mamba2-1.3b"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-4, "bf16": 2e-2}
EXACT_BF16 = {"xla_allow_excess_precision": False}
WORKLOAD = dict(max_batch=8, max_len=64, prefill_chunk=4, max_new_tokens=6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def bf16_ulp(x) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(x))) - 7))


def _jit(fn, **static):
    """``fn`` jitted with bf16 rounded at every op, as PyTorch rounds it."""
    return jax.jit(partial(fn, **static), compiler_options=EXACT_BF16)


def _models(dtype, **overrides):
    """The mamba2 smoke model on both sides, on the same weights.  A_log,
    dt_bias and D start at 0, 0 and 1: they get values so that every
    head decays at its own rate."""
    jdt, tdt = DTYPES[dtype]
    jcfg = jax_smoke_config(jax_get_config(ARCH)).with_overrides(dtype=jdt, **overrides)
    tcfg = smoke_config(get_config(ARCH)).with_overrides(dtype=tdt, kernels="plain", **overrides)
    jp = jax_init_params(jax.random.PRNGKey(0), JT.model_layout(jcfg))
    rng = np.random.default_rng(1)
    for blk in jp["blocks"].values():
        m = blk["mamba"]
        shape = m["A_log"].shape
        m["A_log"] = jnp.asarray(rng.uniform(-1.0, 0.7, size=shape), jnp.float32)
        m["dt_bias"] = jnp.asarray(rng.uniform(-2.0, 0.5, size=shape), jnp.float32)
        m["D"] = jnp.asarray(rng.normal(size=shape), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# Layout, cache and weight bridge
# ---------------------------------------------------------------------------


def test_layout_cache_and_weight_bridge_match_jax():
    """Same tree, shapes and dtypes; the bridged leaves are bit-identical."""
    jcfg, tcfg, jp, tp = _models("bf16")
    jl = dict(_leaves(JT.model_layout(jcfg)))
    tl = dict(_leaves(T.model_layout(tcfg)))
    assert sorted(jl) == sorted(tl) and any("/mamba/" in k for k in tl)
    for k, spec in tl.items():
        assert isinstance(spec, ParamSpec) and spec.shape == jl[k].shape, k
        assert str(spec.dtype).removeprefix("torch.") == jnp.dtype(jl[k].dtype).name, k
    jleaves = dict(_leaves(jp))
    for k, t in _leaves(tp):
        want = jleaves[k]
        assert tuple(t.shape) == want.shape, k
        assert str(t.dtype).removeprefix("torch.") == jnp.dtype(want.dtype).name, k
        assert np.array_equal(t.float().numpy(), np.asarray(want).astype(np.float32)), k
    jc = dict(_leaves(JT.cache_layout(jcfg, 3, 16)))
    tc = T.init_cache(tcfg, 3, 16, device="cpu")
    assert sorted(jc) == sorted(k for k, _ in _leaves(tc))
    for k, t in _leaves(tc):
        assert tuple(t.shape) == jc[k].shape and str(t.dtype).removeprefix("torch.") == \
            jnp.dtype(jc[k].dtype).name, k
        assert not t.any()
    assert tc["block0"]["state"].dtype == torch.float32
    d_inner, h, conv_dim, proj_dim = S.ssm_dims(tcfg, tcfg.ssm)
    assert (d_inner, h, conv_dim, proj_dim) == JS.ssm_dims(jcfg, jcfg.ssm)
    cache = S.init_ssm_cache(tcfg, tcfg.ssm, 2, tcfg.dtype, device="cpu")
    assert tuple(cache["conv"].shape) == (2, tcfg.ssm.conv_width - 1, conv_dim)
    assert tuple(cache["state"].shape) == (2, h, tcfg.ssm.state_dim, tcfg.ssm.head_dim)


def test_full_width_mamba2_layout():
    """The published widths: 48 blocks, d 2048, d_inner 4096, 64 heads x
    P 64, N 128, one B/C group, conv 4, V 50280, tied."""
    cfg = get_config(ARCH)
    d_inner, h, conv_dim, proj_dim = S.ssm_dims(cfg, cfg.ssm)
    assert (cfg.num_layers, cfg.d_model, d_inner, h, cfg.ssm.head_dim, cfg.ssm.state_dim) == \
        (48, 2048, 4096, 64, 64, 128)
    layout = T.model_layout(cfg)
    m = layout["blocks"]["block0"]["mamba"]
    assert m["in_proj"].shape == (48, 2048, proj_dim) and proj_dim == 2 * 4096 + 2 * 128 + 64
    assert m["conv_w"].shape == (48, 4, conv_dim) and layout["head"] == {}
    assert layout["embed"]["embedding"].shape == (50280, 2048)
    meta = T.cache_layout(cfg, 8, 1024)["block0"]
    assert tuple(meta["conv"].shape) == (48, 8, 3, conv_dim)
    assert tuple(meta["state"].shape) == (48, 8, 64, 128, 64)


# ---------------------------------------------------------------------------
# models.ssm pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(dtype, with_state):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    b, s, c, w = 2, 5, 24, 4
    x, wt, bias = rng.normal(size=(b, s, c)), rng.normal(size=(w, c)) * 0.5, rng.normal(size=c)
    st = rng.normal(size=(b, w - 1, c)) if with_state else None
    jy, jst = _jit(JS.causal_conv1d)(
        jnp.asarray(x, jdt), jnp.asarray(wt, jdt), jnp.asarray(bias, jdt),
        state=None if st is None else jnp.asarray(st, jdt))
    ty, tst = S.causal_conv1d(
        torch.as_tensor(x).to(tdt), torch.as_tensor(wt).to(tdt), torch.as_tensor(bias).to(tdt),
        state=None if st is None else torch.as_tensor(st).to(tdt))
    assert ty.dtype == tdt and tst.dtype == tdt
    _close(ty, jy, TOL[dtype])
    assert np.array_equal(_np(tst), _np(jst))  # the new state is a slice of the inputs


def _ssd_inputs(rng, b, s, h, p, g, n):
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 1.5, size=(h,)).astype(np.float32)
    bm = (rng.normal(size=(b, s, g, n)) / np.sqrt(n)).astype(np.float32)
    cm = (rng.normal(size=(b, s, g, n)) / np.sqrt(n)).astype(np.float32)
    dsk = rng.normal(size=(h,)).astype(np.float32)
    return x, dt, a, bm, cm, dsk


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.as_tensor(a) for a in arrays]


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(3)
    x, dt, a, bm, cm, dsk = _ssd_inputs(rng, 3, 1, 4, 8, 2, 16)
    state = rng.normal(size=(3, 4, 16, 8)).astype(np.float32)
    ja, ta = _both([x, dt, a, bm, cm, dsk, state])
    jy, jst = JS._ssd_decode_step(*ja)
    ty, tst = S._ssd_decode_step(*ta)
    _close(ty, jy, TOL["f32"])
    _close(tst, jst, TOL["f32"])


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_jax_and_continues_from_a_state(chunk):
    rng = np.random.default_rng(4)
    x, dt, a, bm, cm, dsk = _ssd_inputs(rng, 2, 16, 4, 8, 2, 16)
    s0 = rng.normal(size=(2, 4, 16, 8)).astype(np.float32)
    ja, ta = _both([x, dt, a, bm, cm, dsk])
    jy, jst = JS.ssd_chunked(*ja, chunk=chunk, initial_state=jnp.asarray(s0))
    ty, tst = S.ssd_chunked(*ta, chunk=chunk, initial_state=torch.as_tensor(s0))
    _close(ty, jy, TOL["f32"])
    _close(tst, jst, TOL["f32"])
    # the whole sequence = the first half, then the second from its state
    y1, s1 = S.ssd_chunked(*[t[:, :8] if t.dim() > 1 else t for t in ta], chunk=min(chunk, 8))
    y2, s2 = S.ssd_chunked(*[t[:, 8:] if t.dim() > 1 else t for t in ta], chunk=min(chunk, 8),
                           initial_state=s1)
    yw, sw = S.ssd_chunked(*ta, chunk=chunk)
    _close(torch.cat([y1, y2], dim=1), yw, TOL["f32"])
    _close(s2, sw, TOL["f32"])
    ry, rs = ssd_ref(*ta)
    _close(yw, ry, 2e-3)
    _close(sw, rs, 2e-3)


# tests/test_kernels.py's SSD_CASES: b, s, h, p, g, n, chunk
SSD_CASES = [
    (2, 128, 4, 64, 1, 128, 32),
    (1, 256, 8, 64, 2, 64, 64),
    (2, 64, 2, 32, 1, 32, 16),
    (1, 128, 4, 64, 4, 32, 128),
]


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
@pytest.mark.parametrize("recurrence", ["scan", "associative"])
def test_ssd_chunked_cuda_plain_path_matches_pallas_and_ref(case, recurrence):
    """``ssd_chunked_cuda`` on CPU tensors (the intra-chunk step runs its
    plain version) against the JAX wrapper around the Pallas kernel in
    interpret mode, and against the naive recurrence (port and JAX)."""
    b, s, h, p, g, n, chunk = case
    rng = np.random.default_rng(7)
    ja, ta = _both(list(_ssd_inputs(rng, b, s, h, p, g, n)))
    K.reset_launches()
    ty, tst = ssd_ops.ssd_chunked_cuda(*ta, chunk=chunk, recurrence=recurrence)
    assert K.LAUNCHES["ssd"] == 0  # CPU tensors: the plain version, not counted
    jy, jst = jax_ssd_chunked_pallas(*ja, chunk=chunk, interpret=True, recurrence=recurrence)
    _close(ty, jy, TOL["f32"])
    _close(tst, jst, TOL["f32"])
    ry, rs = ssd_ref(*ta)
    jry, jrs = jax_ssd_ref(*ja)
    _close(ry, jry, TOL["f32"])
    _close(rs, jrs, TOL["f32"])
    _close(ty, ry, 2e-3)
    _close(tst, rs, 2e-3)
    py, pst = ssd_chunked_ref(*ta, chunk=chunk, recurrence=recurrence)
    assert torch.equal(py, ty) and torch.equal(pst, tst)


@pytest.mark.parametrize("recurrence", ["scan", "associative"])
def test_ssd_chunked_cuda_continues_from_a_state(recurrence):
    rng = np.random.default_rng(8)
    x, dt, a, bm, cm, dsk = _ssd_inputs(rng, 2, 48, 4, 16, 2, 8)
    s0 = rng.normal(size=(2, 4, 8, 16)).astype(np.float32)
    ja, ta = _both([x, dt, a, bm, cm, dsk])
    ty, tst = ssd_ops.ssd_chunked_cuda(*ta, chunk=16, initial_state=torch.as_tensor(s0),
                                       recurrence=recurrence)
    jy, jst = jax_ssd_chunked_pallas(*ja, chunk=16, interpret=True, recurrence=recurrence,
                                     initial_state=jnp.asarray(s0))
    _close(ty, jy, TOL["f32"])
    _close(tst, jst, TOL["f32"])
    ry, rs = ssd_ref(*ta, initial_state=torch.as_tensor(s0))
    _close(ty, ry, 2e-3)
    _close(tst, rs, 2e-3)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("q,g", [(16, 1), (5, 2), (37, 4)])
def test_ssd_intra_chunk_plain_matches_pallas(dtype, q, g):
    """The kernel's plain version against the Pallas kernel (interpret
    mode), a short ragged chunk and G > 1 included."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(9)
    bc, h, p, n = 3, 4, 8, 16
    x = rng.normal(size=(bc, h, q, p))
    dt = rng.uniform(0.01, 0.2, size=(bc, h, q)).astype(np.float32)
    bm, cm = (rng.normal(size=(bc, g, q, n)) / 4 for _ in range(2))
    a = -rng.uniform(0.5, 1.5, size=(h,)).astype(np.float32)
    dsk = rng.normal(size=(h,)).astype(np.float32)
    jy, jst, jcum = _jit(jax_ssd_intra_chunk, chunk=q, interpret=True)(
        jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(bm, jdt), jnp.asarray(cm, jdt),
        jnp.asarray(a), jnp.asarray(dsk))
    t = [torch.as_tensor(v).to(tdt) for v in (x, bm, cm)]
    ty, tst, tcum = ssd_intra_chunk_ref(t[0], torch.as_tensor(dt), t[1], t[2],
                                        torch.as_tensor(a), torch.as_tensor(dsk))
    assert ty.dtype == tdt and tst.dtype == tcum.dtype == torch.float32
    assert tuple(tst.shape) == (bc, h, n, p) and tuple(tcum.shape) == (bc, h, q)
    _close(ty, jy, TOL[dtype])
    _close(tst, jst, TOL["f32"])
    _close(tcum, jcum, TOL["f32"])
    # the wrapper on CPU tensors is the plain version
    wy, wst, wcum = ssd_ops.ssd_intra_chunk(t[0], torch.as_tensor(dt), t[1], t[2],
                                            torch.as_tensor(a), torch.as_tensor(dsk))
    assert torch.equal(wy, ty) and torch.equal(wst, tst) and torch.equal(wcum, tcum)


def test_ssd_wrapper_checks_its_operands():
    rng = np.random.default_rng(10)
    x = torch.as_tensor(rng.normal(size=(2, 4, 8, 16)), dtype=torch.float32)
    dt = torch.rand(2, 4, 8)
    bm = torch.randn(2, 2, 8, 32)
    a, d = -torch.rand(4), torch.randn(4)
    ssd_ops._check(x, dt, bm, bm, a, d)  # the good case passes
    bad = [
        ((x.double(), dt, bm, bm, a, d), TypeError),
        ((x, dt, bm.bfloat16(), bm, a, d), TypeError),
        ((x, dt.double(), bm, bm, a, d), TypeError),
        ((x, dt[:, :, :4], bm, bm, a, d), ValueError),
        ((x, dt, bm[:, :1], bm, a, d), ValueError),
        ((x, dt, bm[:, :, :, :16], bm[:, :, :, :16].contiguous(), a, d), ValueError),
        ((x, dt, torch.randn(2, 3, 8, 32), torch.randn(2, 3, 8, 32), a, d), ValueError),
        ((x, dt, bm, bm, a[:2], d), ValueError),
        ((torch.randn(1, 4, 300, 16), torch.rand(1, 4, 300), torch.randn(1, 2, 300, 32),
          torch.randn(1, 2, 300, 32), a, d), ValueError),
    ]
    for args, err in bad:
        with pytest.raises(err):
            ssd_ops._check(*args)
    with pytest.raises(ValueError, match="recurrence"):
        ssd_ops.ssd_chunked_cuda(x.permute(0, 2, 1, 3), dt.permute(0, 2, 1), a,
                                 bm.permute(0, 2, 1, 3), bm.permute(0, 2, 1, 3), d, chunk=4,
                                 recurrence="tree")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ssd_ops.ssd_intra_chunk(x.to("meta"), dt, bm, bm, a, d)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(8, 64), (2, 5, 96), (1, 3, 4, 32)], ids=str)
def test_rmsnorm_matches_pallas_and_ref(dtype, shape):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    x = rng.normal(size=shape) * 2 + 0.3
    scale = (rng.normal(size=shape[-1]) * 0.2 + 1).astype(np.float32)
    jx, tx = jnp.asarray(x, jdt), torch.as_tensor(x).to(tdt)
    K.reset_launches()
    got = rms_ops.rmsnorm(tx, torch.as_tensor(scale), 1e-5)
    assert K.LAUNCHES["rmsnorm"] == 0 and got.dtype == tdt and got.shape == tx.shape
    assert torch.equal(got, rmsnorm_ref(tx, torch.as_tensor(scale), 1e-5))
    _close(got, jax_rmsnorm_ref(jx, jnp.asarray(scale), 1e-5), TOL[dtype])
    _close(got, _jit(jax_rmsnorm_ops, eps=1e-5, interpret=True)(jx, jnp.asarray(scale)),
           TOL[dtype])
    rows = int(np.prod(shape[:-1]))
    pallas = jax_rmsnorm_pallas(jx.reshape(rows, -1), jnp.asarray(scale), eps=1e-5,
                                block_rows=rows, interpret=True)
    _close(got.reshape(rows, -1), pallas, TOL[dtype])


def test_rmsnorm_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rms_ops.rmsnorm(torch.zeros(2, 8, device="meta"), torch.ones(8))


def _gated_inputs(dtype, shape, width):
    """y, and z as ssm_block hands it over: the first d columns of an
    in_proj output of ``width`` columns (a strided view, no copy)."""
    rng = np.random.default_rng(15)
    y = rng.normal(size=shape) * 2 + 0.3
    proj = rng.normal(size=shape[:-1] + (width,)) * 2
    scale = (rng.normal(size=shape[-1]) * 0.2 + 1).astype(np.float32)
    return y, proj[..., : shape[-1]], scale


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,width", [((8, 128), 304), ((2, 5, 96), 232), ((1, 3, 64), 200)],
                         ids=str)
def test_gated_rmsnorm_matches_the_gate_ops_jax_and_pallas(dtype, shape, width):
    """The gated plain version on a strided z slice is, bitwise, the gate
    ops ``ssm_block`` ran before the fusion followed by
    ``layers.rmsnorm``; it matches the JAX ``ssm_block``'s gated norm and
    the Pallas kernel (interpret mode) on the JAX gated product (TOL)."""
    jdt, tdt = DTYPES[dtype]
    y, z, scale = _gated_inputs(dtype, shape, width)
    tproj = torch.as_tensor(np.concatenate([z, np.zeros(shape[:-1] + (width - shape[-1],))],
                                           axis=-1)).to(tdt)
    ty, tz, tscale = torch.as_tensor(y).to(tdt), tproj[..., : shape[-1]], torch.as_tensor(scale)
    assert not tz.is_contiguous()
    got = rmsnorm_ref(ty, tscale, 1e-5, gate=tz)
    assert got.dtype == tdt and got.shape == ty.shape
    want = L.rmsnorm({"scale": tscale}, ty * torch.nn.functional.silu(tz.float()).to(tdt), 1e-5)
    assert torch.equal(got, want)
    K.reset_launches()
    assert torch.equal(rms_ops.rmsnorm(ty, tscale, 1e-5, gate=tz), got)
    assert K.LAUNCHES["rmsnorm"] == 0

    jy, jz = jnp.asarray(y, jdt), jnp.asarray(z, jdt)

    def jax_gated(y, z, scale):  # the JAX ssm_block's gated norm, line for line
        return JL.rmsnorm({"scale": scale}, y * jax.nn.silu(z.astype(jnp.float32)).astype(y.dtype),
                          1e-5)

    _close(got, _jit(jax_gated)(jy, jz, jnp.asarray(scale)), TOL[dtype])
    rows = int(np.prod(shape[:-1]))
    jgated = _jit(lambda y, z: y * jax.nn.silu(z.astype(jnp.float32)).astype(y.dtype))(jy, jz)
    pallas = jax_rmsnorm_pallas(jgated.reshape(rows, -1), jnp.asarray(scale), eps=1e-5,
                                block_rows=rows, interpret=True)
    _close(got.reshape(rows, -1), pallas, TOL[dtype])


def test_rmsnorm_wrapper_refuses_a_bad_gate():
    """The gate's checks run on every device, so the CPU route refuses what
    the kernel would: another shape, device or dtype, a row stride or base
    off 16 bytes, a z strided in d."""
    y, one = torch.zeros(4, 64), torch.ones(64)
    proj = torch.zeros(4, 304)
    assert torch.equal(rms_ops.rmsnorm(y, one, gate=proj[:, :64]), rmsnorm_ref(y, one))
    bad = [
        (torch.zeros(4, 32), ValueError, "gate must be"),
        (torch.zeros(2, 2, 64), ValueError, "gate must be"),
        (torch.zeros(4, 64, device="meta"), ValueError, "gate is on"),
        (torch.zeros(4, 64, dtype=torch.bfloat16), TypeError, "gate is"),
        (torch.zeros(4, 66)[:, :64], ValueError, "16-byte"),  # rows 264 bytes apart
        (torch.zeros(4, 68)[:, 1:65], ValueError, "16-byte"),  # base 4 bytes off
        (torch.zeros(4, 128)[:, ::2], ValueError, "16-byte"),  # strided in d
        (torch.zeros(8, 64)[::2].T.contiguous().T, ValueError, "16-byte"),  # column-major
    ]
    for gate, err, match in bad:
        with pytest.raises(err, match=match):
            rms_ops.rmsnorm(y, one, gate=gate)
    gate = torch.zeros(3, 2, 80)[:, :, :64].transpose(0, 1)  # rows 80 and 160 apart
    with pytest.raises(ValueError, match="one stride"):
        rms_ops.rmsnorm(torch.zeros(2, 3, 64), one, gate=gate)


# ---------------------------------------------------------------------------
# ssm_block and the model entry points
# ---------------------------------------------------------------------------


def _block_inputs(dtype, s, with_cache):
    jcfg, tcfg, jp, tp = _models(dtype)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, s, jcfg.d_model))
    cache = None
    if with_cache:
        _, h, conv_dim, _ = S.ssm_dims(tcfg, tcfg.ssm)
        cache = dict(conv=rng.normal(size=(2, tcfg.ssm.conv_width - 1, conv_dim)),
                     state=rng.normal(size=(2, h, tcfg.ssm.state_dim, tcfg.ssm.head_dim)))
    jdt, tdt = DTYPES[dtype]
    jblk = jax.tree.map(lambda t: t[0], jp["blocks"]["block0"]["mamba"])
    tblk = {k: v[0] for k, v in tp["blocks"]["block0"]["mamba"].items()}
    jc = None if cache is None else dict(conv=jnp.asarray(cache["conv"], jdt),
                                         state=jnp.asarray(cache["state"], jnp.float32))
    tc = None if cache is None else dict(conv=torch.as_tensor(cache["conv"]).to(tdt),
                                         state=torch.as_tensor(cache["state"]).float())
    return (jcfg, jblk, jnp.asarray(x, jdt), jc), (tcfg, tblk, torch.as_tensor(x).to(tdt), tc)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s,with_cache", [(16, False), (8, True), (5, True), (1, True)],
                         ids=["forward", "prefill", "ragged-prefill", "decode"])
def test_ssm_block_matches_jax(dtype, s, with_cache, monkeypatch):
    """Prefill (with and without a cache), a ragged chunk, one-token
    decode; and the same through the kernels' route (``kernels="cuda"``
    with CPU tensors reaches the wrappers, which run their plain
    versions and count no launch)."""
    (jcfg, jblk, jx, jc), (tcfg, tblk, tx, tc) = _block_inputs(dtype, s, with_cache)
    jy, jcache = _jit(JS.ssm_block, cfg=jcfg, ssm=jcfg.ssm)(jblk, jx, cache=jc)
    ty, tcache = S.ssm_block(tblk, tx, tcfg, tcfg.ssm, cache=tc, kernels="plain")
    tol = TOL[dtype]
    _close(ty, jy, tol)
    _close(tcache["conv"], jcache["conv"], tol)
    _close(tcache["state"], jcache["state"], tol)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    K.reset_launches()
    ky, kcache = S.ssm_block(tblk, tx, tcfg, tcfg.ssm, cache=tc, kernels="cuda")
    assert K.LAUNCHES["ssd"] == K.LAUNCHES["rmsnorm"] == 0
    _close(ky, jy, tol)
    _close(kcache["state"], jcache["state"], tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_prefill_and_decode_logits_match_jax(dtype):
    """Logits of ``forward`` (S = 16, two SSD chunks), of a prefill in two
    chunks (8 + a ragged 3) and of two decode steps, against the JAX
    steps on the same weights; the caches too."""
    jcfg, tcfg, jp, tp = _models(dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(13)
    toks = rng.integers(1, tcfg.vocab_size, size=(2, 16))
    jl, _, _ = _jit(JT.forward, cfg=jcfg)(jp, tokens=jnp.asarray(toks))
    tl, _, _ = T.forward(tp, tcfg, tokens=torch.as_tensor(toks))
    _close(tl, jl, tol)

    jprefill = _jit(JT.prefill_step, cfg=jcfg)
    jdecode = _jit(JT.decode_step, cfg=jcfg)
    jc, tc = JT.init_cache(jcfg, 2, 32), T.init_cache(tcfg, 2, 32, device="cpu")
    for lo, hi in ((0, 8), (8, 11)):
        jl, jc = jprefill(jp, jc, tokens=jnp.asarray(toks[:, lo:hi]), pos=lo)
        tl, tc2 = T.prefill_step(tp, tc, tcfg, tokens=torch.as_tensor(toks[:, lo:hi]), pos=lo)
        assert tc2 is tc  # updated in place
        _close(tl, jl, tol)
    for step in range(2):
        lengths = np.full(2, 11 + step, np.int32)
        jl, jc = jdecode(jp, jc, tokens=jnp.asarray(toks[:, 11 + step]),
                         lengths=jnp.asarray(lengths))
        tl, tc = T.decode_step(tp, tc, tcfg, tokens=torch.as_tensor(toks[:, 11 + step]),
                               lengths=torch.as_tensor(lengths))
        _close(tl, jl, tol)
    for k in ("conv", "state"):
        _close(tc["block0"][k], jc["block0"][k], tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_route_of_the_model_matches_jax(dtype, monkeypatch):
    """``forward``, two prefill chunks and two decode steps under
    ``kernels="cuda"`` on CPU tensors (the wrappers run their plain
    versions) against the JAX steps.  Every block hands its pre-norms and
    every Mamba block its gated norm (the gate unapplied, z a strided
    view) to the RMSNorm wrapper; ``layers.rmsnorm`` runs only for the final norm
    (in the emit's plain version on a decode step)."""
    jcfg, tcfg, jp, tp = _models(dtype)
    tol = TOL[dtype]
    layers = tcfg.num_layers
    # the smoke config's blocks carry an MLP, whose pre-norm is a block norm too
    pre_norms = layers * sum(1 + (plan.ffn != "none") for plan in T.block_plans(tcfg))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(T, "resolve_mode", lambda mode, device: "cuda")
    calls = {"gated": 0, "plain": 0, "layers.rmsnorm": 0}
    ref, layer_norm = rms_ops.rmsnorm_ref, L.rmsnorm

    def spy_ref(x, scale, eps=1e-5, *, gate=None):
        calls["plain" if gate is None else "gated"] += 1
        assert gate is None or not gate.is_contiguous()  # read in place from in_proj
        return ref(x, scale, eps, gate=gate)

    def spy_layers(*args, **kw):
        calls["layers.rmsnorm"] += 1
        return layer_norm(*args, **kw)

    monkeypatch.setattr(rms_ops, "rmsnorm_ref", spy_ref)
    monkeypatch.setattr(L, "rmsnorm", spy_layers)

    def counted(want_layers_rmsnorm):
        assert calls == {"gated": layers, "plain": pre_norms,
                         "layers.rmsnorm": want_layers_rmsnorm}
        calls.update(gated=0, plain=0)
        calls["layers.rmsnorm"] = 0

    rng = np.random.default_rng(13)
    toks = rng.integers(1, tcfg.vocab_size, size=(2, 16))
    jl, _, _ = _jit(JT.forward, cfg=jcfg)(jp, tokens=jnp.asarray(toks))
    tl, _, _ = T.forward(tp, tcfg, tokens=torch.as_tensor(toks), kernels="cuda")
    _close(tl, jl, tol)
    counted(1)

    jprefill = _jit(JT.prefill_step, cfg=jcfg)
    jdecode = _jit(JT.decode_step, cfg=jcfg)
    jc, tc = JT.init_cache(jcfg, 2, 32), T.init_cache(tcfg, 2, 32, device="cpu")
    for lo, hi in ((0, 8), (8, 11)):
        jl, jc = jprefill(jp, jc, tokens=jnp.asarray(toks[:, lo:hi]), pos=lo)
        tl, tc = T.prefill_step(tp, tc, tcfg, tokens=torch.as_tensor(toks[:, lo:hi]), pos=lo,
                                kernels="cuda")
        _close(tl, jl, tol)
        counted(1)
    for step in range(2):
        lengths = np.full(2, 11 + step, np.int32)
        jl, jc = jdecode(jp, jc, tokens=jnp.asarray(toks[:, 11 + step]),
                         lengths=jnp.asarray(lengths))
        tl, tc = T.decode_step(tp, tc, tcfg, tokens=torch.as_tensor(toks[:, 11 + step]),
                               lengths=torch.as_tensor(lengths), kernels="cuda")
        _close(tl, jl, tol)
        counted(1)
    for k in ("conv", "state"):
        _close(tc["block0"][k], jc["block0"][k], tol)
    assert K.LAUNCHES["rmsnorm"] == 0


def test_forward_collects_the_ssm_state():
    _, tcfg, _, tp = _models("f32")
    toks = torch.as_tensor(np.random.default_rng(14).integers(1, 512, size=(2, 8)))
    _, caches, _ = T.forward(tp, tcfg, tokens=toks, collect_kv=True, cache_pad_to=32)
    tc = T.init_cache(tcfg, 2, 32, device="cpu")
    T.prefill_step(tp, tc, tcfg, tokens=toks, pos=0)
    for k in ("conv", "state"):
        assert torch.allclose(caches["block0"][k], tc["block0"][k], atol=1e-6)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class _UnpaddedTailJaxEngine(JaxEngine):
    """The oracle: the JAX Engine with its padded tail replaced by JAX
    ``prefill_step`` over the full chunks plus the unpadded tail (decode
    is the JAX Engine's own ``decode_step`` loop)."""

    def _prefill_single(self, req):
        ck = self.scfg.prefill_chunk
        prompt = req.prompt
        plen = len(prompt)
        single = JT.init_cache(self.cfg, 1, self.scfg.max_len)
        for lo in range(0, plen, ck):
            hi = min(lo + ck, plen)
            logits, single = self._prefill(
                self.params, single, tokens=jnp.asarray(prompt[None, lo:hi]), pos=lo)
        tok = self._sample_host(np.asarray(logits)[0], req.uid, 0)
        req.out_tokens.append(tok)
        done = (len(req.out_tokens) >= req.max_new_tokens or tok == self.scfg.eos_id
                or plen + 1 >= self.scfg.max_len)
        return single, done


def _run_jax(engine_cls, jp, jcfg, prompts, budgets, **scfg):
    """A JAX engine's requests, with the logits behind every token."""
    eng = engine_cls(jp, jcfg, JaxServeConfig(**scfg))
    eng._prefill = _jit(JT.prefill_step, cfg=jcfg, attn_impl="dense")
    eng._decode = _jit(JT.decode_step, cfg=jcfg, attn_impl="dense")
    logits = {}
    sample_host, decode = eng._sample_host, eng._decode

    def record_prefill(row, uid, ngen):
        logits[uid, ngen] = np.asarray(row, np.float32)
        return sample_host(row, uid, ngen)

    def record_decode(*args, **kw):
        out = decode(*args, **kw)
        lg = np.asarray(out[0], np.float32)
        for slot, req in enumerate(eng.active):
            if req is not None:
                logits[req.uid, len(req.out_tokens)] = lg[slot]
        return out

    eng._sample_host, eng._decode = record_prefill, record_decode
    reqs = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    eng.run_until_drained()
    return reqs, logits


def _run_port(tp, tcfg, prompts, budgets, **scfg):
    eng = Engine(tp, tcfg, ServeConfig(**scfg), device="cpu")
    reqs = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    done = eng.run_until_drained()
    assert len(done) == len(reqs) and all(r.done and r.status == "ok" for r in reqs)
    return reqs, eng


def _assert_same_tokens(jreqs, jlogits, treqs, dtype):
    """Identical out_tokens; in bf16 a request may part from the JAX
    tokens only where the JAX top-2 margin is at most one bf16 ulp."""
    for jr, tr in zip(jreqs, treqs):
        assert len(tr.out_tokens) == len(jr.out_tokens)
        if tr.out_tokens == jr.out_tokens:
            continue
        k = next(i for i, (a, b) in enumerate(zip(jr.out_tokens, tr.out_tokens)) if a != b)
        top2 = np.sort(jlogits[jr.uid, k])[-2:]
        margin = (top2[1] - top2[0]) / bf16_ulp(top2[1])
        assert dtype == "bf16" and margin <= 1, (jr.uid, k, margin)


def _workload():
    """tests/test_serve_pipeline.py's 14 requests: prompts of 1-8 tokens
    through 8 slots, budgets of 1-7."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 512, size=int(rng.integers(1, 9))) for _ in range(14)]
    budgets = [int(b) for b in rng.integers(1, 8, size=14)]
    return prompts, budgets


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_engine_chunk_aligned_prompts_match_jax_engine(dtype):
    """Prompts of 4 and 8 tokens (prefill_chunk 4, no tail): the JAX
    Engine is right there, and the port gives its tokens."""
    jcfg, tcfg, jp, tp = _models(dtype)
    prompts, budgets = _workload()
    prompts = [np.resize(p, -(-len(p) // 4) * 4) for p in prompts]
    jreqs, jlogits = _run_jax(JaxEngine, jp, jcfg, prompts, budgets, **WORKLOAD)
    treqs, eng = _run_port(tp, tcfg, prompts, budgets, **WORKLOAD)
    _assert_same_tokens(jreqs, jlogits, treqs, dtype)
    assert eng.decode_steps > 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_engine_ragged_prompts_match_unpadded_jax_oracle(dtype):
    """The 14 ragged requests against the JAX oracle with an unpadded
    tail (not the JAX Engine, which pads the tail into the SSM state)."""
    jcfg, tcfg, jp, tp = _models(dtype)
    prompts, budgets = _workload()
    assert any(len(p) % 4 for p in prompts) and any(len(p) > 4 for p in prompts)
    jreqs, jlogits = _run_jax(_UnpaddedTailJaxEngine, jp, jcfg, prompts, budgets, **WORKLOAD)
    treqs, _ = _run_port(tp, tcfg, prompts, budgets, **WORKLOAD)
    _assert_same_tokens(jreqs, jlogits, treqs, dtype)


def test_jax_engine_padded_ssm_tail_parts_from_oracle():
    """The reference's fault the port does not copy (ROADMAP C): the JAX
    Engine pads a ragged tail, and a Mamba block folds the pad tokens
    into its state.  Unpadded (prefill_chunk 2 divides the prompt) the
    JAX Engine agrees with the oracle; padded (chunk 4) it does not,
    while the port's Engine with the padded chunk size agrees."""
    jcfg, tcfg, jp, tp = _models("f32")
    prompt, scfg = np.array([5, 9, 2, 7, 3, 1]), dict(max_batch=1, max_len=32, max_new_tokens=4)
    runs = {
        name: _run_jax(cls, jp, jcfg, [prompt], [4], prefill_chunk=ck, **scfg)[0][0].out_tokens
        for name, cls, ck in (("unpadded", JaxEngine, 2), ("padded", JaxEngine, 4),
                              ("oracle", _UnpaddedTailJaxEngine, 4))
    }
    port = _run_port(tp, tcfg, [prompt], [4], prefill_chunk=4, **scfg)[0][0].out_tokens
    assert runs["unpadded"] == runs["oracle"] == port
    assert runs["padded"] != runs["oracle"]


@pytest.fixture(scope="module")
def small_model():
    _, tcfg, _, tp = _models("f32")
    return tcfg, tp


def greedy_by_decode(small_model, prompt, n_new):
    """The token-by-token oracle: every prompt token through
    ``decode_step`` from an empty cache, then greedy decoding."""
    cfg, params = small_model
    cache = T.init_cache(cfg, 1, 64, device="cpu")
    toks = list(prompt)
    for i in range(len(toks) + n_new - 1):
        lg, cache = T.decode_step(params, cache, cfg, tokens=torch.as_tensor([toks[i]]),
                                  lengths=torch.tensor([i]))
        if i >= len(prompt) - 1:
            toks.append(int(lg[0].argmax()))
    return toks[len(prompt):]


def _engine(small_model, **kw):
    cfg, params = small_model
    base = dict(max_batch=2, max_len=64, prefill_chunk=4, max_new_tokens=6)
    base.update(kw)
    return Engine(params, cfg, ServeConfig(**base), device="cpu")


def test_max_new_tokens_one(small_model):
    """A budget of 1 completes on the prefill-sampled token alone."""
    eng = _engine(small_model, max_new_tokens=1)
    req = eng.submit(np.array([5, 9, 2]))
    done = eng.run_until_drained()
    assert req.done and req in done and len(req.out_tokens) == 1
    assert req.out_tokens == greedy_by_decode(small_model, [5, 9, 2], 1)
    assert all(r is None for r in eng.active) and eng.decode_steps == 0


def test_ragged_tail_near_cache_end(small_model):
    """max_len not a multiple of prefill_chunk: plen 17 leaves a tail of
    one token at 16 (unpadded, so nothing is cut at the cache end)."""
    eng = _engine(small_model, max_batch=1, max_len=20, prefill_chunk=16, max_new_tokens=2)
    prompt = np.arange(1, 18, dtype=np.int32)
    req = eng.submit(prompt)
    eng.run_until_drained()
    assert req.out_tokens == greedy_by_decode(small_model, prompt, 2)


def test_tail_longer_than_the_ssd_chunk(small_model):
    """prefill_chunk 16 over SSD chunks of 8: a tail of 11 runs as 8 + 3."""
    cfg, _ = small_model
    assert cfg.ssm.chunk_size == 8
    eng = _engine(small_model, max_batch=1, max_len=40, prefill_chunk=16, max_new_tokens=3)
    calls = []
    prefill = eng._prefill
    eng._prefill = lambda *a, **kw: calls.append((kw["pos"], kw["tokens"].shape[1])) or prefill(*a, **kw)
    prompt = np.arange(1, 28, dtype=np.int32)
    req = eng.submit(prompt)
    eng.run_until_drained()
    assert calls == [(0, 16), (16, 8), (24, 3)]
    assert req.out_tokens == greedy_by_decode(small_model, prompt, 3)


def test_max_len_boundary(small_model):
    max_len = 16
    eng = _engine(small_model, max_len=max_len, max_new_tokens=64)
    near = eng.submit(np.arange(1, max_len - 2, dtype=np.int32))  # plen=13
    long_lived = eng.submit(np.array([2, 3]))
    steps = 0
    while (eng.queue or any(r is not None for r in eng.active)) and steps < 80:
        eng.step()
        steps += 1
        assert int(eng.lengths.max()) <= max_len - 1
    # the last cache row stays free: 16 - 13 = 3 tokens fit
    assert near.done and len(near.out_tokens) == max_len - 13 and long_lived.done
    assert near.out_tokens == greedy_by_decode(small_model, near.prompt, 3)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def test_registry_has_the_ssd_and_rmsnorm_ops(monkeypatch):
    assert {"ssd", "rmsnorm"} <= set(K.OPS) and {"ssd", "rmsnorm"} <= set(K.SOURCES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert K.get_impl("ssd", "plain") is ssd_chunked_ref
    assert K.get_impl("rmsnorm", "plain") is rmsnorm_ref
    for op in ("ssd", "rmsnorm"):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            K.get_impl(op, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    # the wrappers, behind the training guard (kernels.no_backward)
    assert K.get_impl("ssd", "cuda").__wrapped__ is ssd_ops.ssd_chunked_cuda
    assert K.get_impl("rmsnorm", "auto").__wrapped__ is rms_ops.rmsnorm

