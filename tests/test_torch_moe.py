"""repro_torch.models.moe and the MoE model families against the JAX
package on the CPU.

``moe_apply`` on the weights the numpy bridge carries over, with the
JAX side's routes and dispatch buffer read out of its own call (its
``lax.top_k`` and its first ``maybe_constrain``, wrapped while it is
traced): the routes and the buffer (hence every kept assignment's rank
and every ``keep``) are equal exactly, in fp32 and in bf16; so are
they with the dispatch blocked per data shard, as under a mesh.  Then
``forward`` (logits and aux), ``prefill_step`` and ``decode_step`` of
the moonshot, maverick and jamba smoke configs.  The JAX side is
compiled with XLA's excess precision off, so that bf16 is rounded at
every op as PyTorch rounds it (tests/test_torch_transformer.py).
"""
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.params import init_params as jax_init_params
from repro.parallel import sharding as jax_sharding
from repro_torch.configs.base import MoEConfig
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.params import params_from_numpy

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
EXACT_BF16 = {"xla_allow_excess_precision": False}
MOE_ARCHS = ["moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b", "jamba-1.5-large-398b"]

# fp32: the same ops, fp32 sums of d or f terms in another order.
FP32_ATOL = 1e-5
# bf16: both sides round at the same ops; an fp32 sum in another order
# moves a rounding of gate, up, the activation or an expert's output by
# one bf16 ulp now and then, which reaches y through the down product and
# the k + 1 adds: allowed 4 bf16 ulps of each row's largest |y|.
BF16_ULPS = 4
AUX_ATOL = 1e-6


def bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

# name -> (smoke arch whose MoE config is used, (B, S), capacity, extra)
CASES = {
    "no_drops": ("jamba-1.5-large-398b", (2, 4), None, None),
    "forced_drops": ("jamba-1.5-large-398b", (2, 8), 2, None),
    "shared_experts": ("moonshot-v1-16b-a3b", (3, 5), None, None),
    "top1_shared": ("llama4-maverick-400b-a17b", (2, 16), None, None),
    "router_tie": ("jamba-1.5-large-398b", (2, 4), None, "tie"),
    "pad_rows_last": ("moonshot-v1-16b-a3b", (4, 3), 2, "pad"),
}


def _moe_setup(arch, dtype, extra=None):
    jdt, tdt = DTYPES[dtype]
    jcfg = jax_smoke_config(jax_get_config(arch)).with_overrides(dtype=jdt)
    tcfg = smoke_config(get_config(arch)).with_overrides(dtype=tdt)
    jp = jax_init_params(jax.random.PRNGKey(0), JM.moe_layout(jcfg, jcfg.moe))
    if extra == "tie":  # experts 1 and 2 get the same router column
        r = np.asarray(jp["router"]).copy()
        r[:, 2] = r[:, 1]
        jp["router"] = jnp.asarray(r)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@contextlib.contextmanager
def _jax_internals(captured):
    """Wrap the JAX ``moe_apply``'s ``lax.top_k`` and ``maybe_constrain``
    while it is traced: ``captured`` gets its expert ids and its first
    constrained value, the dispatch buffer (DS, E, C, d)."""
    real_top_k, real_constrain = jax.lax.top_k, jax_sharding.maybe_constrain

    def top_k(p, k):
        vals, ids = real_top_k(p, k)
        captured["expert_ids"] = ids
        return vals, ids

    def constrain(x, spec):
        captured.setdefault("buf", x)
        return real_constrain(x, spec)

    with mock.patch.object(JM.lax, "top_k", top_k), \
            mock.patch.object(jax_sharding, "maybe_constrain", constrain):
        yield


def jax_moe(jp, x, jmoe, capacity):
    captured = {}

    def fn(p, x):
        y, aux = JM.moe_apply(p, x, jmoe, capacity=capacity)
        return y, aux, captured["expert_ids"], captured["buf"]

    with _jax_internals(captured):
        return jax.jit(fn, compiler_options=EXACT_BF16)(jp, x)


def _inputs(case, dtype, d):
    _, (b, s), _, extra = CASES[case]
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(5).normal(size=(b, s, d)).astype(np.float32)
    if extra == "pad":  # the last row is padding: token 0's embedding, repeated
        x[-1] = x[0, 0]
    jx = jnp.asarray(x, jdt)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)


def _rank_oracle(ids):
    """Rank of each flat assignment: earlier assignments to its expert."""
    flat, seen, out = ids.reshape(-1), {}, []
    for e in flat.tolist():
        out.append(seen.get(e, 0))
        seen[e] = out[-1] + 1
    return np.array(out)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_jax(case, dtype):
    arch, _, capacity, extra = CASES[case]
    jcfg, tcfg, jp, tp = _moe_setup(arch, dtype, extra)
    jx, tx = _inputs(case, dtype, tcfg.d_model)
    jy, jaux, jids, jbuf = jax_moe(jp, jx, jcfg.moe, capacity)
    with M.record_routes() as routes:
        ty, taux = M.moe_apply(tp, tx, tcfg.moe, capacity=capacity)
    (r,) = routes
    e, c, d = jbuf.shape[1:]
    assert r["capacity"] == c  # the reference's capacity, from its buffer
    ids = r["expert_ids"].numpy()
    np.testing.assert_array_equal(ids, np.asarray(jids))
    rank = r["rank"].numpy()
    np.testing.assert_array_equal(rank, _rank_oracle(ids))
    np.testing.assert_array_equal(r["keep"].numpy(), rank < c)
    # the port's dispatch, written out, is the reference's buffer bitwise
    buf = np.zeros((e * c, d), np.float32)
    keep = r["keep"].numpy()
    flat_tok = np.repeat(np.arange(ids.shape[0]), ids.shape[1])
    dest = ids.reshape(-1) * c + rank
    buf[dest[keep]] = _np(tx).reshape(-1, d)[flat_tok[keep]]
    np.testing.assert_array_equal(buf.reshape(e, c, d), _np(jbuf)[0])

    got, want = _np(ty), _np(jy)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)
    else:
        allowed = BF16_ULPS * bf16_ulp(np.abs(want).max(axis=-1, keepdims=True))
        assert (np.abs(got - want) <= allowed).all(), np.abs(got - want).max()
    for key in ("moe_lb_loss", "moe_z_loss", "moe_drop_fraction"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), atol=AUX_ATOL, rtol=0)

    drop = float(taux["moe_drop_fraction"])
    if case in ("forced_drops", "pad_rows_last"):
        assert drop > 0
    if case in ("no_drops", "shared_experts", "router_tie"):
        assert drop == 0
    if extra == "tie":  # equal probabilities: the lower expert id ranks first
        logits = r["logits"]
        assert torch.equal(logits[:, 1], logits[:, 2])
        both = (ids == 1).any(-1) & (ids == 2).any(-1)
        one = (ids == 1).any(-1) ^ (ids == 2).any(-1)
        assert both.any() or one.any()
        assert not (ids == 2).any(-1)[one].any()  # where one of the pair is in, it is 1
        for row in np.nonzero(both)[0]:
            assert list(ids[row]).index(1) < list(ids[row]).index(2)


# name -> (case of CASES, the (data, model) mesh's shape): the dispatch
# blocked per data shard, as under a mesh
BLOCKED = {
    "forced_drops-data2": ("forced_drops", (2, 2)),
    "no_drops-data4": ("no_drops", (4, 1)),
    "pad_rows_last-data8": ("pad_rows_last", (8, 1)),  # 12 tokens: halved to 4 blocks
    "top1_shared-data2": ("top1_shared", (2, 2)),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(BLOCKED))
def test_blocked_dispatch_matches_jax(name, dtype):
    """Under a mesh the reference blocks the dispatch per data shard
    (``_data_shards``, each block ranked and given capacity on its own);
    the port does the same on plain tensors under an abstract mesh of
    that shape.  The block count is the reference's (its ``_data_shards``
    on a mesh of the same names and sizes), the capacity its buffer's,
    each block's ranks the oracle's, y and aux the reference's."""
    from types import SimpleNamespace

    from repro_torch.parallel import sharding as SH

    case, shape = BLOCKED[name]
    arch, (b, s), capacity, extra = CASES[case]
    jcfg, tcfg, jp, tp = _moe_setup(arch, dtype, extra)
    jx, tx = _inputs(case, dtype, tcfg.d_model)
    fake = SimpleNamespace(empty=False, axis_names=("data", "model"),
                           shape=dict(zip(("data", "model"), shape)))
    with mock.patch.object(JM.compat, "get_abstract_mesh", lambda: fake):
        ds = JM._data_shards(b * s)
    with mock.patch.object(JM, "_data_shards", lambda t: ds):
        jy, jaux, jids, jbuf = jax_moe(jp, jx, jcfg.moe, capacity)
    with SH.set_mesh(SH.AbstractMesh(shape, ("data", "model"))), M.record_routes() as routes:
        assert M._data_shards(b * s) == ds
        ty, taux = M.moe_apply(tp, tx, tcfg.moe, capacity=capacity)
    (r,) = routes
    assert jbuf.shape[0] == ds > 1 and r["capacity"] == jbuf.shape[2]
    ids = r["expert_ids"].numpy()
    np.testing.assert_array_equal(ids, np.asarray(jids))
    want_rank = np.concatenate([_rank_oracle(blk) for blk in np.split(ids, ds)])
    np.testing.assert_array_equal(r["rank"].numpy(), want_rank)
    np.testing.assert_array_equal(r["keep"].numpy(), want_rank < r["capacity"])
    got, want = _np(ty), _np(jy)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)
    else:
        allowed = BF16_ULPS * bf16_ulp(np.abs(want).max(axis=-1, keepdims=True))
        assert (np.abs(got - want) <= allowed).all(), np.abs(got - want).max()
    for key in ("moe_lb_loss", "moe_z_loss", "moe_drop_fraction"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), atol=AUX_ATOL, rtol=0)
    if case == "forced_drops":  # a block's own capacity keeps more than one block's
        _, unblocked = M.moe_apply(tp, tx, tcfg.moe, capacity=capacity)
        assert float(taux["moe_drop_fraction"]) < float(unblocked["moe_drop_fraction"])


def test_pad_rows_never_displace_real_assignments():
    """A padded batch at a capacity that drops: the real rows' outputs
    and kept assignments equal those of the batch without the pad row
    at the same capacity (pads rank after every real assignment)."""
    _, tcfg, _, tp = _moe_setup("moonshot-v1-16b-a3b", "f32")
    _, tx = _inputs("pad_rows_last", "f32", tcfg.d_model)
    with M.record_routes() as routes:
        y_pad, aux_pad = M.moe_apply(tp, tx, tcfg.moe, capacity=2)
        y_real, _ = M.moe_apply(tp, tx[:-1], tcfg.moe, capacity=2)
    n = routes[1]["keep"].numel()
    assert torch.equal(routes[0]["keep"][:n], routes[1]["keep"])
    assert float(aux_pad["moe_drop_fraction"]) > 0
    torch.testing.assert_close(y_pad[:-1], y_real, atol=1e-6, rtol=0)


def test_expert_capacity_is_the_references():
    """The capacity of the JAX dispatch buffer (its shape, traced without
    computing) for token counts around the rounding and the floor of 8."""
    jcfg = jax_smoke_config(jax_get_config("jamba-1.5-large-398b")).with_overrides(
        d_model=16, dtype=jnp.float32)
    for e, k, cf in ((64, 6, 1.25), (16, 2, 1.25), (128, 1, 1.25), (4, 2, 0.3)):
        jmoe = JaxMoEConfig(num_experts=e, top_k=k, d_ff_expert=8, capacity_factor=cf)
        moe = MoEConfig(num_experts=e, top_k=k, d_ff_expert=8, capacity_factor=cf)
        jp = jax.eval_shape(lambda m=jmoe: jax_init_params(jax.random.PRNGKey(0),
                                                           JM.moe_layout(jcfg, m)))
        for t in (1, 8, 37, 128, 1000):
            captured = {}
            with _jax_internals(captured):
                jax.eval_shape(lambda p, x, m=jmoe: JM.moe_apply(p, x, m), jp,
                               jax.ShapeDtypeStruct((1, t, 16), jnp.float32))
            assert captured["buf"].shape[2] == M.expert_capacity(t, moe), (e, k, cf, t)


def test_moe_layout_matches_jax():
    for arch in MOE_ARCHS:
        jcfg = jax_smoke_config(jax_get_config(arch))
        tcfg = smoke_config(get_config(arch))
        jl = JM.moe_layout(jcfg, jcfg.moe, (3,))
        tl = M.moe_layout(tcfg, tcfg.moe, (3,))

        def flat(tree, prefix=()):
            if isinstance(tree, dict):
                return {kk: v for key in tree for kk, v in flat(tree[key], prefix + (key,)).items()}
            return {prefix: tree}

        jf, tf = flat(jl), flat(tl)
        assert jf.keys() == tf.keys()
        for key, js in jf.items():
            ts = tf[key]
            assert ts.shape == js.shape and ts.logical_axes == js.logical_axes, key
            assert str(ts.dtype).removeprefix("torch.") == jnp.dtype(js.dtype).name, key


def test_route_refuses_tf32_on_a_card(monkeypatch):
    """The router product must be fp32: with TF32 on, a CUDA call raises
    (checked on a stand-in tensor that says it is on a card)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)

    class OnCard:
        is_cuda = True

    with pytest.raises(RuntimeError, match="allow_tf32"):
        M.route(torch.zeros(4, 2), OnCard(), 1)


def test_dispatch_ranks_and_spare_row():
    ids = torch.tensor([[0, 1], [1, 0], [1, 2], [1, 0]])
    rank, keep, dest = M.dispatch(ids, 3, 2)
    assert rank.tolist() == [0, 0, 1, 1, 2, 0, 3, 2]
    assert keep.tolist() == [True, True, True, True, False, True, False, False]
    assert dest.tolist() == [0, 2, 3, 1, 6, 4, 6, 6]


# ---------------------------------------------------------------------------
# Models: forward, prefill_step, decode_step
# ---------------------------------------------------------------------------


def build(arch, dtype):
    """Both sides of a smoke MoE model on the same weights.  jamba's
    Mamba blocks get A_log, dt_bias and D values so that every head
    decays at its own rate (tests/test_torch_ssm.py)."""
    jdt, tdt = DTYPES[dtype]
    jcfg = jax_smoke_config(jax_get_config(arch)).with_overrides(dtype=jdt)
    tcfg = smoke_config(get_config(arch)).with_overrides(dtype=tdt, kernels="plain")
    jp = jax_init_params(jax.random.PRNGKey(0), JT.model_layout(jcfg))
    rng = np.random.default_rng(1)
    for blk in jp["blocks"].values():
        if "mamba" in blk:
            m = blk["mamba"]
            shape = m["A_log"].shape
            m["A_log"] = jnp.asarray(rng.uniform(-1.0, 0.7, size=shape), jnp.float32)
            m["dt_bias"] = jnp.asarray(rng.uniform(-2.0, 0.5, size=shape), jnp.float32)
            m["D"] = jnp.asarray(rng.normal(size=shape), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


# fp32 logits: the attention-only models' tolerance of
# tests/test_torch_transformer.py; jamba's 14 Mamba blocks (their SSD
# sums and gated norms) take tests/test_torch_ssm.py's.
FP32_LOGITS_TOL = {"moonshot-v1-16b-a3b": (2e-5, 0), "llama4-maverick-400b-a17b": (2e-5, 0),
                   "jamba-1.5-large-398b": (1e-4, 1e-4)}


def _check_logits(got, want, dtype, arch, want32=None):
    """Port logits against the JAX ones; returns the number of greedy
    tokens compared (bf16 attention-only models).

    bf16 jamba: its Mamba blocks round apart from the reference's by an
    ulp here and there (tests/test_torch_ssm.py), and a router
    probability within that distance of the next one flips a route, so
    the logits part by more than bf16 noise.  With D the distance, per
    row, between the JAX bf16 logits and the JAX logits of the same
    weights in fp32 (``want32``: what serving in bf16 moves them, route
    flips included), two bf16 paths that each lie within D of the fp32
    result lie within 2 D of each other: allowed 2 D."""
    got, want = _np(got), _np(want)
    if dtype == "f32":
        atol, rtol = FP32_LOGITS_TOL[arch]
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
        return 0
    if arch == "jamba-1.5-large-398b":
        drift = np.abs(want - _np(want32)).max(axis=-1, keepdims=True)
        assert (np.abs(got - want) <= 2 * drift).all(), np.abs(got - want).max(-1) / drift[..., 0]
        return 0
    # the greedy token wherever JAX's top-2 margin is wider than one bf16
    # ulp of its top logit (tests/test_torch_transformer.py)
    compared = 0
    for g, w in zip(got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])):
        top2 = np.sort(w)[-2:]
        if top2[1] - top2[0] <= bf16_ulp(top2[1]):
            continue
        compared += 1
        assert g.argmax() == w.argmax()
    return compared


def _jax_sides(arch, dtype):
    """The JAX config and weights of ``build``, and for bf16 jamba those
    of the same weights in fp32 (``_check_logits``'s D), else None."""
    jcfg, tcfg, jp, tp = build(arch, dtype)
    sides = [(jcfg, jp)]
    if dtype == "bf16" and arch == "jamba-1.5-large-398b":
        sides.append((jcfg.with_overrides(dtype=jnp.float32),
                      jax.tree.map(lambda a: a.astype(jnp.float32), jp)))
    return sides, tcfg, tp


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_logits_and_aux_match_jax(arch, dtype):
    sides, tcfg, tp = _jax_sides(arch, dtype)
    toks = jnp.asarray(np.random.default_rng(4).integers(1, tcfg.vocab_size, size=(2, 8)))
    outs = [jax.jit(lambda p, t, c=c: JT.forward(p, c, tokens=t, attn_impl="dense", remat=False),
                    compiler_options=EXACT_BF16)(p, toks) for c, p in sides]
    (jl, _, jaux) = outs[0]
    tl, _, taux = T.forward(tp, tcfg, tokens=torch.as_tensor(np.array(toks)))
    compared = _check_logits(tl, jl, dtype, arch, outs[-1][0])
    assert compared >= 12 or dtype == "f32" or arch == "jamba-1.5-large-398b"
    for key in ("moe_lb_loss", "moe_z_loss", "moe_drop_fraction"):
        assert isinstance(taux[key], torch.Tensor)
        if dtype == "f32":
            np.testing.assert_allclose(float(taux[key]), float(jaux[key]), atol=AUX_ATOL, rtol=0)
        else:  # jamba's bf16 hidden states part by an ulp here and there
            np.testing.assert_allclose(float(taux[key]), float(jaux[key]), atol=AUX_ATOL,
                                       rtol=1e-3)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    """Two 8-token prefill chunks (one SSD chunk of the smoke jamba) then
    three decode steps: logits agree."""
    sides, tcfg, tp = _jax_sides(arch, dtype)
    runs = []
    for jcfg, jp in sides:
        chunk = jax.jit(lambda p, c, t, pos, cfg=jcfg: JT.prefill_step(
            p, c, cfg, tokens=t, pos=pos, attn_impl="dense"),
            static_argnums=(3,), compiler_options=EXACT_BF16)
        decode = jax.jit(lambda p, c, t, n, cfg=jcfg: JT.decode_step(
            p, c, cfg, tokens=t, lengths=n, kernels="xla"), compiler_options=EXACT_BF16)
        runs.append((jp, JT.init_cache(jcfg, 3, 32), chunk, decode))
    rng = np.random.default_rng(2)
    b = 3
    tc = T.init_cache(tcfg, b, 32, device="cpu")
    compared = 0

    def step(jax_call, port_call, toks):
        nonlocal tc
        want = []
        for i, (jp, jc, chunk, decode) in enumerate(runs):
            jl, jc = jax_call(jp, jc, chunk, decode, jnp.asarray(toks))
            runs[i] = (jp, jc, chunk, decode)
            want.append(jl)
        tl, tc = port_call(torch.as_tensor(toks))
        return _check_logits(tl, want[0], dtype, arch, want[-1])

    for pos in (0, 8):
        compared += step(lambda jp, jc, chunk, _, t: chunk(jp, jc, t, pos),
                         lambda t: T.prefill_step(tp, tc, tcfg, tokens=t, pos=pos),
                         rng.integers(1, tcfg.vocab_size, size=(b, 8)))
    lengths = np.array([16, 16, 16], np.int32)
    for _ in range(3):
        n = lengths
        compared += step(lambda jp, jc, _, decode, t: decode(jp, jc, t, jnp.asarray(n)),
                         lambda t: T.decode_step(tp, tc, tcfg, tokens=t,
                                                 lengths=torch.as_tensor(n)),
                         rng.integers(1, tcfg.vocab_size, size=(b,)))
        lengths = lengths + 1
    assert compared >= 10 or dtype == "f32" or arch == "jamba-1.5-large-398b"
