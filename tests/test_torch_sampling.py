"""Temperature sampling in repro_torch against jax.random and the JAX Engine.

The port rebuilds ``jax.random``'s threefry generator in numpy
(``repro_torch.serve.prng``): keys, folds, bits and uniforms must be
bitwise JAX's; Gumbel noise agrees to two fp32 ulps of max(|g|, 1)
(XLA's fp32 log is faithful, the port's correctly rounded); sampled
tokens must be the JAX ``sample_token``'s and the JAX ``Engine``'s.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.prng import threefry_2x32

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.models.params import init_params as jax_init_params
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import sample_token as jax_sample_token
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.serve import engine as E
from repro_torch.serve import prng
from repro_torch.serve.engine import Engine, ServeConfig, sample_token

SEEDS = [0, 11, 12345, 2**31 - 1, 2**32 + 5]
TINY = np.finfo(np.float32).tiny


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    _bits_equal(prng.PRNGKey(seed), jax.random.key_data(_jkey(seed)))


@pytest.mark.parametrize("n", [2, 7, 64, 1001])
@pytest.mark.parametrize("seed", [0, 11, 2**31 - 1])
def test_threefry_words(seed, n):
    """The hash itself, on the counter halves ``threefry_2x32`` splits a
    count vector into (padded with a 0 where n is odd)."""
    count = np.random.default_rng(n).integers(0, 2**32, size=n, dtype=np.uint32)
    key = prng.PRNGKey(seed)
    padded = np.concatenate([count, np.zeros(n % 2, np.uint32)])
    y0, y1 = prng.threefry2x32(key, padded[: len(padded) // 2], padded[len(padded) // 2:])
    got = np.concatenate([y0, y1])[:n]
    want = threefry_2x32(jnp.asarray(key), jnp.asarray(count))
    _bits_equal(got, want)


@pytest.mark.parametrize("data", [0, 1, 7, 4242, 2**31 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed, data):
    got = prng.fold_in(prng.PRNGKey(seed), data)
    _bits_equal(got, jax.random.key_data(jax.random.fold_in(_jkey(seed), data)))
    # twice, as the serving key is built
    got2 = prng.fold_in(got, data + 3)
    want2 = jax.random.fold_in(jax.random.fold_in(_jkey(seed), data), data + 3)
    _bits_equal(got2, jax.random.key_data(want2))


def test_fold_in_batched_equals_one_by_one():
    uids, ngens = np.array([0, 3, 9, 3], np.int32), np.array([0, 0, 4, 5], np.int32)
    keys = prng.request_key(11, uids, ngens)
    for row, u, g in zip(keys, uids, ngens):
        _bits_equal(row, prng.request_key(11, int(u), int(g)))


@pytest.mark.parametrize("shape", [(1,), (7,), (512,), (3, 5), (2, 513), (50304,)])
@pytest.mark.parametrize("seed", [0, 11, 2**31 - 1])
def test_random_bits(seed, shape):
    _bits_equal(prng.random_bits(prng.PRNGKey(seed), shape),
                jax.random.bits(_jkey(seed), shape, jnp.uint32))


@pytest.mark.parametrize("minval", [0.0, TINY])
@pytest.mark.parametrize("shape", [(9,), (4, 33), (50304,)])
@pytest.mark.parametrize("seed", [0, 11])
def test_uniform_bitwise(seed, shape, minval):
    got = prng.uniform(prng.PRNGKey(seed), shape, minval=minval, maxval=1.0)
    want = jax.random.uniform(_jkey(seed), shape, jnp.float32, minval=minval, maxval=1.0)
    _bits_equal(got, want)


@pytest.mark.parametrize("shape", [(1000,), (8, 512), (50304,)])
@pytest.mark.parametrize("seed", [0, 11, 77])
def test_gumbel_within_two_ulps(seed, shape):
    got = prng.gumbel(prng.PRNGKey(seed), shape)
    want = np.asarray(jax.random.gumbel(_jkey(seed), shape, jnp.float32))
    assert got.dtype == np.float32 and got.shape == want.shape
    ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    assert (np.abs(got.astype(np.float64) - want) <= 2 * ulp).all()
    assert (got == want).mean() > 0.5


def _logits(b, v, seed):
    return (np.random.default_rng(seed).normal(size=(b, v)) * 3).astype(np.float32)


@pytest.mark.parametrize("v", [512, 50304])
@pytest.mark.parametrize("temperature", [0.8, 0.9, 1.1])
def test_sample_token_one_row(temperature, v):
    lg = _logits(6, v, 1)
    for row, (uid, ngen) in enumerate([(0, 0), (1, 0), (5, 3), (9, 1), (13, 30), (2, 4)]):
        got = sample_token(lg[row], temperature, 11, uid, ngen)
        want = jax_sample_token(lg[row], temperature, 11, uid, ngen)
        assert got.dtype == np.int32 and got.shape == ()
        assert int(got) == int(want), (row, uid, ngen)
        # a tensor draws the same token on its device
        on_device = sample_token(torch.as_tensor(lg[row]), temperature, 11, uid, ngen)
        assert on_device.dtype == torch.int32 and on_device.shape == ()
        assert int(on_device) == int(got), (row, uid, ngen)


@pytest.mark.parametrize("v", [512, 50304])
@pytest.mark.parametrize("temperature", [0.8, 0.9, 1.1])
def test_sample_token_batched(temperature, v):
    lg = _logits(8, v, 2)
    uids = np.array([0, 1, 2, 3, 7, 11, 12, 40], np.int32)
    ngens = np.array([0, 5, 1, 1, 2, 0, 3, 9], np.int32)
    got = sample_token(lg, temperature, 11, uids, ngens)
    want = np.asarray(jax_sample_token(lg, temperature, 11, uids, ngens))
    np.testing.assert_array_equal(got, want)
    rows = [int(sample_token(lg[i], temperature, 11, int(u), int(g)))
            for i, (u, g) in enumerate(zip(uids, ngens))]
    np.testing.assert_array_equal(got, rows)
    # a tensor draws the same tokens on its device
    on_device = sample_token(torch.as_tensor(lg), temperature, 11, uids, ngens)
    assert on_device.dtype == torch.int32 and on_device.shape == (8,)
    np.testing.assert_array_equal(on_device.numpy(), got)


def test_sample_token_checks_its_inputs():
    for as_input in (np.asarray, torch.as_tensor):
        with pytest.raises(TypeError, match="fp32"):
            sample_token(as_input(np.zeros(4, np.float64)), 0.9, 0, 0, 0)
        with pytest.raises(ValueError, match="one"):
            sample_token(as_input(np.zeros((3, 4), np.float32)), 0.9, 0, np.arange(2),
                         np.arange(2))
        with pytest.raises(ValueError, match="one"):
            sample_token(as_input(np.zeros((3, 4), np.float32)), 0.9, 0, 0, 0)
        # greedy keeps first-max tie-breaking and takes any dtype
        assert int(sample_token(as_input(np.array([0.0, 2.0, 2.0, 1.0])), 0.0, 0, 0, 0)) == 1


@pytest.mark.parametrize("v", [512, 50304])
@pytest.mark.parametrize("batch", [None, 8], ids=["row", "batch"])
def test_sample_token_greedy_on_a_tensor_equals_numpy(batch, v):
    """Greedy over a tensor, ``(V,)`` or ``(B, V)``, is the host argmax
    with its first-max tie-breaking: rows with a maximum planted twice,
    before and after the row's own maximum, take the first."""
    lg = _logits(8, v, 3)
    for row, at in ((1, 0), (4, v - 1), (6, 17)):
        lg[row, at] = lg[row].max()
    lg = lg if batch else lg[4]
    got = sample_token(torch.as_tensor(lg), 0.0, 11, None, None)
    want = sample_token(lg, 0.0, 11, None, None)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if batch:
        assert want[1] == 0  # the maximum planted first


# ---------------------------------------------------------------------------
# Where the Engine draws: every draw hands sample_token the logits tensor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "t0.9"])
def test_the_engine_hands_the_draw_a_tensor(monkeypatch, temperature):
    """Every call that ``Engine.step`` and ``_prefill_single`` make to the
    module's ``sample_token`` passes the logits as a tensor on the
    engine's device, a row ``(V,)`` for an admission and ``(B, V)`` over
    every slot for a decode step, and gets int32 token ids back."""
    cfg = smoke_config(get_config("olmo-1b")).with_overrides(num_layers=2,
                                                                dtype=torch.float32)
    params = init_params(T.model_layout(cfg), seed=0, device="cpu")
    eng = Engine(params, cfg, ServeConfig(max_batch=3, max_len=64, prefill_chunk=4,
                                          max_new_tokens=5, temperature=temperature,
                                          seed=11), device="cpu")
    calls = []
    draw = E.sample_token

    def checked(logits, *args):
        assert isinstance(logits, torch.Tensor) and logits.device == eng.device
        tok = draw(logits, *args)
        assert isinstance(tok, torch.Tensor) and tok.dtype == torch.int32
        assert tok.shape == logits.shape[:-1]
        calls.append(tuple(logits.shape))
        return tok

    monkeypatch.setattr(E, "sample_token", checked)
    rng = np.random.default_rng(5)
    for n, budget in ((3, 5), (6, 1), (9, 4), (2, 3), (5, 5)):
        eng.submit(rng.integers(1, 512, size=n), budget)
    eng.run_until_drained()
    v = cfg.vocab_size
    assert calls.count((v,)) == 5 and calls.count((3, v)) == eng.decode_steps > 0


# ---------------------------------------------------------------------------
# The Engine at temperature 0.9, seed 11, against the JAX Engine
# ---------------------------------------------------------------------------

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
EXACT_BF16 = {"xla_allow_excess_precision": False}
WORKLOAD = dict(max_batch=8, max_len=64, prefill_chunk=4, max_new_tokens=5,
                temperature=0.9, seed=11)


def _workload():
    """tests/test_serve_pipeline.py's workload: its first 10 requests."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 512, size=int(rng.integers(1, 9))) for _ in range(14)]
    budgets = [int(b) for b in rng.integers(1, 8, size=14)]
    return prompts[:10], budgets[:10]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_temperature_engine_matches_jax_engine(dtype):
    jdt, tdt = DTYPES[dtype]
    jcfg = jax_smoke_config(jax_get_config("olmo-1b")).with_overrides(num_layers=8, dtype=jdt)
    tcfg = smoke_config(get_config("olmo-1b")).with_overrides(num_layers=8, dtype=tdt)
    jp = jax_init_params(jax.random.PRNGKey(0), JT.model_layout(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")

    ref = JaxEngine(jp, jcfg, JaxServeConfig(**WORKLOAD))
    ref._prefill = jax.jit(partial(JT.prefill_step, cfg=jcfg, attn_impl="dense"),
                           compiler_options=EXACT_BF16)
    ref._decode = jax.jit(partial(JT.decode_step, cfg=jcfg, attn_impl="dense"),
                          compiler_options=EXACT_BF16)
    eng = Engine(tp, tcfg, ServeConfig(**WORKLOAD), device="cpu")
    prompts, budgets = _workload()
    want = [ref.submit(p, b) for p, b in zip(prompts, budgets)]
    got = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    ref.run_until_drained()
    assert len(eng.run_until_drained()) == 10
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    # the draw is not greedy: some token is not its row's argmax
    greedy = Engine(tp, tcfg, ServeConfig(**dict(WORKLOAD, temperature=0.0)), device="cpu")
    g = [greedy.submit(p, b) for p, b in zip(prompts, budgets)]
    greedy.run_until_drained()
    assert [r.out_tokens for r in g] != [r.out_tokens for r in got]
