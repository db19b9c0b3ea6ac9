"""The tensor draw of repro_torch.serve.prng (the StreamEngine's sampler
on the device), on the CPU: its words equal the numpy generator's bit for
bit, and through it ``jax.random``'s; its Gumbel noise is within two fp32
ulps of max(|g|, 1) of JAX's (the numpy generator's bound) and, with the
same fp64 logs, equal to the numpy noise; its tokens are JAX's
``sample_token``'s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import sample_token as jax_sample_token
from repro_torch.serve import prng
from repro_torch.serve.engine import sample_token, sample_token_t

TINY = np.finfo(np.float32).tiny
UIDS = np.array([0, 1, 2, 3, 7, 11, 12, 2**31 - 1], np.int32)
NGENS = np.array([0, 5, 1, 1, 2, 0, 3, 9], np.int32)


def _keys(seed):
    return (prng.request_key(seed, UIDS, NGENS),
            prng.request_key_t(seed, torch.as_tensor(UIDS), torch.as_tensor(NGENS)))


def _same_words(numpy_u32, tensor_i64):
    assert tensor_i64.dtype == torch.int64
    np.testing.assert_array_equal(numpy_u32.astype(np.int64), tensor_i64.numpy())


@pytest.mark.parametrize("seed", [0, 11, 2**31 - 1, 2**32 + 5])
def test_request_keys_equal_numpy_and_jax(seed):
    kn, kt = _keys(seed)
    _same_words(kn, kt)
    for row, (u, g) in enumerate(zip(UIDS, NGENS)):
        want = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), int(u)), int(g))
        np.testing.assert_array_equal(
            kt[row].numpy(), np.asarray(jax.random.key_data(want)).astype(np.int64))


@pytest.mark.parametrize("n", [2, 7, 1001])
def test_threefry_words_equal_numpy(n):
    rng = np.random.default_rng(n)
    x0, x1 = (rng.integers(0, 2**32, size=n, dtype=np.uint32) for _ in range(2))
    key = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32)
    y = prng.threefry2x32(key, x0, x1)
    yt = prng.threefry2x32_t(torch.as_tensor(key.astype(np.int64)),
                             torch.as_tensor(x0.astype(np.int64)), torch.as_tensor(x1.astype(np.int64)))
    for a, b in zip(y, yt):
        _same_words(a, b)


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (50304,)])
@pytest.mark.parametrize("seed", [0, 11])
def test_bits_and_uniforms_equal_numpy(seed, shape):
    kn, kt = _keys(seed)
    _same_words(prng.random_bits(kn, shape), prng.random_bits_t(kt, shape))
    for minval in (0.0, TINY):
        un = prng.uniform(kn, shape, minval=minval)
        ut = prng.uniform_t(kt, shape, minval=minval)
        assert ut.dtype == torch.float32
        np.testing.assert_array_equal(un.view(np.uint32), ut.numpy().view(np.uint32))


@pytest.mark.parametrize("seed", [0, 11, 77])
def test_gumbel_noise_against_numpy_and_jax(seed):
    v = 50304
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.gumbel(key, (v,), jnp.float32))
    got = prng.gumbel_t(torch.as_tensor(np.asarray(jax.random.key_data(key)).astype(np.int64)),
                        (v,)).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    assert (np.abs(got.astype(np.float64) - want) <= 2 * ulp).all()
    np.testing.assert_array_equal(got, prng.gumbel(prng.PRNGKey(seed), (v,)))


@pytest.mark.parametrize("v", [512, 50304])
@pytest.mark.parametrize("temperature", [0.8, 0.9, 1.1])
def test_tokens_equal_jax_and_the_host_draw(temperature, v):
    lg = (np.random.default_rng(2).normal(size=(8, v)) * 3).astype(np.float32)
    got = sample_token_t(torch.as_tensor(lg), temperature, 11,
                         torch.as_tensor(UIDS), torch.as_tensor(NGENS))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_sample_token(lg, temperature, 11, UIDS, NGENS)))
    np.testing.assert_array_equal(got.numpy(), sample_token(lg, temperature, 11, UIDS, NGENS))


def test_greedy_takes_the_first_maximum_and_temperature_takes_fp32():
    lg = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 0.0, 3.0]])
    assert sample_token_t(lg, 0.0, 0, None, None).tolist() == [1, 0]
    with pytest.raises(TypeError, match="fp32"):
        sample_token_t(lg.double(), 0.9, 0, torch.zeros(2, dtype=torch.int32),
                       torch.zeros(2, dtype=torch.int32))
