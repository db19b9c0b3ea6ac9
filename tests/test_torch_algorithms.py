"""The paper's two algorithms in repro_torch against the JAX package.

Limb arithmetic against Python ints and ``repro.algorithms.limb``; the
sieve against ``reference_primes`` and the JAX sieve's prime slots;
``times``, ``times_into`` and ``times_dense`` at 4 and 12 limbs against
``reference_product`` and the JAX results.  Integer results must be
bitwise the reference's: keys, limbs, and the order of the lanes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algorithms import limb as jlimb
from repro.algorithms import polynomial as jpoly
from repro.algorithms import sieve as jsieve
from repro.configs.paper_stream import CONFIG as JCONFIG
from repro_torch.algorithms import limb
from repro_torch.algorithms import polynomial as poly
from repro_torch.algorithms import sieve
from repro_torch.configs.paper_stream import CONFIG
from repro_torch.core import LazyEvaluator

BIG = 100000000001


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# limb
# ---------------------------------------------------------------------------

PAIRS = [(0, 0), (1, 2**52 - 1), (2**45 + 17, 2**45 - 3), (12345678901234, 98765432109),
         (2**89 - 1, 2**89 - 1), (3 * 2**60, 7)]


@pytest.mark.parametrize("a,b", PAIRS)
@pytest.mark.parametrize("num_limbs", [4, 8, 12])
def test_limb_add_mul(a, b, num_limbs):
    mod = 1 << (13 * num_limbs)
    a, b = a % mod, b % mod
    la, lb = limb.from_int(a, num_limbs, "cpu"), limb.from_int(b, num_limbs, "cpu")
    assert la.dtype == torch.int32
    s, p = limb.add(la, lb), limb.mul(la, lb)
    assert limb.to_int(s) == (a + b) % mod and limb.to_int(p) == (a * b) % mod
    ja, jb = jlimb.from_int(a, num_limbs), jlimb.from_int(b, num_limbs)
    _same(la, ja)
    _same(s, jlimb.add(ja, jb))
    _same(p, jlimb.mul(ja, jb))


@pytest.mark.parametrize("num_limbs", [4, 12, 20, 32])
def test_limb_batched_mul_and_normalize(num_limbs):
    """Broadcast products and the staged normalization past 16 partial
    products, on raw limbs above the base."""
    rng = np.random.default_rng(num_limbs)
    a = rng.integers(0, 1 << 13, size=(5, 3, num_limbs), dtype=np.int32)
    b = rng.integers(0, 1 << 13, size=(1, 3, num_limbs), dtype=np.int32)
    _same(limb.mul(torch.as_tensor(a), torch.as_tensor(b)), jlimb.mul(jnp.asarray(a), jnp.asarray(b)))
    raw = rng.integers(0, 1 << 26, size=(7, num_limbs), dtype=np.int32)
    _same(limb.normalize(torch.as_tensor(raw)), jlimb.normalize(jnp.asarray(raw)))


def test_limb_helpers():
    with pytest.raises(OverflowError):
        limb.from_int(1 << 26, 2, "cpu")
    with pytest.raises(ValueError, match="MAX_LIMBS"):
        limb.mul(torch.zeros(33, dtype=torch.int32), torch.zeros(33, dtype=torch.int32))
    assert bool(limb.is_zero(limb.from_int(0, 4, "cpu")))
    assert not bool(limb.is_zero(limb.from_int(7, 4, "cpu")))
    w = limb.widen(limb.from_int(2**40 + 5, 4, "cpu"), 6)
    _same(w, jlimb.widen(jlimb.from_int(2**40 + 5, 4), 6))
    with pytest.raises(ValueError):
        limb.widen(w, 4)


# ---------------------------------------------------------------------------
# sieve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("limit,block,k", [
    (10, 8, 1), (97, 16, 2), (500, 32, 1), (500, 32, 8), (1200, 64, 4), (2000, 128, 16),
])
def test_sieve_matches_jax_and_eratosthenes(limit, block, k):
    ref = sieve.reference_primes(limit)
    np.testing.assert_array_equal(ref, jsieve.reference_primes(limit))
    p, count = sieve.run_sieve(limit, block_size=block, primes_per_cell=k,
                               evaluator=LazyEvaluator(), device="cpu")
    jp, jcount = jsieve.run_sieve(limit, block_size=block, primes_per_cell=k)
    _same(p, jp)
    assert int(count) == int(jcount) == len(ref)
    p = _np(p)
    np.testing.assert_array_equal(p[p > 0], ref)


def test_sieve_cell_matches_jax():
    """One cell on a block whose front is composite, with free and
    claimed slots, and on an all-invalid block (nothing to claim)."""
    values = np.arange(10, 42, dtype=np.int32)
    for valid in (values % 3 != 0, np.zeros(32, bool)):
        state = np.array([2, 0, 0, 5], np.int32)
        got = sieve.sieve_cell(torch.as_tensor(state),
                               {"value": torch.as_tensor(values), "valid": torch.as_tensor(valid)})
        want = jsieve.sieve_cell(jnp.asarray(state),
                                 {"value": jnp.asarray(values), "valid": jnp.asarray(valid)})
        _same(got[0], want[0])
        _same(got[1]["valid"], want[1]["valid"])


def test_sieve_stream_shapes():
    s = sieve.sieve_stream(1000, block_size=64, primes_per_cell=4, device="cpu")
    js = jsieve.sieve_stream(1000, block_size=64, primes_per_cell=4)
    assert s.num_items == js.num_items and s.num_cells == js.num_cells


# ---------------------------------------------------------------------------
# polynomials
# ---------------------------------------------------------------------------


def _polys(power, capacity, num_limbs, big):
    x = poly.fateman_poly(power, capacity, num_limbs, big, device="cpu")
    jx = jpoly.fateman_poly(power, capacity, num_limbs, big)
    _same(x.keys, jx.keys)
    _same(x.coeffs, jx.coeffs)
    return x, jx


def _same_poly(a, b):
    _same(a.keys, b.keys)
    _same(a.coeffs, b.coeffs)


def _reference(x, y, num_limbs):
    """reference_product with coefficients reduced mod 2^(13 L), as the
    limb arithmetic wraps; terms that reduce to 0 dropped."""
    mod = 1 << (13 * num_limbs)
    ref = poly.reference_product(poly.to_dict(x), poly.to_dict(y))
    return {k: v % mod for k, v in ref.items() if v % mod}


@pytest.mark.parametrize("big", [1, BIG])
@pytest.mark.parametrize("num_limbs", [4, 12])
@pytest.mark.parametrize("power,capacity,chunks,terms", [(2, 16, 2, 2), (3, 32, 4, 8), (4, 36, 1, 4)])
def test_times_matches_jax(power, capacity, chunks, terms, num_limbs, big):
    x, jx = _polys(power, capacity, num_limbs, big)
    got = poly.times(x, x, num_x_chunks=chunks, terms_per_cell=terms, acc_capacity=512)
    want = jpoly.times(jx, jx, num_x_chunks=chunks, terms_per_cell=terms, acc_capacity=512)
    _same_poly(got, want)
    assert poly.to_dict(got) == _reference(x, x, num_limbs)


@pytest.mark.parametrize("num_limbs,big", [(4, 1), (12, BIG)])
def test_times_into_matches_jax(num_limbs, big):
    x, jx = _polys(3, 32, num_limbs, big)
    tz = {(2, 2, 0): 7 * big, (0, 0, 0): 5, (1, 1, 1): 2**40}
    z = poly.from_dict(tz, 8, num_limbs, device="cpu")
    jz = jpoly.from_dict(tz, 8, num_limbs)
    got = poly.times_into(x, x, z, num_x_chunks=4, terms_per_cell=2, acc_capacity=256)
    want = jpoly.times_into(jx, jx, jz, num_x_chunks=4, terms_per_cell=2, acc_capacity=256)
    _same_poly(got, want)
    ref = poly.reference_product(poly.to_dict(x), poly.to_dict(x))
    for k, v in tz.items():
        ref[k] = ref.get(k, 0) + v
    mod = 1 << (13 * num_limbs)
    assert poly.to_dict(got) == {k: v % mod for k, v in ref.items() if v % mod}


@pytest.mark.parametrize("big", [1, BIG])
@pytest.mark.parametrize("num_limbs", [4, 12])
@pytest.mark.parametrize("power,capacity", [(2, 16), (5, 64)])
def test_times_dense_matches_jax(power, capacity, num_limbs, big):
    x, jx = _polys(power, capacity, num_limbs, big)
    got = poly.times_dense(x, x, capacity=512)
    _same_poly(got, jpoly.times_dense(jx, jx, capacity=512))
    assert poly.to_dict(got) == _reference(x, x, num_limbs)


def test_stream_wraps_where_four_limbs_overflow():
    """(1+x+y+z)^6 times 100000000001, squared, has coefficients past
    2^52: 4 limbs give the product mod 2^52, as JAX's do."""
    x, jx = _polys(6, 96, 4, BIG)
    got = poly.times(x, x, num_x_chunks=4, terms_per_cell=8, acc_capacity=1024)
    want = jpoly.times(jx, jx, num_x_chunks=4, terms_per_cell=8, acc_capacity=1024)
    _same_poly(got, want)
    ref = poly.reference_product(poly.to_dict(x), poly.to_dict(x))
    assert max(ref.values()) >= 1 << 52
    assert poly.to_dict(got) == _reference(x, x, 4)


def test_plus_cancellation_clears_lane():
    mod = 1 << (13 * 4)
    a = poly.from_dict({(1, 0, 0): 5}, 4, 4, device="cpu")
    b = poly.from_dict({(1, 0, 0): mod - 5}, 4, 4, device="cpu")
    out = poly.plus(a, b, capacity=8)
    assert poly.to_dict(out) == {} and int(poly.num_terms(out)) == 0
    ja = jpoly.from_dict({(1, 0, 0): 5}, 4, 4)
    jb = jpoly.from_dict({(1, 0, 0): mod - 5}, 4, 4)
    _same_poly(out, jpoly.plus(ja, jb, capacity=8))


@pytest.mark.parametrize("capacity", [6, 16])
def test_compact_and_multiply_term_match_jax(capacity):
    terms = {(3, 0, 1): 9, (0, 0, 0): 4, (1, 2, 0): 2**30}
    p = poly.from_dict(terms, 12, 4, device="cpu")
    jp = jpoly.from_dict(terms, 12, 4)
    m, c = poly.pack_key((1, 1, 0)), 2**20 + 3
    got = poly.multiply_term(p, torch.tensor(m, dtype=torch.int32), limb.from_int(c, 4, "cpu"))
    want = jpoly.multiply_term(jp, jnp.int32(m), jlimb.from_int(c, 4))
    _same_poly(got, want)
    _same_poly(poly.compact(got, capacity), jpoly.compact(want, capacity))


def test_key_packing_roundtrip():
    for e in [(0, 0, 0), (5, 3, 1), (40, 40, 40)]:
        assert poly.unpack_key(poly.pack_key(e)) == e
        assert poly.pack_key(e) == jpoly.pack_key(e)


def test_paper_stream_config_is_the_reference():
    assert CONFIG == type(CONFIG)(**{f: getattr(JCONFIG, f) for f in JCONFIG.__dataclass_fields__})
