"""The FutureEvaluator of repro_torch on the CPU, against its LazyEvaluator
and the JAX package's.

The program battery is the one tests/test_multidevice.py runs against the
JAX FutureEvaluator (EQUIV, EQUIV_RAGGED, SIEVE, POLY, the combinator
algebra, the two-source zip, feedback unfold, the const-state split),
sized so that every program splits into 2 and 4 stages under every
schedule (8 cells, or a multiple of 8).  Each program runs through the
port's Future evaluator (logical stages on the CPU) and must equal the
port's LazyEvaluator bitwise; the port's Lazy values are held to the JAX
LazyEvaluator on the same numpy inputs (integers bitwise, floats at
rtol = atol = 1e-6: XLA's and PyTorch's tanh differ in the last ulp).

Also here: the reference's errors, the zero-cell path, autograd through
the pipeline, the index a cell sees (:func:`current_item`), and the scan
repair -- a cell that updates its state in place is neither written back
nor copied.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algorithms import polynomial as jpoly
from repro.algorithms import sieve as jsieve
from repro.core import LazyEvaluator as JLazy
from repro.core import Stream as JStream
from repro.core import StreamProgram as JProgram
from repro.core import evaluate as jevaluate
from repro_torch import pytree as P
from repro_torch.algorithms import polynomial as poly
from repro_torch.algorithms import sieve
from repro_torch.core import (
    FutureEvaluator, LazyEvaluator, Stream, StreamProgram, evaluate, ppermute_future,
)
from repro_torch.core import graph as G
from repro_torch.core.stream import indexed_states

ZOO = [("gpipe", 1), ("one_f_one_b", 1), ("interleaved", 2)]

A7 = np.linspace(0, 1, 18, dtype=np.float32).reshape(6, 3)
B7 = np.linspace(1, 2, 18, dtype=np.float32).reshape(6, 3)
W8 = np.arange(8, dtype=np.float32)
W4A = np.arange(4, dtype=np.float32)
W4B = np.linspace(0.5, 1.5, 4, dtype=np.float32)
CST = np.linspace(1.0, 2.0, 8, dtype=np.float32)


def t(a):
    return torch.as_tensor(a)


def j(a):
    return jnp.asarray(a)


# The programs: (port run(ev), JAX run()) -> a pytree of values.  Cells
# are written once per side: a torch version and a jnp version.

def _cell(state, item):
    return state + 1, item * 1.001 + state


def _cell2(w, x):
    return w, torch.tanh(x * w)


def _jcell2(w, x):
    return w, jnp.tanh(x * w)


def _fbcell(s, x):
    return s + 1.0, torch.tanh(x * 1.01) + s * 0.001


def _jfbcell(s, x):
    return s + 1.0, jnp.tanh(x * 1.01) + s * 0.001


def _fbemit(x):
    return x * 0.9 + 1.0


def _ccell(c, s, x):
    return s + 1.0, torch.tanh(x * c) + s * 0.01


def _jccell(c, s, x):
    return s + 1.0, jnp.tanh(x * c) + s * 0.01


def _equiv(m):
    items = np.linspace(0, 1, 3 * m, dtype=np.float32).reshape(m, 3)
    return (
        lambda ev: evaluate(StreamProgram(_cell, t(W8), 8), t(items), ev),
        lambda: jevaluate(JProgram(_cell, j(W8), 8), j(items), JLazy()),
    )


def _sieve():
    def port(ev):
        primes, count = sieve.run_sieve(600, block_size=64, primes_per_cell=2, num_cells=56,
                                        evaluator=ev, device="cpu")
        return primes, count.to(torch.int32)  # a sum: int64 in PyTorch, int32 in JAX

    def ref():
        return jsieve.run_sieve(600, block_size=64, primes_per_cell=2, num_cells=56,
                                evaluator=JLazy())

    return port, ref


def _poly():
    def port(ev):
        x = poly.fateman_poly(3, 40, 6, device="cpu")
        p = poly.times(x, x, evaluator=ev, num_x_chunks=4, terms_per_cell=5,
                       acc_capacity=256)
        return (p.keys, p.coeffs)

    def ref():
        x = jpoly.fateman_poly(3, 40, 6)
        p = jpoly.times(x, x, evaluator=JLazy(), num_x_chunks=4, terms_per_cell=5,
                        acc_capacity=256)
        return (p.keys, p.coeffs)

    return port, ref


def _poly_zip():
    def port(ev):
        x = poly.fateman_poly(3, 24, 6, device="cpu")
        r = poly.times_stream(x, x, num_x_chunks=4, terms_per_cell=3,
                              acc_capacity=256).collect(ev)
        return (r.items, r.states)

    def ref():
        x = jpoly.fateman_poly(3, 24, 6)
        r = jpoly.times_stream(x, x, num_x_chunks=4, terms_per_cell=3,
                               acc_capacity=256).collect(JLazy())
        return (r.items, r.states)

    return port, ref


def _algebra(name):
    def build(S, cell2, a, b, w8, w4a, w4b):
        progs = {
            "map": lambda: S.source(a).map(lambda x: x * 2.0).through(_cell, w8)
            .map(lambda x: x + 1.0),
            "zip_entry": lambda: S.source(a).zip(S.source(b), lambda x, y: x * y)
            .through(_cell, w8),
            "zip_mid": lambda: S.source(a).through(_cell, w4a)
            .zip(S.source(b), lambda f, s: f + s).through(cell2, w4b, mutable_state=False),
            "concat": lambda: S.source(a[:3]).concat(S.source(a[3:])).through(_cell, w8),
            "two_seg": lambda: S.source(a).through(_cell, w4a)
            .through(cell2, w4b, mutable_state=False),
            "mid_map": lambda: S.source(a).through(_cell, w4a).map(lambda x: x * 0.5 + 0.1)
            .through(cell2, w4b, mutable_state=False),
        }
        return progs[name]()

    def port(ev):
        if name == "mask":
            s = (Stream.source(t(A7)).mask(lambda v: v > 0.3)
                 .map(lambda d: d["value"] * d["valid"].to(torch.float32)).through(_cell, t(W8)))
        else:
            s = build(Stream, _cell2, t(A7), t(B7), t(W8), t(W4A), t(W4B))
        r = s.collect(ev)
        return (r.items, r.states)

    def ref():
        if name == "mask":
            s = (JStream.source(j(A7)).mask(lambda v: v > 0.3)
                 .map(lambda d: d["value"] * d["valid"].astype(jnp.float32)).through(_cell, j(W8)))
        else:
            s = build(JStream, _jcell2, j(A7), j(B7), j(W8), j(W4A), j(W4B))
        r = s.collect(JLazy())
        return (r.items, r.states)

    return port, ref


def _feedback(lag, n):
    init = np.linspace(0.0, 1.0, lag * 3, dtype=np.float32).reshape(lag, 3)

    def port(ev):
        r = Stream.feedback(t(init), n, _fbemit).through(_fbcell, t(W8)).collect(ev)
        return (r.items, r.states)

    def ref():
        r = JStream.feedback(j(init), n, _fbemit).through(_jfbcell, j(W8)).collect(JLazy())
        return (r.items, r.states)

    return port, ref


def _const(feedback):
    init = np.linspace(0.0, 1.0, 12, dtype=np.float32).reshape(4, 3)

    def port(ev):
        src = Stream.feedback(t(init), 16, _fbemit) if feedback else Stream.source(t(A7))
        r = src.through(_ccell, t(W8), const_state=t(CST)).collect(ev)
        return (r.items, r.states)

    def ref():
        src = JStream.feedback(j(init), 16, _fbemit) if feedback else JStream.source(j(A7))
        r = src.through(_jccell, j(W8), const_state=j(CST)).collect(JLazy())
        return (r.items, r.states)

    return port, ref


PROGRAMS = {
    "equiv": _equiv(6),
    "equiv_ragged": _equiv(5),
    "sieve": _sieve(),
    "poly": _poly(),
    "poly_zip": _poly_zip(),
    **{f"algebra_{n}": _algebra(n) for n in
       ("map", "zip_entry", "zip_mid", "concat", "mask", "two_seg", "mid_map")},
    "feedback_8_24": _feedback(8, 24),
    "feedback_4_16": _feedback(4, 16),
    "feedback_3_14": _feedback(3, 14),
    "const": _const(False),
    "const_feedback": _const(True),
}

_LAZY: dict[str, object] = {}


def lazy(name):
    if name not in _LAZY:
        _LAZY[name] = PROGRAMS[name][0](LazyEvaluator())
    return _LAZY[name]


def assert_same(port, ref):
    """Port vs JAX: same leaves, shapes and dtypes; ints bitwise, floats
    at 1e-6."""
    pl, jl = P.leaves(port), [np.asarray(x) for x in jax.tree.leaves(ref)]
    assert len(pl) == len(jl)
    for a, b in zip(pl, jl):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)


def assert_bitwise(a, b):
    assert P.structure(a) == P.structure(b)
    for x, y in zip(P.leaves(a), P.leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_port_lazy_matches_jax_lazy(name):
    assert_same(lazy(name), PROGRAMS[name][1]())


@pytest.mark.parametrize("schedule,interleave", ZOO, ids=[s for s, _ in ZOO])
@pytest.mark.parametrize("stages", [2, 4])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_future_bitwise_equals_lazy(name, stages, schedule, interleave):
    ev = FutureEvaluator(stages, schedule=schedule, interleave=interleave)
    assert_bitwise(PROGRAMS[name][0](ev), lazy(name))


def test_sieve_and_poly_values_are_exact():
    primes, count = lazy("sieve")
    ref = sieve.reference_primes(600)
    p = primes.numpy()
    assert int(count) == len(ref) and np.array_equal(p[p > 0], ref)
    x = poly.fateman_poly(3, 40, 6, device="cpu")
    got = poly.Poly(*lazy("poly"))
    assert poly.to_dict(got) == poly.reference_product(poly.to_dict(x), poly.to_dict(x))


# ---------------------------------------------------------------------------
# Errors and edges, as the reference's
# ---------------------------------------------------------------------------


def test_num_cells_must_divide_stages_times_interleave():
    prog = StreamProgram(_cell, t(W8), 8)
    with pytest.raises(ValueError, match="not divisible by axis 'pod' size 3 x interleave 1"):
        evaluate(prog, t(A7), FutureEvaluator(3))
    with pytest.raises(ValueError, match="size 4 x interleave 4"):
        evaluate(prog, t(A7), FutureEvaluator(4, schedule="interleaved", interleave=4))


def test_zip_off_a_stage_boundary_raises():
    s = (Stream.source(t(A7)).through(_cell, t(W8[:3]))
         .zip(Stream.source(t(B7)), lambda f, x: f + x).through(_cell, t(W8[:5])))
    with pytest.raises(ValueError, match="does not fall on a virtual-stage boundary"):
        s.collect(FutureEvaluator(4))
    # 3 cells then 5: a boundary for D=8 (one cell a stage)
    assert_bitwise(s.collect(FutureEvaluator(8)).items, s.collect(LazyEvaluator()).items)


def test_constructor_errors():
    with pytest.raises(ValueError, match="requires interleave=1"):
        FutureEvaluator(4, schedule="gpipe", interleave=2)
    planned = FutureEvaluator(4, backward="planned")  # ported: constructs
    assert planned.backward == "planned"
    # and refuses what the reference's planned backward refuses
    with pytest.raises(ValueError, match="requires immutable cell state"):
        evaluate(StreamProgram(_cell, t(W8), 8), t(A7), planned)
    with pytest.raises(ValueError, match="does not support feedback chains"):
        Stream.feedback(t(A7[:2]), 6, _fbemit).through(
            _cell, t(W8), mutable_state=False).collect(planned)
    with pytest.raises(ValueError, match="unknown backward mode"):
        FutureEvaluator(4, backward="other")
    with pytest.raises(ValueError, match="num_stages"):
        FutureEvaluator(0)


def test_zero_cell_program_and_feedback_without_cells():
    s = Stream.source(t(A7)).zip(Stream.source(t(B7)), lambda a, b: a * b).map(torch.sin)
    assert_bitwise(s.collect(FutureEvaluator(4)).items, s.collect(LazyEvaluator()).items)
    fb = Stream.feedback(t(A7[:2]), 6, _fbemit)
    with pytest.raises(ValueError, match="segment-free feedback chain"):
        fb.collect(FutureEvaluator(2))


def test_plan_for_matches_build_plan():
    from repro_torch.core import build_plan

    ev = FutureEvaluator(4, schedule="interleaved", interleave=2)
    a, b = ev.plan_for(6, feedback_lag=4), build_plan("interleaved", 4, 6, 2, feedback_lag=4)
    assert a.num_ticks == b.num_ticks and np.array_equal(a.microbatch, b.microbatch)


def test_gradients_through_the_pipeline_equal_lazy():
    w = torch.randn(8, 3, 3, generator=torch.Generator().manual_seed(0))
    items = t(A7)

    def loss(ev):
        wl = w.clone().requires_grad_(True)
        prog = StreamProgram(lambda ww, x: (ww, torch.tanh(x @ ww)), wl, 8,
                             mutable_state=False, remat=True)
        evaluate(prog, items, ev)[1].square().sum().backward()
        return wl.grad

    want = loss(LazyEvaluator())
    for name, v in ZOO:
        assert torch.equal(loss(FutureEvaluator(4, schedule=name, interleave=v)), want)


def test_ppermute_future_on_the_cpu_is_its_value():
    x = {"a": torch.ones(3)}
    fut = ppermute_future(x)
    assert fut.force() is x and fut._event is None


def test_unit_times_are_empty_on_the_cpu():
    ev = FutureEvaluator(2, time_units=True)
    evaluate(StreamProgram(_cell, t(W8), 8), t(A7), ev)
    assert ev.unit_times() == []


# ---------------------------------------------------------------------------
# The index a cell sees, and the scan repair
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("feedback", [False, True], ids=["source", "feedback"])
def test_each_cell_sees_the_same_item_index(feedback):
    def run(ev):
        seen = []

        def cell(state, item):
            seen.append((int(state["index"]), G.current_item()))
            return state, item + 1.0

        states = indexed_states(torch.zeros(8), 8)
        src = (Stream.feedback(t(A7[:4]), 12, _fbemit) if feedback
               else Stream.source(t(A7)))
        src.through(cell, states).collect(ev)
        return sorted(seen)

    want = run(LazyEvaluator())
    n = 12 if feedback else 6
    assert want == sorted((c, b) for c in range(8) for b in range(n))
    for name, v in ZOO:
        assert run(FutureEvaluator(4, schedule=name, interleave=v)) == want
    with pytest.raises(RuntimeError, match="only inside a cell call"):
        G.current_item()


def _in_place_cell(state, item):
    """Writes one row of its cache-like state in place (at the item's
    own index, as a decode step writes one cache row) and returns the
    same state."""
    b = G.current_item()
    state["k"][b].add_(item.sum())
    return state, item * 1.5


@pytest.mark.parametrize("evaluator", ["lazy", "future_gpipe", "future_interleaved"])
def test_in_place_cell_state_is_not_copied(evaluator, monkeypatch):
    ev = {"lazy": LazyEvaluator(),
          "future_gpipe": FutureEvaluator(4),
          "future_interleaved": FutureEvaluator(2, schedule="interleaved", interleave=2)}[evaluator]
    # A state of the decode cache's shape: (cells, B, S, KV, dh).
    cache = torch.zeros(8, 6, 64, 2, 16)
    ptr = cache.data_ptr()
    stacked = []
    real_stack = torch.stack
    monkeypatch.setattr(torch, "stack", lambda xs, *a, **k: stacked.append(len(xs)) or real_stack(xs, *a, **k))
    res = Stream.source(t(A7)).through(_in_place_cell, {"k": cache}).collect(ev)
    monkeypatch.setattr(torch, "stack", real_stack)
    final = res.states[0]["k"]
    assert final is cache and final.data_ptr() == ptr
    assert 8 not in stacked  # no cell loop stacked the 8 rows of a state
    # every cell added item b's running sum to row b
    want = torch.zeros(8, 6, 64, 2, 16)
    x = t(A7)
    for c in range(8):
        for b in range(6):
            want[c, b] += x[b].sum()
        x = x * 1.5
    assert torch.equal(final, want)
    # the same under the feedback executor (run_chain_sequential)
    cache2 = torch.zeros(8, 6, 64, 2, 16)
    fb = Stream.feedback(t(A7[:3]), 6, _fbemit).through(_in_place_cell, {"k": cache2}).collect(ev)
    assert fb.states[0]["k"] is cache2


def test_a_new_state_is_still_written_back():
    prog = StreamProgram(_cell, t(W8), 8)
    init = prog.init_state.clone()
    states, _ = evaluate(prog, t(A7), LazyEvaluator())
    assert torch.equal(prog.init_state, init)  # the input is not mutated
    assert torch.equal(states, init + 6)


def test_mixed_leaves_keep_the_in_place_one():
    def cell(state, item):
        state["kept"].add_(1.0)
        return {"kept": state["kept"], "new": state["new"] + 1.0}, item

    kept, new = torch.zeros(8, 3), torch.zeros(8, 3)
    for ev in (LazyEvaluator(), FutureEvaluator(4)):
        kept.zero_()
        res = Stream.source(t(A7)).through(cell, {"kept": kept, "new": new}).collect(ev)
        assert res.states[0]["kept"] is kept and torch.equal(kept, torch.full((8, 3), 6.0))
        assert res.states[0]["new"] is not new and torch.equal(res.states[0]["new"], new + 6)
