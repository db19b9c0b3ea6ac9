"""The Stream core of repro_torch against the JAX package, on the CPU.

The laws of tests/test_stream_algebra.py and the Lazy tests of
tests/test_stream_core.py restated for the port (the Future evaluator's
and the bench gate's are not: the port has neither yet).  Every program
runs through the port's LazyEvaluator and the JAX LazyEvaluator on the
same numpy inputs: integer programs must agree bitwise, fp32 programs at
rtol = atol = 1e-6 (XLA may contract ``a*b+c`` into one FMA where
PyTorch rounds twice); gradients within 1e-5 of ``jax.grad``'s.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LazyEvaluator as JLazy
from repro.core import Stream as JStream
from repro.core import StreamProgram as JProgram
from repro.core import evaluate as jevaluate
from repro_torch import pytree as P
from repro_torch.core import (
    Future, HostFuture, LazyEvaluator, Stream, StreamProgram, build_plan, defer,
    evaluate, run_chain_sequential,
)
from repro_torch.core import graph as G
from repro_torch.core.stream import indexed_states


def _np_items(m=6, w=3, seed=0):
    return np.random.default_rng(seed).normal(size=(m, w)).astype(np.float32)


def _items(m=6, w=3, seed=0):
    return torch.as_tensor(_np_items(m, w, seed))


def _jitems(m=6, w=3, seed=0):
    return jnp.asarray(_np_items(m, w, seed))


def _count_cell(state, item):
    return state + 1, item * 1.5 + state.to(torch.float32)


def _jcount_cell(state, item):
    return state + 1, item * 1.5 + state.astype(jnp.float32)


def assert_same(port, ref, exact=False):
    """Port pytree vs JAX pytree: same leaf order, shapes, dtypes; ints
    bitwise, floats at 1e-6 (or bitwise with ``exact``)."""
    pl, jl = P.leaves(port), jax.tree.leaves(ref)
    assert len(pl) == len(jl)
    for a, b in zip(pl, jl):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
        if exact or not np.issubdtype(a.dtype, np.floating):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def assert_equal(a, b):
    """Port vs port: bitwise."""
    la, lb = P.leaves(a), P.leaves(b)
    assert P.structure(a) == P.structure(b)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The pytree helper flattens in JAX's order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tree", [
    {"b": 1, "a": (2, [3, None]), "c": {"z": 4, "y": 5}},
    (1, {"x": 2}, [3, (4,)]),
    {"parts": (None, {"k": 1, "j": 2}), "seg": 3, "pos": 4},
])
def test_pytree_leaf_order_is_jax(tree):
    assert P.leaves(tree) == jax.tree.leaves(tree)
    leaves, td = P.flatten(tree)
    assert P.unflatten(td, leaves) == jax.tree.unflatten(jax.tree.structure(tree), leaves)


def test_pytree_structures_differ():
    assert P.structure({"x": 1}) != P.structure({"y": 1})
    assert P.structure((1, 2)) != P.structure([1, 2])
    with pytest.raises(ValueError, match="structures differ"):
        P.tree_map(lambda a, b: a, {"x": 1}, {"y": 1})


# ---------------------------------------------------------------------------
# tests/test_stream_algebra.py, restated
# ---------------------------------------------------------------------------


class TestMapFusion:
    def test_map_map_builds_one_node(self):
        f = lambda x: x * 2.0
        g = lambda x: x + 1.0
        fused = Stream.source(_items()).map(f).map(g)
        direct = Stream.source(_items()).map(lambda x: g(f(x)))
        assert len(fused.nodes()) == len(direct.nodes()) == 2
        assert sum(isinstance(n, G.MapNode) for n in fused.nodes()) == 1

    def test_map_map_values_equal(self):
        a = Stream.source(_items()).map(lambda x: x * 2.0).map(torch.tanh).collect().items
        b = Stream.source(_items()).map(lambda x: torch.tanh(x * 2.0)).collect().items
        assert torch.equal(a, b)
        ref = JStream.source(_jitems()).map(lambda x: x * 2.0).map(jnp.tanh).collect().items
        assert_same(a, ref)

    @pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
    def test_map_chain_always_one_node(self, n):
        s = Stream.source(_items())
        for i in range(n):
            s = s.map(lambda x, _i=i: x + float(_i))
        assert sum(isinstance(nd, G.MapNode) for nd in s.nodes()) == 1

    def test_map_fuses_into_segment_lowering(self):
        s = (
            Stream.source(_items())
            .map(lambda x: x * 2.0)
            .through(_count_cell, torch.arange(4, dtype=torch.int32))
            .map(lambda x: x + 1.0)
        )
        chain = s.lower()
        assert len(chain.segments) == 1
        assert chain.num_cells == 4
        assert chain.finalize is not None


class TestConcatAssociativity:
    def test_ir_shape_identical(self):
        a, b, c = (Stream.source(_items(seed=i)) for i in range(3))
        left = a.concat(b).concat(c)
        a2, b2, c2 = (Stream.source(_items(seed=i)) for i in range(3))
        right = a2.concat(b2.concat(c2))
        count = lambda s: sum(isinstance(n, G.ConcatNode) for n in s.nodes())
        assert count(left) == count(right) == 2

    def test_values_bit_equal(self):
        xs = [_items(seed=i) for i in range(3)]
        left = Stream.source(xs[0]).concat(Stream.source(xs[1])).concat(Stream.source(xs[2]))
        right = Stream.source(xs[0]).concat(Stream.source(xs[1]).concat(Stream.source(xs[2])))
        assert torch.equal(left.collect().items, right.collect().items)
        jx = [_jitems(seed=i) for i in range(3)]
        ref = JStream.source(jx[0]).concat(JStream.source(jx[1])).concat(JStream.source(jx[2]))
        assert_same(left.collect().items, ref.collect().items, exact=True)

    def test_concat_lengths_add(self):
        assert Stream.source(_items(4)).concat(Stream.source(_items(3))).num_items == 7

    def test_concat_structure_mismatch_raises_at_construction(self):
        a = Stream.source({"x": _items()})
        b = Stream.source({"y": _items()})
        with pytest.raises(ValueError, match="structure"):
            a.concat(b)
        with pytest.raises(ValueError, match="structure"):
            a.mask(lambda i: i["x"] > 0).concat(b)

    def test_concat_structure_mismatch_raises_after_map_at_eval(self):
        s = Stream.source(_items()).map(lambda i: {"x": i}).concat(Stream.source({"y": _items()}))
        with pytest.raises(ValueError, match="structure"):
            s.collect()


class TestZipDeterminism:
    def test_source_order_not_arrival_order(self):
        x, y = _items(seed=1), _items(seed=2)
        ab = Stream.source(x).zip(Stream.source(y), lambda a, b: (a, b))
        ba = Stream.source(y).zip(Stream.source(x), lambda b, a: (a, b))
        assert_equal(ab.collect().items, ba.collect().items)
        ref = JStream.source(_jitems(seed=1)).zip(JStream.source(_jitems(seed=2)), lambda a, b: (a, b))
        assert_same(ab.collect().items, ref.collect().items, exact=True)

    def test_repeated_runs_identical(self):
        s = Stream.source(_items(seed=1)).zip(Stream.source(_items(seed=2)), lambda a, b: a * b + a)
        assert torch.equal(s.collect().items, s.collect().items)
        ref = JStream.source(_jitems(seed=1)).zip(JStream.source(_jitems(seed=2)),
                                                  lambda a, b: a * b + a)
        assert_same(s.collect().items, ref.collect().items)

    def test_zip_length_mismatch_raises(self):
        with pytest.raises(ValueError, match="equal stream lengths"):
            Stream.source(_items(4)).zip(Stream.source(_items(5)), lambda a, b: a)

    def test_structure_changing_mid_spine_mask_raises_clearly(self):
        w = torch.arange(2, dtype=torch.int32)
        masked_cell = lambda s, i: (s + 1, {"value": i["value"] * 1.5, "valid": i["valid"]})
        s = (
            Stream.source(_items())
            .through(_count_cell, w)
            .mask(lambda i: i > 0.0)
            .through(masked_cell, w)
        )
        out = s.collect(LazyEvaluator()).items  # general DAG: fine
        assert tuple(out["value"].shape) == (6, 3)
        jw = jnp.arange(2, dtype=jnp.int32)
        ref = (
            JStream.source(_jitems())
            .through(_jcount_cell, jw)
            .mask(lambda i: i > 0.0)
            .through(lambda s, i: (s + 1, {"value": i["value"] * 1.5, "valid": i["valid"]}), jw)
        )
        assert_same(out, ref.collect(JLazy()).items)
        chain = s.lower()
        uni = G.unify_segments(chain.segments)
        row0 = P.tree_map(lambda l: l[0], uni.init_state)
        with pytest.raises(ValueError, match="LazyEvaluator"):
            uni.cell_fn(None, row0, _items()[0])

    def test_zip_of_stateful_pipelines_runs_lazy_but_not_chain(self):
        w = torch.arange(2, dtype=torch.int32)
        left = Stream.source(_items()).through(_count_cell, w)
        right = Stream.source(_items(seed=5)).through(_count_cell, w)
        z = left.zip(right, lambda a, b: a + b)
        res = z.collect(LazyEvaluator())
        assert tuple(res.items.shape) == (6, 3)
        jw = jnp.arange(2, dtype=jnp.int32)
        jz = JStream.source(_jitems()).through(_jcount_cell, jw).zip(
            JStream.source(_jitems(seed=5)).through(_jcount_cell, jw), lambda a, b: a + b)
        jres = jz.collect(JLazy())
        assert_same(res.items, jres.items)
        assert_same(res.states, jres.states)
        with pytest.raises(ValueError, match="LazyEvaluator"):
            z.lower()


class TestMask:
    def test_mask_tags_validity(self):
        out = Stream.source(torch.arange(6.0)).mask(lambda v: v > 2.5).collect().items
        np.testing.assert_array_equal(out["valid"].numpy(), np.arange(6) > 2.5)
        np.testing.assert_array_equal(out["value"].numpy(), np.arange(6.0))
        ref = JStream.source(jnp.arange(6.0)).mask(lambda v: v > 2.5).collect().items
        assert_same(out, ref, exact=True)


class TestThroughComposition:
    def test_two_segments_match_one(self):
        w = torch.arange(6, dtype=torch.int32)
        one = Stream.source(_items()).through(_count_cell, w)
        two = Stream.source(_items()).through(_count_cell, w[:3]).through(_count_cell, w[3:])
        r1, r2 = one.collect(), two.collect()
        assert torch.equal(r1.items, r2.items)
        assert torch.equal(torch.cat([r2.states[0], r2.states[1]]), r1.states[0])
        jw = jnp.arange(6, dtype=jnp.int32)
        j2 = JStream.source(_jitems()).through(_jcount_cell, jw[:3]).through(_jcount_cell, jw[3:])
        jr = j2.collect()
        assert_same(r2.items, jr.items)
        assert_same(r2.states, jr.states)

    def test_num_cells_inferred(self):
        s = Stream.source(_items()).through(_count_cell, torch.zeros(5, dtype=torch.int32))
        assert s.num_cells == 5

    def test_state_shape_mismatch_raises(self):
        with pytest.raises(ValueError, match="num_cells"):
            Stream.source(_items()).through(_count_cell, torch.zeros(5, dtype=torch.int32),
                                            num_cells=4)


class TestInputValidation:
    def test_empty_pytree_raises(self):
        prog = StreamProgram(_count_cell, torch.zeros(2, dtype=torch.int32), 2)
        with pytest.raises(ValueError, match="empty pytree"):
            evaluate(prog, {}, LazyEvaluator())

    def test_mismatched_leading_axes_raise(self):
        prog = StreamProgram(_count_cell, torch.zeros(2, dtype=torch.int32), 2)
        bad = {"a": torch.zeros((4, 2)), "b": torch.zeros((5, 2))}
        with pytest.raises(ValueError, match="leading"):
            evaluate(prog, bad, LazyEvaluator())

    def test_source_validates_too(self):
        with pytest.raises(ValueError, match="leading"):
            Stream.source({"a": torch.zeros((4, 2)), "b": torch.zeros((5, 2))})
        with pytest.raises(ValueError, match="empty pytree"):
            Stream.source({})

    def test_scalar_leaf_raises(self):
        with pytest.raises(ValueError, match="leading stream axis"):
            Stream.source(torch.tensor(1.0))

    def test_stream_with_items_arg_raises(self):
        with pytest.raises(ValueError, match="its own sources"):
            evaluate(Stream.source(_items()), _items(), LazyEvaluator())


class TestFromProgram:
    def test_adapter_equivalence_and_deprecation(self):
        prog = StreamProgram(_count_cell, torch.arange(4, dtype=torch.int32), 4)
        st_legacy, out_legacy = evaluate(prog, _items(), LazyEvaluator())
        with pytest.warns(DeprecationWarning, match="from_program"):
            res = Stream.from_program(prog, _items()).collect()
        assert torch.equal(out_legacy, res.items)
        assert torch.equal(st_legacy, res.states[0])
        jst, jout = jevaluate(JProgram(_jcount_cell, jnp.arange(4, dtype=jnp.int32), 4),
                              _jitems(), JLazy())
        assert_same((st_legacy, out_legacy), (jst, jout))

    def test_legacy_evaluate_path_does_not_warn(self):
        prog = StreamProgram(_count_cell, torch.arange(4, dtype=torch.int32), 4)
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            evaluate(prog, _items(), LazyEvaluator())

    def test_adapter_forwards_program_options(self):
        prog = StreamProgram(
            lambda w, x: (w, x * w[0]), torch.arange(1.0, 4.0).reshape(3, 1), 3,
            mutable_state=False, remat=True,
        )
        with pytest.warns(DeprecationWarning):
            stream = Stream.from_program(prog, _items())
        seg = stream.lower().segments[0]
        assert seg.num_cells == 3 and seg.mutable_state is False and seg.remat is True

    def test_adapter_grad_matches_direct_build(self):
        def cell(w, x):
            return w, torch.tanh(x * w)

        def grad(build):
            w = torch.linspace(0.2, 0.8, 3).requires_grad_()
            (build(w).collect().items ** 2).sum().backward()
            return w.grad

        def adapter(w):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                return Stream.from_program(StreamProgram(cell, w, 3, mutable_state=False), _items())

        ga = grad(adapter)
        gd = grad(lambda w: Stream.source(_items()).through(cell, w, mutable_state=False))
        assert torch.equal(ga, gd)


class TestFeedback:
    @staticmethod
    def _emit(item):
        return item * 0.5 + 1.0

    def _reference(self, init, n, states0):
        lag = init.shape[0]
        ring = [init[i] for i in range(lag)]
        states, outs = states0.clone(), []
        for b in range(n):
            flow = ring.pop(0) if b < lag else outs[b - lag]
            new = []
            for c in range(states.shape[0]):
                s, flow = _count_cell(states[c], flow)
                new.append(s)
            states = torch.stack(new)
            outs.append(self._emit(flow))
        return torch.stack(outs), states

    @pytest.mark.parametrize("lag,n", [(1, 5), (3, 14), (4, 4)])
    def test_lazy_matches_unrolled_reference(self, lag, n):
        init_np = np.random.default_rng(1).normal(size=(lag, 3)).astype(np.float32)
        init = torch.as_tensor(init_np)
        s = Stream.feedback(init, n, self._emit).through(_count_cell, torch.arange(4, dtype=torch.int32))
        res = s.collect(LazyEvaluator())
        ref_items, ref_states = self._reference(init, n, torch.arange(4, dtype=torch.int32))
        assert torch.equal(res.items, ref_items) and torch.equal(res.states[0], ref_states)
        # the Lazy evaluator runs feedback through the sequential chain executor
        states, outs = run_chain_sequential(s.lower())
        assert torch.equal(outs, res.items) and torch.equal(states[0], res.states[0])
        jres = (JStream.feedback(jnp.asarray(init_np), n, self._emit)
                .through(_jcount_cell, jnp.arange(4, dtype=jnp.int32)).collect(JLazy()))
        assert_same(res.items, jres.items)
        assert_same(res.states, jres.states)

    def test_multi_segment_feedback_through_the_unified_chain(self):
        """Two segments with a mid-spine map: the unified (branch-indexed)
        chain under feedback, against JAX's."""
        init_np = _np_items(2)
        plain = lambda s, x: (s, torch.tanh(x * s))
        s = (Stream.feedback(torch.as_tensor(init_np), 7, self._emit)
             .through(_count_cell, torch.arange(3, dtype=torch.int32))
             .map(lambda x: x * 0.5)
             .through(plain, torch.linspace(0.5, 1.5, 2), mutable_state=False))
        res = s.collect()
        states, outs = run_chain_sequential(s.lower())
        assert torch.equal(outs, res.items)
        jres = (JStream.feedback(jnp.asarray(init_np), 7, self._emit)
                .through(_jcount_cell, jnp.arange(3, dtype=jnp.int32))
                .map(lambda x: x * 0.5)
                .through(lambda s, x: (s, jnp.tanh(x * s)), jnp.linspace(0.5, 1.5, 2),
                         mutable_state=False)
                .collect())
        assert_same(res.items, jres.items)
        assert_same(res.states, jres.states)

    def test_entry_zip_overlay(self):
        lag, n = 2, 8
        init = torch.ones((lag, 3))
        gate = (torch.arange(n) % 3 == 0)[:, None]
        overlay = torch.where(gate, torch.full((n, 3), 5.0), torch.zeros(n, 3))
        combine = lambda flow, src: torch.where(src > 0, src, flow)
        cell = lambda w, x: (w, torch.tanh(x * w))
        weights = torch.linspace(0.5, 1.5, 4)
        res = (Stream.feedback(init, n, self._emit)
               .zip(Stream.source(overlay), combine)
               .through(cell, weights, mutable_state=False)
               .collect(LazyEvaluator()))

        def chain_one(x):
            for w in weights:
                x = torch.tanh(x * w)
            return self._emit(x)

        expect = chain_one(torch.full((3,), 5.0))
        for b in (0, 3, 6):
            torch.testing.assert_close(res.items[b], expect, rtol=1e-6, atol=0)
        torch.testing.assert_close(res.items[4], chain_one(res.items[2]), rtol=1e-6, atol=0)
        jres = (JStream.feedback(jnp.ones((lag, 3)), n, self._emit)
                .zip(JStream.source(jnp.asarray(overlay.numpy())),
                     lambda flow, src: jnp.where(src > 0, src, flow))
                .through(lambda w, x: (w, jnp.tanh(x * w)), jnp.linspace(0.5, 1.5, 4),
                         mutable_state=False)
                .collect(JLazy()))
        assert_same(res.items, jres.items)

    def test_num_items_and_lag_validation(self):
        with pytest.raises(ValueError, match="num_items"):
            Stream.feedback(torch.zeros((4, 2)), 3, self._emit)

    def test_lazy_eval_graph_rejects_feedback(self):
        s = Stream.feedback(torch.zeros((2, 3)), 6, self._emit).through(
            _count_cell, torch.zeros(2, dtype=torch.int32))
        with pytest.raises(TypeError, match="node-local"):
            G.lazy_eval_graph(s.node)

    def test_emit_must_preserve_structure(self):
        s = Stream.feedback(torch.zeros((2, 3)), 6, lambda item: {"changed": item}).through(
            _count_cell, torch.zeros(2, dtype=torch.int32))
        with pytest.raises(ValueError, match="preserve the flowing item"):
            s.collect(LazyEvaluator())

    def test_tail_zip_rejected(self):
        s = (Stream.feedback(torch.zeros((2, 3)), 6, self._emit)
             .through(_count_cell, torch.zeros(2, dtype=torch.int32))
             .zip(Stream.source(torch.zeros((6, 3))), lambda a, b: a + b))
        with pytest.raises(ValueError, match="after the last cell"):
            s.lower()

    def test_tail_map_folds_into_emit(self):
        init = torch.ones((2, 3))
        zeros = torch.zeros(2, dtype=torch.int32)
        mapped = Stream.feedback(init, 6, lambda it: self._emit(it * 2.0)).through(_count_cell, zeros)
        with_tail = (Stream.feedback(init, 6, self._emit).through(_count_cell, zeros)
                     .map(lambda x: x * 2.0))
        assert torch.equal(with_tail.collect().items, mapped.collect().items)
        assert with_tail.lower().finalize is None

    def test_plan_has_feedback_lag(self):
        p = build_plan("gpipe", 4, 16, feedback_lag=8)
        assert p.feedback_lag == 8
        assert int((p.microbatch >= 0).sum()) == 4 * 16


class TestLowering:
    def test_entry_zip_two_injections(self):
        s = (Stream.source(_items(seed=1))
             .zip(Stream.source(_items(seed=2)), lambda a, b: a + b)
             .through(_count_cell, torch.arange(4, dtype=torch.int32)))
        chain = s.lower()
        assert len(chain.injections) == 2
        assert [i.cell_index for i in chain.injections] == [0, 0]
        assert chain.injections[0].combine is None and chain.injections[1].combine is not None

    def test_interior_zip_cell_index(self):
        s = (Stream.source(_items(seed=1))
             .through(_count_cell, torch.arange(4, dtype=torch.int32))
             .zip(Stream.source(_items(seed=2)), lambda a, b: a + b)
             .through(_count_cell, torch.arange(2, dtype=torch.int32)))
        chain = s.lower()
        assert chain.num_cells == 6
        assert [i.cell_index for i in chain.injections] == [0, 4]
        # the lowered chain runs the interior injection where the DAG does
        states, outs = run_chain_sequential(chain)
        res = s.collect()
        assert torch.equal(outs, res.items)
        assert_equal(states, res.states)

    def test_pure_program_zero_cells(self):
        chain = Stream.source(_items()).map(lambda x: x * 3.0).lower()
        assert chain.num_cells == 0 and len(chain.segments) == 0

    def test_zero_cell_chain_materializes_the_collected_items(self):
        s = Stream.source(_items()).map(lambda x: x * 3.0)
        assert torch.equal(s.lower().injections[0].materialize(), s.collect().items)


class TestConstState:
    @staticmethod
    def _const_cell(const, state, item):
        return state + 1, torch.tanh(item * const) + state * 0.01

    @staticmethod
    def _folded_cell(state, item):
        new = {"count": state["count"] + 1, "scale": state["scale"]}
        return new, torch.tanh(item * state["scale"]) + state["count"] * 0.01

    @staticmethod
    def _jconst_cell(const, state, item):
        return state + 1, jnp.tanh(item * const) + state * 0.01

    def _w(self, n=4):
        return torch.arange(n, dtype=torch.float32)

    def _scale(self, n=4):
        return torch.linspace(1.0, 2.0, n)

    def test_const_equals_folded_state(self):
        a = Stream.source(_items()).through(self._const_cell, self._w(),
                                            const_state=self._scale()).collect()
        b = Stream.source(_items()).through(
            self._folded_cell, {"count": self._w(), "scale": self._scale()}).collect()
        assert torch.equal(a.items, b.items)
        assert torch.equal(a.states[0], b.states[0]["count"])
        ja = JStream.source(_jitems()).through(
            self._jconst_cell, jnp.arange(4, dtype=jnp.float32),
            const_state=jnp.linspace(1.0, 2.0, 4)).collect()
        assert_same(a.items, ja.items)
        assert_same(a.states, ja.states)

    def test_const_leading_axis_validated(self):
        with pytest.raises(ValueError, match="const_state"):
            Stream.source(_items()).through(self._const_cell, self._w(4),
                                            const_state=self._scale(3))

    def test_const_under_feedback(self):
        emit = lambda x: x * 0.9 + 0.1
        a = (Stream.feedback(_items(3), 11, emit)
             .through(self._const_cell, self._w(), const_state=self._scale()).collect())
        b = (Stream.feedback(_items(3), 11, emit)
             .through(self._folded_cell, {"count": self._w(), "scale": self._scale()}).collect())
        assert torch.equal(a.items, b.items)
        ja = (JStream.feedback(_jitems(3), 11, emit)
              .through(self._jconst_cell, jnp.arange(4, dtype=jnp.float32),
                       const_state=jnp.linspace(1.0, 2.0, 4)).collect())
        assert_same(a.items, ja.items)

    def test_const_multi_segment_with_mid_map(self):
        plain = lambda s, x: (s, torch.tanh(x * s))
        w2 = torch.linspace(0.5, 1.5, 3)
        a = (Stream.source(_items())
             .through(self._const_cell, self._w(), const_state=self._scale())
             .map(lambda x: x * 0.5)
             .through(plain, w2, mutable_state=False).collect())
        b = (Stream.source(_items())
             .through(self._folded_cell, {"count": self._w(), "scale": self._scale()})
             .map(lambda x: x * 0.5)
             .through(plain, w2, mutable_state=False).collect())
        assert torch.equal(a.items, b.items)
        assert len(a.states) == 2
        # the unified chain (branch-indexed segments, pre_fn at the first
        # cell) gives the DAG's values
        states, outs = run_chain_sequential(
            Stream.source(_items())
            .through(self._const_cell, self._w(), const_state=self._scale())
            .map(lambda x: x * 0.5)
            .through(plain, w2, mutable_state=False).lower())
        assert torch.equal(outs, a.items)
        assert_equal(states, a.states)
        ja = (JStream.source(_jitems())
              .through(self._jconst_cell, jnp.arange(4, dtype=jnp.float32),
                       const_state=jnp.linspace(1.0, 2.0, 4))
              .map(lambda x: x * 0.5)
              .through(lambda s, x: (s, jnp.tanh(x * s)), jnp.linspace(0.5, 1.5, 3),
                       mutable_state=False).collect())
        assert_same(a.items, ja.items)
        assert_same(a.states, ja.states)

    def test_const_never_returned_or_mutated(self):
        res = Stream.source(_items()).through(self._const_cell, self._w(),
                                              const_state=self._scale()).collect()
        assert len(res.states) == 1 and tuple(res.states[0].shape) == (4,)


# ---------------------------------------------------------------------------
# tests/test_stream_core.py TestLazyEvaluator, restated; integer programs
# ---------------------------------------------------------------------------


def _counting_program(num_cells):
    return StreamProgram(_count_cell, torch.arange(num_cells, dtype=torch.int32), num_cells)


class TestLazyEvaluator:
    def test_matches_python_reference(self):
        states, outs = evaluate(_counting_program(3), torch.tensor([[1.0], [2.0]]), LazyEvaluator())
        st_ref = np.arange(3, dtype=np.int64)
        outs_ref = []
        for it in [1.0, 2.0]:
            flow = it
            for s in range(3):
                flow = flow * 1.5 + st_ref[s]
                st_ref[s] += 1
            outs_ref.append(flow)
        np.testing.assert_array_equal(states.numpy(), st_ref)
        np.testing.assert_allclose(outs.numpy()[:, 0], outs_ref, rtol=1e-6)

    def test_state_mutation_order(self):
        states, _ = evaluate(_counting_program(4), torch.ones((5, 1)))
        np.testing.assert_array_equal(states.numpy(), np.arange(4) + 5)

    def test_immutable_state(self):
        prog = StreamProgram(lambda w, x: (w + 1, x * w), torch.ones(2), 2, mutable_state=False)
        states, _ = evaluate(prog, torch.ones((3, 1)))
        np.testing.assert_array_equal(states.numpy(), np.ones(2))

    def test_bad_state_shape_raises(self):
        with pytest.raises(ValueError):
            StreamProgram(lambda s, x: (s, x), torch.zeros((3,)), 4)

    def test_indexed_states(self):
        st = indexed_states(torch.zeros(4, 2), 4)
        np.testing.assert_array_equal(st["index"].numpy(), np.arange(4))


def _int_cell(state, item):
    # torch sums int32 into int64 unless told; jnp keeps int32
    return state * 3 + item.sum(dtype=torch.int32) % 7, (item * 5 + state) % 1000


def _jint_cell(state, item):
    return state * 3 + item.sum() % 7, (item * 5 + state) % 1000


@pytest.mark.parametrize("num_cells,m", [(1, 1), (3, 5), (7, 2)])
def test_integer_program_bitwise(num_cells, m):
    items = np.random.default_rng(num_cells).integers(0, 100, size=(m, 4)).astype(np.int32)
    s0 = np.arange(num_cells, dtype=np.int32)
    res = Stream.source(torch.as_tensor(items)).through(_int_cell, torch.as_tensor(s0)).collect()
    jres = JStream.source(jnp.asarray(items)).through(_jint_cell, jnp.asarray(s0)).collect()
    assert_same(res.items, jres.items, exact=True)
    assert_same(res.states, jres.states, exact=True)


# ---------------------------------------------------------------------------
# Gradients through a chain, against jax.grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("mutable", [False, True])
def test_grad_through_chain_matches_jax(remat, mutable):
    w_np = np.linspace(0.2, 0.8, 3).astype(np.float32)
    items = _np_items(4, 3, seed=3)

    def loss_port(w):
        res = Stream.source(torch.as_tensor(items)).through(
            lambda w_, x: (w_ * 1.01, torch.tanh(x * w_)), w, mutable_state=mutable,
            remat=remat).collect()
        return (res.items ** 2).sum() + (res.states[0].sum() if mutable else 0)

    def loss_jax(w):
        res = JStream.source(jnp.asarray(items)).through(
            lambda w_, x: (w_ * 1.01, jnp.tanh(x * w_)), w, mutable_state=mutable,
            remat=remat).collect()
        return jnp.sum(res.items ** 2) + (jnp.sum(res.states[0]) if mutable else 0)

    w = torch.as_tensor(w_np).requires_grad_()
    loss_port(w).backward()
    g = np.asarray(jax.grad(loss_jax)(jnp.asarray(w_np)))
    np.testing.assert_allclose(w.grad.numpy(), g, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Futures on the CPU
# ---------------------------------------------------------------------------


class TestFutureCombinators:
    def test_defer_force_identity(self):
        fut = defer(lambda: torch.arange(3.0))
        np.testing.assert_array_equal(fut.force().numpy(), [0, 1, 2])

    def test_defer_passes_arguments(self):
        x = torch.linspace(0, 1, 5)
        fut = defer(torch.sin, x)
        assert isinstance(fut, Future)
        assert torch.equal(fut.force(anchor=torch.cos(x)), torch.sin(x))

    def test_map_forwards_laziness(self):
        fut = defer(lambda: torch.tensor(2.0)).map(lambda v: v * 3)
        assert float(fut.force()) == 6.0

    def test_flat_map(self):
        fut = defer(lambda: torch.tensor(2.0)).flat_map(lambda v: defer(torch.exp, v))
        assert float(fut.force()) == float(torch.exp(torch.tensor(2.0)))

    def test_host_future(self):
        assert HostFuture(lambda: 41).map(lambda v: v + 1).force() == 42
