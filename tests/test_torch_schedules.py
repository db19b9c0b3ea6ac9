"""The port's schedule tables against the JAX package's, array for array.

``repro_torch.core.schedules`` is a numpy-only copy of
``repro.core.schedules`` (the port imports nothing of the JAX package);
every field of every plan must equal the reference's: tick tables,
slot counts, feed carousels, feedback arcs, emit placement, stash and
release columns, and the derived peaks and bubbles.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import schedules as J
from repro_torch.core import schedules as T


def assert_plans_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            assert_plans_equal(x, y)
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert isinstance(x, np.ndarray) and isinstance(y, np.ndarray), f.name
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, (f.name, x, y)


PLANS = (
    [(name, d, m, 1) for name in ("gpipe", "one_f_one_b")
     for d in (1, 2, 3, 4) for m in (1, 2, 4, 5, 8)]
    + [("interleaved", d, m, v) for d in (2, 3, 4) for m in (1, 4, 5, 8) for v in (2, 4)]
)


@pytest.mark.parametrize("name,d,m,v", PLANS)
def test_build_plan(name, d, m, v):
    a, b = T.build_plan(name, d, m, v), J.build_plan(name, d, m, v)
    assert_plans_equal(a, b)
    assert a.bubble_fraction == b.bubble_fraction
    assert a.peak_inflight_items == b.peak_inflight_items


@pytest.mark.parametrize("name,d,m,v,lag", [
    ("gpipe", 4, 16, 1, 8), ("gpipe", 4, 16, 1, 4), ("one_f_one_b", 4, 16, 1, 8),
    ("interleaved", 4, 16, 2, 8), ("interleaved", 2, 12, 4, 3), ("gpipe", 2, 8, 1, 2),
    ("gpipe", 1, 5, 1, 1),
])
def test_build_plan_feedback(name, d, m, v, lag):
    assert_plans_equal(T.build_plan(name, d, m, v, feedback_lag=lag),
                       J.build_plan(name, d, m, v, feedback_lag=lag))


@pytest.mark.parametrize("name,d,m,v,pos", [
    ("gpipe", 4, 8, 1, (0, 2)), ("gpipe", 4, 5, 1, (0, 0, 3)), ("one_f_one_b", 4, 8, 1, (0, 1)),
    ("interleaved", 4, 8, 2, (0, 5)), ("interleaved", 2, 6, 3, (0, 4)),
])
def test_build_plan_inject_positions(name, d, m, v, pos):
    a = T.build_plan(name, d, m, v, inject_positions=pos)
    assert_plans_equal(a, J.build_plan(name, d, m, v, inject_positions=pos))
    assert a.peak_inflight_items == J.build_plan(name, d, m, v, inject_positions=pos).peak_inflight_items


@pytest.mark.parametrize("handoff", [1, 3])
def test_build_plan_handoff(handoff):
    assert_plans_equal(T.build_plan("interleaved", 4, 8, 2, handoff=handoff),
                       J.build_plan("interleaved", 4, 8, 2, handoff=handoff))


COMBINED = (
    [(name, d, m, 1) for name in ("gpipe", "one_f_one_b") for d in (1, 2, 4) for m in (1, 4, 5, 8)]
    + [("interleaved", d, m, v) for d in (2, 4) for m in (2, 5, 8) for v in (2, 3)]
)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("name,d,m,v", COMBINED)
def test_build_combined_plan(name, d, m, v, split):
    a = T.build_combined_plan(name, d, m, v, split_backward=split)
    b = J.build_combined_plan(name, d, m, v, split_backward=split)
    assert_plans_equal(a, b)
    assert a.peak_stash_items == b.peak_stash_items
    assert a.bubble_fraction == b.bubble_fraction


@pytest.mark.parametrize("name,d,m,v", [
    ("gpipe", 4, 8, 1), ("one_f_one_b", 4, 8, 1), ("one_f_one_b", 3, 5, 1),
    ("interleaved", 4, 8, 2), ("interleaved", 2, 6, 3),
])
def test_build_backward_plan(name, d, m, v):
    assert_plans_equal(T.build_backward_plan(name, d, m, v), J.build_backward_plan(name, d, m, v))


@pytest.mark.parametrize("name,d,m,v,sources", [
    ("gpipe", 4, 16, 1, 1), ("one_f_one_b", 4, 16, 1, 1), ("one_f_one_b", 4, 16, 1, 3),
    ("interleaved", 4, 8, 2, 2),
])
def test_peak_and_feed_models(name, d, m, v, sources):
    for mode in T.BACKWARD_MODES:
        assert (T.peak_inflight_items(name, d, m, v, num_sources=sources, backward=mode)
                == J.peak_inflight_items(name, d, m, v, num_sources=sources, backward=mode))
    assert T.feed_items_per_source(d, m) == J.feed_items_per_source(d, m)


def test_constants_and_validators():
    assert T.SCHEDULES == J.SCHEDULES
    assert T.BACKWARD_MODES == J.BACKWARD_MODES
    assert T.DEFAULT_HANDOFF == J.DEFAULT_HANDOFF
    assert (T.UNIT_F, T.UNIT_B, T.UNIT_W) == (J.UNIT_F, J.UNIT_B, J.UNIT_W)
    assert T.validate_schedule("interleaved", 2) == J.validate_schedule("interleaved", 2)
    assert T.validate_backward("planned") == "planned"
    for bad in [lambda m: m.build_plan("zigzag", 4, 8),
                lambda m: m.build_plan("gpipe", 4, 8, interleave=2),
                lambda m: m.build_plan("gpipe", 4, 8, inject_positions=(1,)),
                lambda m: m.build_plan("gpipe", 4, 8, inject_positions=(0, 4)),
                lambda m: m.validate_backward("zigzag")]:
        with pytest.raises(ValueError) as jerr:
            bad(J)
        with pytest.raises(ValueError) as terr:
            bad(T)
        assert str(terr.value) == str(jerr.value)
