"""repro_torch.train.elastic's planners against the JAX package.

``choose_mesh_shape`` and ``choose_elastic_plan`` for every device count
n in 1..1024, under the keyword sets of tests/test_elastic.py: the same
plan field for field (the schedule choice included), or the same error.
``remesh_state`` runs on DTensors in tests/test_torch_mesh.py.
"""
import dataclasses

import pytest

from repro.train import elastic as JE
from repro_torch.train import elastic as E

NS = range(1, 1025)
KW = dict(preferred_pipeline=8, global_batch=256, work_per_item=1.0,
          per_tick_overhead=1e-5)
PLAN_KWARGS = {
    "default": {},
    "unpipelined": dict(preferred_pipeline=1),
    "deep": KW,
    "non_power_of_two": {**KW, "preferred_pipeline": 6},
    "planned_budget": {**KW, "memory_budget_items": 0.5, "backward": "planned"},
    "autodiff_budget": {**KW, "memory_budget_items": 0.5},
    "two_stage_model8": dict(preferred_pipeline=2, preferred_model=8, global_batch=64),
}
MESH_KWARGS = {
    "default": {},
    "model8_batch64": dict(preferred_model=8, global_batch=64),
    "model4_batch96": dict(preferred_model=4, global_batch=96),
}


def _fields(plan):
    return dataclasses.asdict(plan)


def _outcome(fn, *args, **kw):
    try:
        return "ok", _fields(fn(*args, **kw))
    except ValueError as e:
        return "ValueError", str(e)


@pytest.mark.parametrize("kw", list(MESH_KWARGS))
def test_choose_mesh_shape_equals_jax(kw):
    for n in NS:
        assert _fields(E.choose_mesh_shape(n, **MESH_KWARGS[kw])) == \
            _fields(JE.choose_mesh_shape(n, **MESH_KWARGS[kw])), n


@pytest.mark.parametrize("kw", list(PLAN_KWARGS))
def test_choose_elastic_plan_equals_jax(kw):
    for n in NS:
        got = _outcome(E.choose_elastic_plan, n, **PLAN_KWARGS[kw])
        want = _outcome(JE.choose_elastic_plan, n, **PLAN_KWARGS[kw])
        assert got == want, n


def test_pod_loss_replans_the_schedule():
    """512 -> 256 -> 128 devices with a two-stage preference: the plan
    chip_smoke.py prints."""
    plans = [E.choose_elastic_plan(n, preferred_pipeline=2) for n in (512, 256, 128)]
    assert [p.mesh_shape for p in plans] == [(16, 16, 2), (8, 16, 2), (4, 16, 2)]
    assert all(p.schedule is not None for p in plans)
    assert [_fields(p) for p in plans] == \
        [_fields(JE.choose_elastic_plan(n, preferred_pipeline=2)) for n in (512, 256, 128)]
