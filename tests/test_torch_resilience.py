"""repro_torch.resilience against the JAX package's repro.resilience:
TestResiliencePrimitives of tests/test_serve_resilience.py on the port,
and the heartbeat file read across the two packages (an external
supervisor reads either's)."""
import pytest

from repro.resilience import Heartbeat as JaxHeartbeat
from repro_torch.resilience import (
    Heartbeat,
    InjectedFault,
    OneShotInjector,
    RestartBudget,
    RestartPolicy,
    StragglerTracker,
)
from repro_torch.resilience.injection import call_injector
from repro_torch.serve.supervisor import chaos_injector


def test_one_shot_injector_fires_once():
    hits = []
    inj = OneShotInjector(2, hits.append)
    for step in range(5):
        inj(step, f"t{step}")
    inj(2, "again")
    assert hits == ["t2"]


def test_call_injector_arity():
    seen = []
    call_injector(lambda s: seen.append(("one", s)), 3, "eng")
    call_injector(lambda s, t: seen.append(("two", s, t)), 4, "eng")
    call_injector(None, 5)
    assert seen == [("one", 3), ("two", 4, "eng")]


def test_injected_fault_is_a_runtime_error():
    def fail(_):
        raise InjectedFault("boom")

    inj = OneShotInjector(0, fail)
    with pytest.raises(RuntimeError, match="boom"):
        inj(0)
    inj(0)  # fired once: the replay passes


def test_restart_budget_and_backoff():
    b = RestartBudget(RestartPolicy(max_restarts=2, backoff_seconds=0.01, backoff_factor=2.0))
    assert b.admit() and b.next_delay() == pytest.approx(0.01)
    assert b.admit() and b.next_delay() == pytest.approx(0.02)
    assert b.exhausted and not b.admit()
    assert RestartBudget(RestartPolicy()).next_delay() == 0.0


def test_heartbeat_roundtrip_and_staleness(tmp_path):
    path = str(tmp_path / "hb")
    assert Heartbeat.is_stale(path, 1.0)  # no file yet
    hb = Heartbeat(path)
    hb.beat(7)
    step, t = Heartbeat.read(path)
    assert step == 7
    assert not Heartbeat.is_stale(path, 60.0)
    assert Heartbeat.is_stale(path, 5.0, now=t + 10.0)
    Heartbeat(None).beat(0)  # disabled: no-op


@pytest.mark.parametrize("writer,reader", [(Heartbeat, JaxHeartbeat), (JaxHeartbeat, Heartbeat)],
                         ids=["port_writes", "jax_writes"])
def test_heartbeat_file_is_read_by_either_package(tmp_path, writer, reader):
    path = str(tmp_path / "hb")
    writer(path).beat(41)
    with open(path) as f:
        text = f.read()
    step, t = reader.read(path)
    assert step == 41 and text == f"41 {t!r}\n"
    assert not reader.is_stale(path, 60.0)
    assert reader.is_stale(path, 5.0, now=t + 10.0)


def test_straggler_tracker_flags_deviation():
    flagged = []
    t = StragglerTracker(factor=2.0, ema=0.9, on_straggler=lambda s, r: flagged.append((s, r)))
    assert not t.observe(0, 1.0)  # seeds
    assert not t.observe(1, 1.1)
    assert t.observe(2, 5.0)
    assert flagged and flagged[0][0] == 2 and flagged[0][1] > 2.0
    assert t.count == 1


def test_chaos_injector_rejects_unknown_kind():
    with pytest.raises(ValueError, match="chaos kind"):
        chaos_injector("meteor", 0)
