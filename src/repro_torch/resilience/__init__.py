"""Shared resilience machinery: the failure side of the Future substitution.

Port of ``repro.resilience``.  The paper's move -- substituting Future for
Lazy -- makes failure a first-class value: a forced future can fail,
time out, or be retried, and the *flow* (not a single force point) is
where failure must propagate.  This package is the generic runbook that
:mod:`repro_torch.serve.supervisor` (``ServeSupervisor``: round
snapshot/restore, watchdog deadline, numerics scan, graceful SIGTERM
drain) and :mod:`repro_torch.train.fault` (``ResilientLoop``: checkpoint
restart and replay, heartbeats, stragglers) consume.

The modules hold no tensor code and are copies of the reference's:

* :mod:`repro_torch.resilience.injection` -- the fail-injector protocol
  and the ``OneShotInjector`` used by every chaos test.
* :mod:`repro_torch.resilience.heartbeat` -- monotonic per-step heartbeat
  file + staleness reader (the external-supervisor detection side).
* :mod:`repro_torch.resilience.straggler` -- EMA step-time tracker with a
  policy callback.
* :mod:`repro_torch.resilience.restart` -- bounded restart budget with
  exponential backoff.
"""
from repro_torch.resilience.heartbeat import Heartbeat
from repro_torch.resilience.injection import InjectedFault, OneShotInjector
from repro_torch.resilience.restart import RestartBudget, RestartPolicy
from repro_torch.resilience.straggler import StragglerTracker

__all__ = [
    "Heartbeat",
    "InjectedFault",
    "OneShotInjector",
    "RestartBudget",
    "RestartPolicy",
    "StragglerTracker",
]
