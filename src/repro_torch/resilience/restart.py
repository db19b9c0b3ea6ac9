"""Bounded restart budget with exponential backoff.

Port of ``repro.resilience.restart`` (framework-free; a copy).

Unbounded retry turns a deterministic failure into a hang; zero retry
turns a transient one into an outage.  The policy is the knob set, the
budget is the mutable per-run state — loops create a fresh
:class:`RestartBudget` per run (or per round, for round-scoped retry)
so exhaustion never leaks across independent work.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    max_restarts: int = 3
    backoff_seconds: float = 0.0  # first retry's delay; 0 = immediate
    backoff_factor: float = 2.0   # multiplier per subsequent retry


class RestartBudget:
    """Mutable restart state for one run under a :class:`RestartPolicy`."""

    def __init__(self, policy: RestartPolicy):
        self.policy = policy
        self.restarts = 0

    @property
    def exhausted(self) -> bool:
        return self.restarts >= self.policy.max_restarts

    def admit(self) -> bool:
        """Consume one restart; False when the budget is exhausted (the
        caller should re-raise instead of retrying)."""
        if self.exhausted:
            return False
        self.restarts += 1
        return True

    def next_delay(self) -> float:
        """Backoff before the restart just admitted (0.0 by default).
        The first admitted restart waits ``backoff_seconds``, each one
        after that ``backoff_factor`` × the previous delay."""
        base = self.policy.backoff_seconds
        if base <= 0 or self.restarts == 0:
            return 0.0
        return base * self.policy.backoff_factor ** (self.restarts - 1)
