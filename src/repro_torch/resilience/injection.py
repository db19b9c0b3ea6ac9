"""Fail-injector protocol: deterministic fault simulation at boundaries.

Port of ``repro.resilience.injection`` (framework-free; a copy, so that
the port imports nothing of the JAX package).

An injector is any ``Callable[[int], None]`` (optionally accepting the
supervised object as a second argument) invoked by a resilient loop at
each step/round boundary *before* the step's work.  To inject a fault it
raises — :class:`InjectedFault` by convention, so tests and logs can
tell simulated failures from real ones — or mutates its target (e.g.
NaN-poisoning a cache, sending a signal to the current process).

Injection is the *test protocol* of this package: the production loops
never require an injector, but accept one so the chaos batteries can
prove the restart path is bitwise-reproducing (see
``tests/test_torch_supervisor.py``).
"""
from __future__ import annotations

import inspect
from typing import Any, Callable


class InjectedFault(RuntimeError):
    """A simulated failure raised by a fail injector."""


class OneShotInjector:
    """Fire ``action`` exactly once, at step/round index ``at``.

    One-shot is the shape every restart test needs: the fault fires on
    the first attempt of round ``at`` and *not* on its replay, so a
    bounded-restart loop provably recovers.  ``action`` receives the
    supervised target when the caller passes one (the serve supervisor
    hands its engine over; a loop that calls with the step index only,
    as the reference's training loop does, invokes ``action`` with
    ``None``).
    """

    def __init__(self, at: int, action: Callable[[Any], None]):
        self.at = at
        self.action = action
        self.fired = False

    def __call__(self, step: int, target: Any = None) -> None:
        if step == self.at and not self.fired:
            self.fired = True
            self.action(target)


def call_injector(injector, step: int, target: Any = None) -> None:
    """Invoke ``injector`` with (step, target) or (step) as it accepts.

    Keeps the one-argument train-loop injector signature
    (``fail_injector(step)``) and the two-argument serving signature
    (``injector(round, engine)``) interchangeable — the loops call this
    instead of hand-checking arity.
    """
    if injector is None:
        return
    try:
        sig = inspect.signature(injector)
        two = len(sig.parameters) >= 2
    except (TypeError, ValueError):  # builtins / C callables: assume 1-arg
        two = False
    if two:
        injector(step, target)
    else:
        injector(step)
