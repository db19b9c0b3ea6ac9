"""Straggler detection: EMA step-time tracking with a policy hook.

Port of ``repro.resilience.straggler`` (framework-free; a copy).

On a real pod the action on a detected straggler is to cordon the slow
host and re-shard (the reference's ``repro.train.elastic``, not ported
yet: ROADMAP A12); the detector and the
policy hook are the reusable halves, so they live here and the action
stays a callback.
"""
from __future__ import annotations

from typing import Callable


class StragglerTracker:
    """Flag steps slower than ``factor`` × the EMA of past step times.

    ``observe`` returns True (and invokes ``on_straggler(step, ratio)``)
    when the step is a straggler; the first observation only seeds the
    EMA.  A straggler's own time still folds into the EMA afterwards, so
    a persistently slow regime stops flagging once it becomes the norm
    — the tracker detects *deviation*, not absolute slowness.
    """

    def __init__(
        self,
        factor: float = 2.0,
        ema: float = 0.9,
        on_straggler: Callable[[int, float], None] | None = None,
    ):
        self.factor = factor
        self.ema = ema
        self.on_straggler = on_straggler
        self.count = 0
        self._ema_step_time: float | None = None

    def observe(self, step: int, dt: float) -> bool:
        if self._ema_step_time is None:
            self._ema_step_time = dt
            return False
        straggler = dt > self.factor * self._ema_step_time
        if straggler:
            self.count += 1
            if self.on_straggler:
                self.on_straggler(step, dt / self._ema_step_time)
        a = self.ema
        self._ema_step_time = a * self._ema_step_time + (1 - a) * dt
        return straggler
