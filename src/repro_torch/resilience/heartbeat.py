"""Monotonic heartbeat file: the external-supervisor detection channel.

Port of ``repro.resilience.heartbeat``, line for line: the file format
(``"{step} {time}\n"``) is the reference's, so an external supervisor
reads the heartbeat of either package.

A wedged worker cannot report itself — detection must be external.  The
worker writes ``"<step> <wall_time>"`` after every completed step/round;
an external supervisor (or a test) reads the file's age and SIGKILLs a
worker whose heartbeat is stale, landing it in the restart path.  Both
halves live here so the writer and the detector can never drift on
format.
"""
from __future__ import annotations

import os
import time


class Heartbeat:
    """Per-step heartbeat writer.  ``path=None`` disables (no-op)."""

    def __init__(self, path: str | None):
        self.path = path

    def beat(self, step: int) -> None:
        if not self.path:
            return
        with open(self.path, "w") as f:
            f.write(f"{step} {time.time()}\n")

    @staticmethod
    def read(path: str) -> tuple[int, float]:
        """Returns (last step, wall time of its beat)."""
        with open(path) as f:
            step_s, t_s = f.read().split()
        return int(step_s), float(t_s)

    @staticmethod
    def is_stale(path: str, max_age_s: float, now: float | None = None) -> bool:
        """True when the worker should be presumed wedged: no heartbeat
        file yet, or its last beat is older than ``max_age_s``."""
        if not os.path.exists(path):
            return True
        _, t = Heartbeat.read(path)
        now = time.time() if now is None else now
        return (now - t) > max_age_s
