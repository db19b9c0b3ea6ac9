"""Fault tolerance: checkpoint/restart, heartbeats, straggler mitigation.

Port of ``repro.train.fault``.  :class:`ResilientLoop` wraps a train step
with the runbook a large fleet needs, built on
:mod:`repro_torch.resilience` (the machinery the serving supervisor
consumes too):

* **checkpoint/restart** -- periodic asynchronous checkpoints; on any
  step exception the loop restores the latest checkpoint and replays.
  The data pipeline is step-keyed, so replayed steps see identical
  batches: with deterministic kernels the restart is bitwise
  reproducible, and ``history`` records each step once (entries past
  the restored step are dropped on restart).
* **heartbeats** -- a monotonic per-step heartbeat file
  (:class:`~repro_torch.resilience.Heartbeat`); an external supervisor
  detects a wedged worker by its heartbeat's age and kills it, landing
  in the restart path above.
* **straggler mitigation** -- per-step wall times feed an EMA
  (:class:`~repro_torch.resilience.StragglerTracker`); steps slower than
  ``straggler_factor`` times the EMA are counted and reported through a
  callback.
* **preemption windows** -- ``request_stop()`` (the SIGTERM handler)
  finishes the current step, writes a final checkpoint and exits.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable

import torch

from repro_torch import pytree as P
from repro_torch.resilience import Heartbeat, RestartBudget, RestartPolicy, StragglerTracker
from repro_torch.resilience.injection import call_injector
from repro_torch.train.checkpoint import Checkpointer

PyTree = Any


@dataclasses.dataclass
class FaultConfig:
    checkpoint_every: int = 50
    heartbeat_path: str | None = None
    straggler_factor: float = 2.0
    straggler_ema: float = 0.9
    max_restarts: int = 3
    backoff_seconds: float = 0.0  # restart backoff; 0 = immediate replay


def block_until_ready(tree: PyTree) -> None:
    """Wait until the card has made every CUDA tensor of ``tree``
    (``jax.block_until_ready``); nothing to wait for on the CPU."""
    for device in {t.device for t in P.leaves(tree)
                   if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(device)


class ResilientLoop:
    def __init__(
        self,
        step_fn: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree, dict]],
        checkpointer: Checkpointer,
        fault_cfg: FaultConfig,
        on_straggler: Callable[[int, float], None] | None = None,
    ):
        self.step_fn = step_fn
        self.ckpt = checkpointer
        self.cfg = fault_cfg
        self.on_straggler = on_straggler
        self._stop = False
        self._hb = Heartbeat(fault_cfg.heartbeat_path)
        self._straggler = StragglerTracker(
            fault_cfg.straggler_factor, fault_cfg.straggler_ema, on_straggler
        )
        self.stats = {"restarts": 0, "stragglers": 0, "steps": 0}
        # Seconds each restore took (restore_seconds[i]: restart i).
        self.restore_seconds: list[float] = []

    def request_stop(self, *_):
        self._stop = True

    def install_signal_handlers(self):
        signal.signal(signal.SIGTERM, self.request_stop)

    def _heartbeat(self, step: int):
        self._hb.beat(step)

    def _track_time(self, step: int, dt: float):
        if self._straggler.observe(step, dt):
            self.stats["stragglers"] += 1

    def run(
        self,
        params: PyTree,
        opt_state: PyTree,
        batch_fn: Callable[[int], PyTree],
        num_steps: int,
        start_step: int = 0,
        fail_injector: Callable[[int], None] | None = None,
    ) -> tuple[PyTree, PyTree, int, list[dict]]:
        """Run to ``num_steps`` with restart-on-failure.  Returns the
        final state, the step reached and the history."""
        step = start_step
        history: list[dict] = []
        budget = RestartBudget(RestartPolicy(
            max_restarts=self.cfg.max_restarts,
            backoff_seconds=self.cfg.backoff_seconds,
        ))
        # Restart-from-nothing must replay from the *initial* state, not
        # whatever the params had become when the step blew up.
        init_params, init_opt_state = params, opt_state
        while step < num_steps and not self._stop:
            try:
                call_injector(fail_injector, step, self)
                batch = batch_fn(step)
                t0 = time.perf_counter()
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, batch
                )
                block_until_ready(metrics["loss"])
                dt = time.perf_counter() - t0
                self._track_time(step, dt)
                self._heartbeat(step)
                history.append(
                    {"step": step, **{k: float(v) for k, v in metrics.items()}}
                )
                step += 1
                self.stats["steps"] += 1
                if step % self.cfg.checkpoint_every == 0 or step == num_steps:
                    self.ckpt.save(
                        step, {"params": params, "opt_state": opt_state}
                    )
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception:
                if not budget.admit():
                    raise
                self.stats["restarts"] += 1
                time.sleep(budget.next_delay())
                t0 = time.perf_counter()
                # A write still in flight is the newest checkpoint.
                self.ckpt.wait()
                restored_step = self.ckpt.latest_step()
                if restored_step is None:
                    # No checkpoint yet: restart from the initial state.
                    params, opt_state = init_params, init_opt_state
                    step = start_step
                else:
                    state, step = self.ckpt.restore(
                        {"params": params, "opt_state": opt_state}
                    )
                    params, opt_state = state["params"], state["opt_state"]
                block_until_ready((params, opt_state))
                self.restore_seconds.append(time.perf_counter() - t0)
                # The replay re-runs steps >= the restored step: drop
                # their history entries so each step is recorded once and
                # stats["steps"] counts completed steps.
                kept = [h for h in history if h["step"] < step]
                self.stats["steps"] -= len(history) - len(kept)
                history[:] = kept
        # The final checkpoint (after a stop request, between periodic
        # ones); the reference writes it again when the last step was
        # just saved, which rewrites the same state.
        if self.ckpt.latest_step_or_inflight() != step:
            self.ckpt.save(step, {"params": params, "opt_state": opt_state})
        self.ckpt.wait()
        return params, opt_state, step, history
