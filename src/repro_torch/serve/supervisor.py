"""Round-supervised serving: zero-loss fault recovery for the engines.

PyTorch port of ``repro.serve.supervisor``.  ``ServeSupervisor`` wraps
either serving engine (``Engine`` or ``StreamEngine``: anything with the
``submit/step/run_until_drained`` contract and host-visible state) with
the serving half of the :mod:`repro_torch.resilience` runbook:

* **snapshot/restore** -- before every round, the complete in-flight
  state is copied to host memory: the KV caches / cell states, the slot
  bookkeeping (``lengths``/``active``), the admission queue, the uid
  counter, and every live request's mutable fields.  A failed round
  restores the snapshot and replays.  Replay is *bitwise*: sampling
  derives from ``(seed, uid, ngen)``, admissions re-plan identically from
  the restored queue, and prefill/decode are deterministic (the
  attention kernels' split merges sum in a fixed order) -- so a
  recovered serve emits exactly the tokens of a fault-free run.
* **watchdog deadline** -- a round slower than ``deadline_s`` is treated
  as wedged: its results are discarded (snapshot restore) and the round
  replays.  Detection is at the round boundary (one process); the
  heartbeat file (:class:`repro_torch.resilience.Heartbeat`) is the
  channel an *external* supervisor uses to kill a worker that never
  reaches the boundary.
* **numerics poisoning** -- after each round the engine's float cache
  state is checked for NaN/inf; a poisoned round restores and replays.
* **bounded retry with backoff** -- each round gets a fresh
  :class:`repro_torch.resilience.RestartBudget`; an exhausted budget
  re-raises and counts the unresolved accepted requests in
  ``stats["requests_lost"]``.
* **graceful SIGTERM drain** -- ``install_signal_handlers()`` turns
  SIGTERM into "stop accepting, finish everything accepted".

What differs from the reference:

* The port's engines write their cache **in place** (the reference's is
  functional, and a failed round never touched the copy it restores).
  So ``snapshot`` copies every cache leaf into host memory (pinned on a
  card, the copy awaited before it returns), and ``restore`` writes the
  copy back into the engine's own tensors with ``copy_`` -- ``Engine.
  cache``, ``StreamEngine.cell_states`` (views of one cache) -- never
  rebinding them, after waiting until no kernel of the failed round can
  still write (a device-wide synchronise; the Future evaluator also
  joins its stage streams to the caller when a cell raises).
* The per-round snapshot reuses one set of host buffers that the
  supervisor owns; a :class:`Snapshot` that :meth:`ServeSupervisor.
  snapshot` hands a caller has buffers of its own, which no later round
  overwrites.
* The numerics scan reads one flag per round (one host sync).
* ``Engine.decode_steps`` and ``StreamEngine.rounds`` count the work
  issued, replays included: the snapshot leaves them out.
* The reference's degraded mode (a fused-kernel failure switching the
  engine to the plain path) is not ported (ROADMAP A8): a kernel that
  fails to build or launch raises, the round replays on the same kernel,
  and when the budget is spent the error is re-raised with a
  ``gave_up`` event and the lost requests counted.  A sticky CUDA error
  (an illegal address, say) poisons the process's CUDA context: no
  replay in the same process can recover from it, and it surfaces as
  ``gave_up`` -- never as a run moved to the CPU.

Across ranks (a ``StreamEngine(mesh=)``, whose cells split over the
ranks of the mesh axis ``pcfg.axis_name``), every rank runs this host
loop on the same submissions, and every decision that changes the host
state is agreed over the axis's process group:

* each rank snapshots and restores only its own cells' shards (its
  ``cell_states``); the host state -- lengths, slots, queue, request
  fields, uid counter -- is the same on every rank.  The snapshot is
  taken at the round boundary, where no hop of the ranked loop is in
  flight (the loop waits on every hop before it returns).
* each attempt agrees twice, each time by one small all-gather of a
  per-rank outcome (0 ok, 1 exception, 2 watchdog, 3 numerics, a
  draining bit, the rank's round time), on the engine's device (NCCL
  needs CUDA tensors; gloo takes CPU ones): after the injector, before
  ``engine.step()`` -- so an injected fault or a SIGTERM on one rank
  never leaves the others blocked in the round's hops -- and after the
  step, the watchdog and the numerics scan.  If any rank reports a
  fault, every rank counts it, writes the same ``round_fault`` event
  (naming each faulting rank, its kind and its error), draws on its
  budget, restores its shards and replays; once the budget is spent,
  every rank raises (a rank that saw no fault itself raises a
  :class:`RoundFault` naming the others) with the same
  ``requests_lost``.
* each rank times its own round; a round trips the watchdog when any
  rank's time passes ``deadline_s``, and the slowest rank's time feeds
  the straggler tracker, so ``stats`` and ``events`` stay equal on every
  rank.  Each rank scans its own shards for NaN/inf.
* ``request_drain`` (SIGTERM) sets a flag of this rank's; the flags are
  OR-ed at each agreement, so every rank closes admission, and writes
  ``drained``, at the same round.
* a heartbeat file is written per rank, ``<heartbeat_path>.rank<r>``.

Out of scope, as in the reference (whose SPMD program raises on every
device at once): a fault raised inside ``engine.step()`` on one rank
only, once the round's hops have begun.  The other ranks then wait in a
hop or a collective that the faulting rank never joins, and the process
group's timeout fails the world (``launch.serve.GROUP_TIMEOUT``; under
``torchrun`` the world is then restarted): it never hangs without a
bound.  Recovering a communicator in place is not attempted.

Fault injection (the chaos battery's entry point) is a
:mod:`repro_torch.resilience.injection` callable invoked with
``(round_index, engine)`` before each round attempt;
:func:`chaos_injector` builds the standard fault classes.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import pytree as P
from repro_torch.resilience import Heartbeat, RestartBudget, RestartPolicy, StragglerTracker
from repro_torch.resilience.injection import InjectedFault, OneShotInjector, call_injector
from repro_torch.serve.engine import DrainTimeoutError, Request

PyTree = Any


class RoundFault(RuntimeError):
    """Base class for supervisor-detected round failures."""


class WatchdogTimeout(RoundFault):
    """The round exceeded the supervisor's deadline (wedge)."""


class NumericsFault(RoundFault):
    """NaN/inf detected in the engine's cache state after a round."""


class DrainingError(RuntimeError):
    """submit() after SIGTERM/drain was requested (admission closed)."""


# A rank's outcome of one round attempt, as the agreement across ranks
# carries it
OK, RAISED, WATCHDOG, NUMERICS = 0, 1, 2, 3
OUTCOMES = {RAISED: "exception", WATCHDOG: "watchdog", NUMERICS: "numerics"}
_TEXT_BYTES = 256  # of each rank's error text in a fault's event


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    deadline_s: float | None = None   # round watchdog; None disables
    max_restarts: int = 3             # per-round retry budget
    backoff_seconds: float = 0.0      # retry backoff (0 = immediate)
    backoff_factor: float = 2.0
    check_numerics: bool = True       # NaN/inf cache scan per round
    heartbeat_path: str | None = None
    straggler_factor: float = 2.0     # round-time EMA surfacing


@dataclasses.dataclass
class Snapshot:
    """Host-side copy of the complete in-flight engine state."""

    device: PyTree                      # host copies of cache / cell_states
    lengths: np.ndarray
    active_uids: list[int | None]
    queue_uids: list[int]
    requests: dict[int, Request]        # uid -> live handle
    req_state: dict[int, tuple[list[int], bool, str]]  # mutable fields
    uid_counter: int


def _device_state(engine) -> PyTree:
    """The engine's device-resident mutable state (cache shards)."""
    return engine.cell_states if hasattr(engine, "cell_states") else engine.cache


def _cuda_devices(leaves) -> set[torch.device]:
    return {leaf.device for leaf in leaves if leaf.is_cuda}


def _host_buffers(leaves) -> list[torch.Tensor]:
    """One host tensor per leaf, pinned for a leaf on a card (so that the
    copies run as DMA and can be awaited together)."""
    return [torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=leaf.is_cuda)
            for leaf in leaves]


class ServeSupervisor:
    """Wrap an engine with snapshot/replay fault recovery.

    The supervisor owns the step loop: call ``submit``/``cancel``/
    ``step``/``run_until_drained`` on the supervisor, not the engine.
    Each ``step()`` is one supervised round: snapshot, (optionally
    inject,) run, verify deadline + numerics -- and on any fault,
    restore + replay under a bounded restart budget.
    """

    def __init__(
        self,
        engine,
        cfg: SupervisorConfig | None = None,
        fail_injector: Callable | None = None,
        on_event: Callable[[dict], None] | None = None,
    ):
        self.engine = engine
        self.cfg = cfg or SupervisorConfig()
        self.fail_injector = fail_injector
        self.on_event = on_event
        self.events: list[dict] = []
        self.stats = {
            "rounds": 0, "faults": 0, "restarts": 0,
            "requests_lost": 0, "stragglers": 0,
        }
        self._round_idx = 0
        self._draining = False
        self._drain_asked = False  # this rank's SIGTERM, not yet agreed
        # Across ranks: the mesh axis's process group every decision is
        # agreed over
        self._group = None
        hb_path = self.cfg.heartbeat_path
        if getattr(engine, "mesh", None) is not None:
            import torch.distributed as dist

            from repro_torch.core.future import axis_group

            self._group = axis_group(engine.pcfg.axis_name, engine.mesh)
            if hb_path:
                hb_path = f"{hb_path}.rank{dist.get_rank()}"
        self._hb = Heartbeat(hb_path)
        self._straggler = StragglerTracker(self.cfg.straggler_factor)
        self._policy = RestartPolicy(
            max_restarts=self.cfg.max_restarts,
            backoff_seconds=self.cfg.backoff_seconds,
            backoff_factor=self.cfg.backoff_factor,
        )
        self._round_buffers: list[torch.Tensor] | None = None  # step()'s snapshot

    # -- lifecycle -----------------------------------------------------------

    def install_signal_handlers(self):
        signal.signal(signal.SIGTERM, self.request_drain)

    def request_drain(self, *_):
        """SIGTERM handler: close admission, keep serving until drained.
        Across ranks admission closes at the next agreement, on every
        rank at once."""
        self._drain_asked = True
        if self._group is None:
            self._start_draining()

    def _start_draining(self) -> None:
        if not self._draining:
            self._draining = True
            self._event({"event": "drain_requested"})

    @property
    def draining(self) -> bool:
        return self._draining

    def submit(self, *args, **kwargs) -> Request:
        if self._draining:
            raise DrainingError("supervisor is draining; admission closed")
        return self.engine.submit(*args, **kwargs)

    def cancel(self, uid: int) -> bool:
        return self.engine.cancel(uid)

    def drained(self) -> bool:
        eng = self.engine
        return not eng.queue and all(r is None for r in eng.active)

    # -- snapshot / restore --------------------------------------------------

    def snapshot(self) -> Snapshot:
        """Copy the complete in-flight state to host memory, into buffers
        of its own: no later round of this supervisor writes them."""
        return self._snapshot(None)

    def _snapshot(self, buffers: list[torch.Tensor] | None) -> Snapshot:
        """The snapshot, its cache copied into ``buffers`` (fresh host
        tensors when None).  Returns once the copies have landed."""
        eng = self.engine
        leaves, treedef = P.flatten(_device_state(eng))
        if buffers is None:
            buffers = _host_buffers(leaves)
        for host, leaf in zip(buffers, leaves):
            host.copy_(leaf, non_blocking=host.is_pinned())
        for dev in _cuda_devices(leaves):
            # the copies were issued on the current stream, after the
            # round's writes (the evaluator joins its stage streams)
            torch.cuda.current_stream(dev).synchronize()
        live: dict[int, Request] = {}
        for req in list(eng.queue) + [r for r in eng.active if r is not None]:
            live[req.uid] = req
        return Snapshot(
            device=P.unflatten(treedef, buffers),
            lengths=eng.lengths.copy(),
            active_uids=[r.uid if r is not None else None for r in eng.active],
            queue_uids=[r.uid for r in eng.queue],
            requests=live,
            req_state={
                uid: (list(r.out_tokens), r.done, r.status)
                for uid, r in live.items()
            },
            uid_counter=eng._uid,
        )

    def restore(self, snap: Snapshot) -> None:
        """Roll the engine (and every live request handle) back.

        The cache is written in place: every tensor of the engine keeps
        its storage (``data_ptr``), so views of it (a StreamEngine's cell
        shards, a captured graph's inputs) stay valid."""
        eng = self.engine
        leaves = P.leaves(_device_state(eng))
        hosts = P.leaves(snap.device)
        if [(t.shape, t.dtype) for t in leaves] != [(h.shape, h.dtype) for h in hosts]:
            raise ValueError("the snapshot was taken of a cache of another layout")
        devices = _cuda_devices(leaves)
        for dev in devices:
            # no kernel of the failed round, on any stream, may still write
            torch.cuda.synchronize(dev)
        for leaf, host in zip(leaves, hosts):
            leaf.copy_(host, non_blocking=host.is_pinned())
        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()
        eng.lengths = snap.lengths.copy()
        for uid, (toks, done, status) in snap.req_state.items():
            req = snap.requests[uid]
            req.out_tokens = list(toks)
            req.done = done
            req.status = status
        eng.active = [
            snap.requests[uid] if uid is not None else None
            for uid in snap.active_uids
        ]
        eng.queue.clear()
        eng.queue.extend(snap.requests[uid] for uid in snap.queue_uids)
        eng._uid = snap.uid_counter
        if hasattr(eng, "_by_uid"):
            eng._by_uid = {
                r.uid: r for r in eng.active if r is not None
            }

    # -- fault detection -----------------------------------------------------

    def _check_numerics(self):
        """NaN/inf scan over the engine's float cache state, with one
        host sync.  Each float leaf's minimum and maximum are reduced on
        its device (both are NaN where any element is NaN, and an
        infinity shows in one of them), so the scan reads the cache once
        and allocates no cache-sized flag tensor, as ``isfinite(leaf)``
        would; the round's writes are ordered before it on the caller's
        stream.  Skipped when ``check_numerics`` is off."""
        leaves = [t for t in P.leaves(_device_state(self.engine))
                  if t.is_floating_point() and t.numel()]
        if not leaves:
            return
        ends = torch.stack([torch.stack(torch.aminmax(t)).float() for t in leaves])
        if not bool(torch.isfinite(ends).all()):
            raise NumericsFault(
                "non-finite values in engine cache state "
                "(poisoned logits/KV rows)"
            )

    def _event(self, ev: dict):
        self.events.append(ev)
        if self.on_event:
            self.on_event(ev)

    def _unresolved(self) -> list[int]:
        eng = self.engine
        return sorted(
            [r.uid for r in eng.queue if not r.done]
            + [r.uid for r in eng.active if r is not None and not r.done]
        )

    # -- agreement across ranks ---------------------------------------------

    def _agree(self, err: Exception | None, dt: float = 0.0):
        """An attempt's outcome over every rank: ``(fault, error, dt)``,
        the exception this rank raises once the budget is spent (None
        when no rank faulted), the ``round_fault`` event's error text and
        the round's time (the slowest rank's).  On one card, this
        process's own.  Across ranks, one all-gather of each rank's
        outcome, drain flag and time; where a rank faulted, a second of
        each rank's error text."""
        if self._group is None:
            return err, None if err is None else f"{type(err).__name__}: {err}", dt
        import torch.distributed as dist

        code = (OK if err is None else WATCHDOG if isinstance(err, WatchdogTimeout)
                else NUMERICS if isinstance(err, NumericsFault) else RAISED)
        mine = torch.tensor([code, int(self._drain_asked), round(dt * 1e6)],
                            dtype=torch.int64, device=self.engine.device)
        rows = [torch.empty_like(mine) for _ in range(dist.get_world_size(self._group))]
        dist.all_gather(rows, mine, group=self._group)
        rows = torch.stack(rows).tolist()  # (code, drain, microseconds) a rank
        if any(drain for _, drain, _ in rows):
            self._start_draining()
        dt = max(us for _, _, us in rows) / 1e6
        faulty = [(rank, c) for rank, (c, _, _) in enumerate(rows) if c != OK]
        if not faulty:
            return None, None, dt
        texts = self._gather_text("" if err is None else f"{type(err).__name__}: {err}")
        error = "; ".join(f"rank {rank} {OUTCOMES[c]}: {texts[rank]}" for rank, c in faulty)
        if err is None:
            err = RoundFault(f"round {self._round_idx} failed on another rank: {error}")
        return err, error, dt

    def _gather_text(self, text: str) -> list[str]:
        """Every rank's ``text`` (its first ``_TEXT_BYTES`` bytes)."""
        import torch.distributed as dist

        raw = text.encode()[:_TEXT_BYTES].ljust(_TEXT_BYTES, b"\0")
        mine = torch.tensor(list(raw), dtype=torch.uint8, device=self.engine.device)
        bufs = [torch.empty_like(mine) for _ in range(dist.get_world_size(self._group))]
        dist.all_gather(bufs, mine, group=self._group)
        return [bytes(b.tolist()).rstrip(b"\0").decode(errors="ignore") for b in bufs]

    # -- the supervised round ------------------------------------------------

    def _run_round(self, t0: float):
        """``engine.step()``, then the watchdog and the numerics scan:
        ``(finished, this rank's fault or None, the round's time)``."""
        try:
            finished = self.engine.step()
        except Exception as e:  # noqa: BLE001 -- any fault: replay
            return None, e, time.monotonic() - t0
        dt = time.monotonic() - t0
        if self.cfg.deadline_s is not None and dt > self.cfg.deadline_s:
            return finished, WatchdogTimeout(
                f"round {self._round_idx} took {dt:.3f}s > deadline {self.cfg.deadline_s}s"), dt
        if self.cfg.check_numerics:
            try:
                self._check_numerics()
            except Exception as e:  # noqa: BLE001
                return finished, e, dt
        return finished, None, dt

    def step(self) -> list[Request]:
        """One supervised round: snapshot -> run -> verify, replay on fault.

        Across ranks the attempt is agreed before the step (an injected
        fault on one rank keeps every rank out of the round's hops) and
        after it, so every rank replays, or returns, together."""
        snap = self._snapshot(self._round_buffers)
        self._round_buffers = P.leaves(snap.device)
        budget = RestartBudget(self._policy)
        while True:
            t0 = time.monotonic()
            try:
                call_injector(self.fail_injector, self._round_idx, self.engine)
                err = None
            except Exception as e:  # noqa: BLE001 -- any fault: replay
                err = e
            fault, error, dt = self._agree(err)
            if fault is None:
                finished, err, dt = self._run_round(t0)
                fault, error, dt = self._agree(err, dt)
            if fault is not None:
                self.stats["faults"] += 1
                self._event({
                    "event": "round_fault", "round": self._round_idx,
                    "error": error, "attempt": budget.restarts,
                })
                if not budget.admit():
                    # the requests live at the round's start: a round that
                    # failed mid-step may have taken some off the queue
                    lost = sorted(uid for uid, (_, done, _) in snap.req_state.items()
                                  if not done)
                    self.stats["requests_lost"] += len(lost)
                    self._event({
                        "event": "gave_up", "round": self._round_idx,
                        "requests_lost": lost,
                    })
                    raise fault
                self.stats["restarts"] += 1
                time.sleep(budget.next_delay())
                self.restore(snap)
                continue
            if self._straggler.observe(self._round_idx, dt):
                self.stats["stragglers"] += 1
            self._hb.beat(self._round_idx)
            self._round_idx += 1
            self.stats["rounds"] += 1
            return finished

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        """Drain every accepted request under supervision.

        When draining was requested (SIGTERM), this is the graceful
        exit: everything accepted completes, nothing new enters.
        """
        finished = []
        for _ in range(max_steps):
            finished.extend(self.step())
            if self.drained():
                if self._draining:
                    self._event({"event": "drained"})
                return finished
        undrained = self._unresolved()
        self.stats["requests_lost"] += len(undrained)
        raise DrainTimeoutError(max_steps, undrained)


# -- chaos injection (the standard fault classes) ----------------------------


def poison_cache(engine) -> None:
    """NaN-poison the engine's float cache state in place (simulated bad
    HBM / overflowed logits).  Detection is the supervisor's numerics
    scan."""
    for leaf in P.leaves(_device_state(engine)):
        if leaf.is_floating_point():
            leaf.fill_(float("nan"))


def chaos_injector(
    kind: str, at_round: int, *, wedge_seconds: float = 1.0
) -> OneShotInjector:
    """The chaos battery's fault classes, as one-shot injectors.

    * ``"raise"``   -- the round attempt raises :class:`InjectedFault`
      (a mid-round exception: kernel crash, collective failure, ...).
    * ``"nan"``     -- the cache state is NaN-poisoned before the round;
      the numerics scan catches it after.
    * ``"wedge"``   -- the round stalls ``wedge_seconds`` (must exceed
      the supervisor's ``deadline_s`` to trip the watchdog).
    * ``"sigterm"`` -- SIGTERM is delivered to this process mid-serve;
      with handlers installed the supervisor drains gracefully.
    """
    def _raise(eng):
        raise InjectedFault(f"injected round failure at round {at_round}")

    actions = {
        "raise": _raise,
        "nan": poison_cache,
        "wedge": lambda eng: time.sleep(wedge_seconds),
        "sigterm": lambda eng: os.kill(os.getpid(), signal.SIGTERM),
    }
    if kind not in actions:
        raise ValueError(f"chaos kind {kind!r}; expected one of {sorted(actions)}")
    return OneShotInjector(at_round, actions[kind])
