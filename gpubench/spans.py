"""Readings of the port's own spans in a profiled run.

Frozen copies of the span names and span readers of
``repro_torch/roofline/trace.py`` as they were added after commit
9b6c4dc (``span_device_us``, ``span_host_us``, ``span_launch_calls``,
``idle_by_span`` and ``_launch_time``); the rest they need comes from
:mod:`gpubench.trace`, frozen at 75044a6.  The port opens each span with
``torch.profiler.record_function`` while a profiler records, so
:func:`gpubench.trace.profile` sees them as host records of kind
``span``.  A program without the spans gives no reading: each metric
that reads them returns None there, never 0.
"""
from __future__ import annotations

import bisect
import collections

from gpubench.trace import NoDeviceActivity, _device, _HostTree, _is_launch, _launcher, busy_us

ENGINE_STEP = "engine.step"
ENGINE_ADMIT = "engine.admit"
PREFILL_CACHE = "engine.prefill_cache"
PREFILL_CHUNK = "engine.prefill_chunk"
PREFILL_WAIT = "engine.prefill_wait"
PREFILL_DRAW = "engine.prefill_draw"
SLOT_COPY = "engine.slot_copy"
DECODE = "engine.decode"
DECODE_WAIT = "engine.decode_wait"
DRAW = "engine.draw"
TRAIN_STEP = "train.step"
TRAIN_FORWARD = "train.forward"
TRAIN_BACKWARD = "train.backward"
TRAIN_OPTIMIZER = "train.optimizer"
MODEL_GROUP = "model.group"
PROGRAM_SPANS = (ENGINE_STEP, ENGINE_ADMIT, PREFILL_CACHE, PREFILL_CHUNK, PREFILL_WAIT,
                 PREFILL_DRAW, SLOT_COPY, DECODE, DECODE_WAIT, DRAW, TRAIN_STEP, TRAIN_FORWARD,
                 TRAIN_BACKWARD, TRAIN_OPTIMIZER, MODEL_GROUP)
OUTSIDE = "(outside)"


def records_of(facts):
    """The profiled run's records; None without a traced stretch or a
    device (a CPU run)."""
    return facts["profiled"].get("records") or None


def count(records, name: str, within: str | None = None) -> int:
    """How many host spans ``name`` the records hold (with ``within``,
    only those inside a span ``within``); 0 for no records."""
    if not records:
        return 0
    spans = [r for r in records if r.where == "host" and r.name == name]
    if within is not None:
        outer = [r for r in records if r.where == "host" and r.name == within]
        spans = [s for s in spans if any(o.start <= s.start and s.end <= o.end for o in outer)]
    return len(spans)


def device_ms_per_step(facts, name: str, within: str | None = None) -> float | None:
    """:func:`span_device_us` of ``name`` (``within``) over the profiled
    ``train.step`` spans, in ms; None where either span is missing or
    the trace holds no device record."""
    records = records_of(facts)
    steps = count(records, TRAIN_STEP)
    if not steps or not count(records, name, within):
        return None
    try:
        return span_device_us(records, name, within) / steps / 1e3
    except NoDeviceActivity:
        return None


def _launch_time(records):
    launcher = _launcher(records)

    def when(r):
        host = launcher(r)
        return host.start if host is not None else r.start

    return when


def _spans(records, name: str):
    spans = [r for r in records if r.where == "host" and r.name == name]
    if not spans:
        raise ValueError(f"no host span {name!r} in the records")
    return spans


class _Cover:
    def __init__(self, intervals):
        merged: list[list[float]] = []
        for a, b in sorted(intervals):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]

    def __contains__(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def span_device_us(records, name: str, within: str | None = None) -> float:
    """Device busy time of the work whose launch call lies inside host
    spans ``name`` (with ``within``: only those inside a span
    ``within``), by time on any thread."""
    spans = _spans(records, name)
    if within is not None:
        outer = _spans(records, within)
        spans = [s for s in spans if any(o.start <= s.start and s.end <= o.end for o in outer)]
    cover = _Cover((s.start, s.end) for s in spans)
    when = _launch_time(records)
    return busy_us([(r.start, r.end) for r in _device(records) if when(r) in cover])


def span_host_us(records, name: str, minus=()) -> float:
    """Summed host time of spans ``name`` less their child spans (same
    thread) named in ``minus``."""
    children = [r for r in records if r.where == "host" and r.name in minus]
    total = 0.0
    for s in _spans(records, name):
        inner = [(c.start, c.end) for c in children
                 if c.thread == s.thread and s.start <= c.start and c.end <= s.end]
        total += s.end - s.start - busy_us(inner)
    return total


def _puts_work(r) -> bool:
    return _is_launch(r) or (r.kind == "runtime" and ("Memcpy" in r.name or "Memset" in r.name))


def span_launch_calls(records, name: str) -> int:
    """Kernel and graph launches, memcpy and memset calls starting inside
    host spans ``name``; a graph launch counts once."""
    cover = _Cover((s.start, s.end) for s in _spans(records, name))
    return sum(1 for r in records if _puts_work(r) and r.start in cover)


def idle_by_span(records, window, names=PROGRAM_SPANS) -> dict[str, float]:
    """The device's idle time in ``window`` summed by the innermost span
    of ``names`` open when each gap began on the thread that issued the
    record ending it, else the one opened last on any thread;
    :data:`OUTSIDE` where none."""
    dev = _device(records)
    lo, hi = window
    inside = sorted((r for r in dev if r.end > lo and r.start < hi), key=lambda r: r.start)
    if not inside:
        raise NoDeviceActivity(f"no device activity in the window {window}")
    tree = _HostTree([r for r in records if r.name in names], kinds=("span",))
    launcher = _launcher(records)
    idle: dict[str, float] = collections.defaultdict(float)

    def held(by, t):
        s = tree.innermost_at(by.thread, t, kinds=("span",)) if by is not None else None
        if s is None:
            open_ = [tree.innermost_at(th, t, kinds=("span",)) for th in tree.by_thread]
            s = max((x for x in open_ if x is not None), key=lambda x: x.start, default=None)
        return s.name if s is not None else OUTSIDE

    end = lo
    for r in inside:
        if r.start > end:
            idle[held(launcher(r), end)] += r.start - end
        end = max(end, r.end)
    if hi > end:
        idle[held(None, end)] += hi - end
    return dict(idle)
