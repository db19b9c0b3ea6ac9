"""Readings of a ``torch.profiler`` run of the port on the card.

Frozen copies of ``repro_torch/roofline/trace.py`` at commit 75044a6:
the records of a profiled run, device busy time, the longest idle gaps
with the host op that held each, kernel time by name and lost launches.
:func:`profile` is this benchmark's own: it runs a callable under the
profiler with the same warm-up phase and one-second margins as the
port's ``profile_steps`` (the profiler drops device records near the
ends of its window without them).

A reading of the device raises :class:`NoDeviceActivity` where the
records hold no kernel, memcpy or memset; it never reports a busy time
of 0 in place of a reading.
"""
from __future__ import annotations

import bisect
import collections
import time
from typing import NamedTuple

STEP_SPAN = "profiled_step"
WARMUP_CYCLES = 20_000_000
MARGIN_S = 1.0

_DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
_HOST_KINDS = {"cpu_op": "op", "user_annotation": "span", "cuda_runtime": "runtime",
               "cuda_driver": "runtime", "python_function": "python"}


class NoDeviceActivity(RuntimeError):
    """The profiler recorded no device activity where a reading needs it."""


class Record(NamedTuple):
    """One profiler event.  ``where`` is ``"device"`` (``kind`` kernel,
    memcpy or memset; ``stream`` the CUDA stream the profiler names) or
    ``"host"`` (``kind`` op, span, runtime, python; ``stream`` -1).
    Times are microseconds on the host's clock.  ``shapes`` and
    ``dtypes`` are a host op's inputs (a tensor list's entry is a tuple
    of shapes).  ``corr`` is the correlation id: a runtime call's equals
    the id of the device record it launched, a host op's is its own;
    ``link`` ties a device record or runtime call to its host op's
    ``corr``."""

    name: str
    where: str
    stream: int
    start: float
    end: float
    shapes: tuple = ()
    thread: int = 0
    kind: str = ""
    corr: int = 0
    link: int = 0
    dtypes: tuple = ()


def _shape(s):
    if isinstance(s, (list, tuple)) and s and isinstance(s[0], (list, tuple)):
        return tuple(tuple(int(d) for d in t) for t in s)
    return tuple(int(d) for d in s) if isinstance(s, (list, tuple)) else ()


def _kind(name: str, on_device: bool, act: str, span: bool) -> str | None:
    """A profiler event's kind: from its activity type where the
    profiler gives one, else from its name (``Memcpy``/``Memset`` on the
    device, ``cuda*``/``cu*`` runtime and driver calls on the host).
    None for the device-side copy of a host span."""
    if span:
        return None if on_device else "span"
    if on_device:
        if act:
            return _DEVICE_KINDS.get(act)
        return ("memcpy" if name.startswith("Memcpy") else
                "memset" if name.startswith("Memset") else "kernel")
    if act in _HOST_KINDS:
        return _HOST_KINDS[act]
    return "runtime" if name.startswith("cu") else "op"


def records_from_profile(prof, shapes: bool = True) -> list[Record]:
    """The events of a finished ``torch.profiler.profile`` run as
    :class:`Record` values, in the profiler's order.  Call it after the
    run has left its ``with`` block, with the card synchronised before
    the block ends (``torch.cuda.synchronize()``) so that every kernel
    of the window has its span.  ``shapes=False`` skips the host ops'
    input shapes and dtypes (a run without ``record_shapes``)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    append = out.append
    events = prof.profiler.kineto_results.events()
    # older PyTorch gives no activity type, older still no annotation flag
    has_act = bool(events) and hasattr(events[0], "activity_type")
    has_span = bool(events) and hasattr(events[0], "is_user_annotation")
    for e in events:
        name = e.name()
        on_device = e.device_type() == cuda
        kind = _kind(name, on_device, e.activity_type() if has_act else "",
                     has_span and e.is_user_annotation())
        if kind is None:
            continue
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        if on_device:
            append(Record(name, "device", e.device_resource_id(), start, end, (),
                          e.start_thread_id(), kind, e.correlation_id(),
                          e.linked_correlation_id()))
            continue
        sh = dt = ()
        if shapes:
            structured = getattr(e, "structured_input_shapes", None)
            sh = tuple(_shape(x) for x in (structured() if structured is not None else e.shapes()))
            dt = tuple(e.dtypes())
        append(Record(name, "host", -1, start, end, sh, e.start_thread_id(), kind,
                      e.correlation_id(), e.linked_correlation_id(), dt))
    # A span of ``record_function`` also has a copy on the device's
    # timeline, under its own name: where the profiler does not mark it,
    # a device record named as a host record is such a copy, and the host
    # record a span.
    host_names = {r.name for r in out if r.where == "host"}
    copies = {r.name for r in out if r.where == "device" and r.name in host_names}
    # a runtime call runs on the thread of the op that made it (the
    # profiler may name the two threads differently)
    op_thread = {r.corr: r.thread for r in out if r.kind == "op"}
    fixed = []
    for r in out:
        if r.name in copies:
            if r.where == "device":
                continue
            r = r._replace(kind="span")
        elif r.kind == "runtime" and r.link in op_thread and r.thread != op_thread[r.link]:
            r = r._replace(thread=op_thread[r.link])
        fixed.append(r)
    return fixed


def profile(steps, *, shapes: bool = False) -> list[Record]:
    """Call each of ``steps`` (callables) on the card under the profiler
    (CPU and CUDA activities), each in a span :data:`STEP_SPAN` that ends
    after a synchronise, after a warm-up phase whose events are dropped
    and with :data:`MARGIN_S` of host time before and after; returns the
    records."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile, record_function, schedule

    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  record_shapes=shapes,
                  schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        x = torch.zeros(1, device="cuda")
        for _ in range(32):
            x.add_(1)
        torch.cuda._sleep(WARMUP_CYCLES)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(MARGIN_S)
        for step in steps:
            with record_function(STEP_SPAN):
                step()
                torch.cuda.synchronize()
        time.sleep(MARGIN_S)
    return records_from_profile(prof, shapes=shapes)


def stem(name: str) -> str:
    """A kernel's name without ``void``, namespaces, template arguments
    and parameters: ``void ns::rmsnorm_regs<true, 8>(Args)`` ->
    ``rmsnorm_regs`` (the profiler reports demangled names)."""
    s = name.strip().removeprefix("void ").replace("(anonymous namespace)::", "")
    for ch in "<(":
        s = s.split(ch, 1)[0]
    return s.rsplit("::", 1)[-1].strip()


def busy_us(spans) -> float:
    """The length of the union of ``(start, end)`` spans."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _device(records) -> list[Record]:
    dev = [r for r in records if r.where == "device"]
    if not dev:
        raise NoDeviceActivity(
            "the profiler recorded no kernel, memcpy or memset: no device reading "
            "(was CUDA among its activities, and does the machine allow CUPTI tracing?)")
    return dev


def span_window(records, name: str = STEP_SPAN) -> tuple[float, float]:
    """From the start of the first host span ``name`` to the end of the
    last: the profiled steps' window."""
    spans = [r for r in records if r.where == "host" and r.name == name]
    if not spans:
        raise ValueError(f"no host span {name!r} in the records")
    return min(r.start for r in spans), max(r.end for r in spans)


def _clipped(dev, window):
    lo, hi = window
    return [(max(r.start, lo), min(r.end, hi)) for r in dev if r.end > lo and r.start < hi]


def device_busy_us(records, window) -> float:
    """Device busy time in ``window``: the union of its kernel, memcpy and
    memset spans there."""
    spans = _clipped(_device(records), window)
    if not spans:
        raise NoDeviceActivity(f"no device activity in the window {window}")
    return busy_us(spans)


def _launcher(records):
    """Device record -> the host record that launched it: its runtime
    call (matched by correlation id), else the host op it is linked to,
    else None (a kernel launched outside any op)."""
    runtime = {r.corr: r for r in records if r.kind == "runtime" and r.corr}
    ops = {r.corr: r for r in records if r.kind == "op" and r.corr}

    def launcher(r):
        return runtime.get(r.corr) if r.corr in runtime else ops.get(r.link) if r.link else None

    return launcher


class _HostTree:
    """Host ops, spans and runtime calls nested per thread: each entry's
    parent is the innermost entry on its thread that contains it."""

    def __init__(self, records, kinds=("op", "runtime", "span")):
        self.by_thread: dict[int, list[Record]] = collections.defaultdict(list)
        for r in records:
            if r.where == "host" and r.kind in kinds:
                self.by_thread[r.thread].append(r)
        self.parent: dict[int, Record | None] = {}
        self.starts: dict[int, list[float]] = {}
        for thread, rs in self.by_thread.items():
            rs.sort(key=lambda r: (r.start, -r.end))
            stack: list[Record] = []
            for r in rs:
                while stack and stack[-1].end < r.end:
                    stack.pop()
                self.parent[id(r)] = stack[-1] if stack else None
                stack.append(r)
            self.starts[thread] = [r.start for r in rs]

    def ancestors(self, r):
        p = self.parent.get(id(r))
        while p is not None:
            yield p
            p = self.parent.get(id(p))

    def innermost_at(self, thread: int, t: float, kinds=("op", "runtime")) -> Record | None:
        """The innermost entry of ``kinds`` running on ``thread`` at ``t``."""
        rs = self.by_thread.get(thread, [])
        i = bisect.bisect_right(self.starts.get(thread, []), t) - 1
        if i < 0:
            return None
        r: Record | None = rs[i]
        while r is not None and not (r.end > t and r.kind in kinds):
            r = self.parent.get(id(r))
        return r


def longest_gaps(records, n: int = 10, window=None) -> list[tuple[float, float, str]]:
    """The ``n`` longest device idle gaps in ``window`` (all the device
    records' extent if None) as ``(length_us, start_us, host_op)``,
    longest first.  ``host_op`` is the innermost host op or runtime call
    running, when the gap began, on the thread that issued the kernel
    which ended it (``"(python)"`` where no op was running: the host was
    in Python between ops)."""
    dev = _device(records)
    if window is None:
        window = (min(r.start for r in dev), max(r.end for r in dev))
    lo, hi = window
    inside = sorted((r for r in dev if r.end > lo and r.start < hi), key=lambda r: r.start)
    if not inside:
        raise NoDeviceActivity(f"no device activity in the window {window}")
    tree = _HostTree(records)
    launcher = _launcher(records)
    threads = collections.Counter(r.thread for r in records if r.where == "host")
    main = threads.most_common(1)[0][0] if threads else 0
    gaps = []
    end = lo
    for r in inside:
        if r.start > end:
            by = launcher(r)
            thread = by.thread if by is not None else main
            op = tree.innermost_at(thread, end)
            gaps.append((r.start - end, end, op.name if op else "(python)"))
        end = max(end, r.end)
    if hi > end:
        op = tree.innermost_at(main, end)
        gaps.append((hi - end, end, op.name if op else "(python)"))
    return sorted(gaps, key=lambda g: -g[0])[:n]


def kernel_time_by_name(records, n: int = 10, window=None) -> list[tuple[str, float, int]]:
    """Device time summed by kernel stem (memcpy and memset by their
    names), as ``(stem, total_us, count)``, the ``n`` largest first."""
    dev = _device(records)
    if window is not None:
        dev = [r for r in dev if r.end > window[0] and r.start < window[1]]
    total: dict[str, float] = collections.defaultdict(float)
    count: collections.Counter = collections.Counter()
    for r in dev:
        key = stem(r.name) if r.kind == "kernel" else r.name
        total[key] += r.end - r.start
        count[key] += 1
    return sorted(((k, total[k], count[k]) for k in total), key=lambda x: -x[1])[:n]


_LAUNCH_CALLS = ("LaunchKernel", "LaunchCooperativeKernel", "GraphLaunch")


def _is_launch(r) -> bool:
    """A runtime call that puts work on the device: cudaLaunchKernel(ExC),
    cuLaunchKernel(Ex), cudaGraphLaunch (whose kernels carry its
    correlation id), ...; not cudaLaunchHostFunc."""
    return r.kind == "runtime" and any(c in r.name for c in _LAUNCH_CALLS)


def lost_launches(records) -> int:
    """Launch calls whose device record is missing: runtime calls that
    launch device work whose correlation id no device record carries.
    0 in a complete trace; more means the profiler dropped device
    records, and no count of launches from it holds."""
    launched = {r.corr for r in records if r.where == "device"}
    return sum(1 for r in records if _is_launch(r) and r.corr not in launched)
