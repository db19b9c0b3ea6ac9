"""Readings of a ``torch.profiler`` run: the port's counterpart of ``repro.roofline.hlo_parse``.

The reference reads a compiled XLA module: its loop-aware HBM bytes, its
collectives, and structural facts (the LM head only inside the final
stage's conditional, no slab-sized cache scatter).  An eager PyTorch
program has no module to read, so the port reads what ran: a
``torch.profiler.profile`` run with ``activities=[CPU, CUDA]`` and
``record_shapes=True``, taken over a few steps.

:func:`profile_steps` takes such a run of a step function on the card,
after a warm-up phase the profiler discards.
:func:`records_from_profile` turns the run into plain :class:`Record`
values (name; device or host; stream; start and end in microseconds;
input shapes and dtypes; thread; the correlation ids that tie a kernel
to its launch).  Everything else is a pure function of such records, so
tests can feed hand-made lists:

* :func:`busy_us` -- the union of (start, end) spans;
* :func:`idle_share` -- 1 - device busy / window, the busy time the
  union of the kernel, memcpy and memset spans in the window;
* :func:`longest_gaps` -- the device's idle gaps, each with the
  innermost host op (an ``aten::`` op or a ``cuda*`` runtime call) that
  was running on the issuing thread when the gap began;
* :func:`kernel_time_by_name` -- device time summed by kernel stem;
* :func:`lost_launches` and :func:`clock_lead_us` -- launch calls whose
  device record the profiler dropped, and how far its device times lead
  their launches (no count of launches from a trace that lost some holds);
* :func:`launches`, :func:`launch_streams` and :func:`only_on_streams`
  -- launches of a kernel in each profiled step, the streams it ran on,
  and whether it ran on given streams only (the counterparts of
  ``fused_region_present`` and ``head_matmul_conditional_only``: a
  kernel is on the path when it launched, and the emit belongs to the
  final stage when it ran on that stage's stream only);
* :func:`slab_copies` -- the counterpart of ``slab_scatter_counts``:
  the host's copy, scatter and clone ops that wrote at least one
  layer's K slab;
* :func:`collective_bytes` -- the counterpart of
  ``collective_bytes_from_hlo``, from the collectives' operand shapes.

The program's own spans: :func:`span` opens a ``record_function`` span
only while a profiler is recording, and the engine, the train step and
the model open one at each layer boundary, under the names
:data:`PROGRAM_SPANS` lists.  Any ``torch.profiler`` session sees them,
on the host clock that it maps the device records onto; with no
profiler running a span enters nothing.  Their readers:

* :func:`span_device_us` -- device busy time of the work launched inside
  spans of one name (optionally only those inside spans of another);
* :func:`span_host_us` -- host time of spans of one name, less the time
  of named child spans;
* :func:`span_launch_calls` -- the runtime calls inside spans of one name
  that put work on the device;
* :func:`idle_by_span` -- the device's idle time summed by the program
  span that held the host when each gap began.

``analyze_hlo``'s loop-aware HBM count has no counterpart: per-kernel
bytes come from :mod:`repro_torch.roofline.analytic`.

A function that reads the device raises :class:`NoDeviceActivity` when
the records hold no kernel, memcpy or memset (a profiler without CUPTI
records none): it never reports an idle share of 1.0 or 0.0 in place of
a reading.  An empty list is not a pass for any of them.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import fnmatch
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

STEP_SPAN = "profiled_step"  # a ``record_function`` span around each profiled step
WARMUP_CYCLES = 20_000_000   # the warm-up phase's device spin (about 10 ms)
MARGIN_S = 1.0               # host-only time kept before the first and after the last step

# The program's spans (:func:`span`); indentation shows nesting.
ENGINE_STEP = "engine.step"               # Engine.step()
ENGINE_ADMIT = "engine.admit"             #   one request taken from the queue
PREFILL_CACHE = "engine.prefill_cache"    #     the one-slot cache's allocation
PREFILL_CHUNK = "engine.prefill_chunk"    #     each prefill chunk's issue
PREFILL_WAIT = "engine.prefill_wait"      #     the wait for the stream before the draw
PREFILL_DRAW = "engine.prefill_draw"      #     the first token's draw on the device, its id to the host
SLOT_COPY = "engine.slot_copy"            #     the one-slot cache into its batch slot
DECODE = "engine.decode"                  #   the decode step's issue
DECODE_WAIT = "engine.decode_wait"        #   the wait for the stream before the draw
DRAW = "engine.draw"                      #   the batched draw on the device, the ids to the host
TRAIN_STEP = "train.step"                 # make_train_step's step
TRAIN_FORWARD = "train.forward"           #   lm_loss, once a micro-batch
TRAIN_BACKWARD = "train.backward"         #   torch.autograd.grad (remat's recompute inside)
TRAIN_OPTIMIZER = "train.optimizer"       #   adamw_update
MODEL_GROUP = "model.group"               # forward's layer group, and its recompute
PROGRAM_SPANS = (ENGINE_STEP, ENGINE_ADMIT, PREFILL_CACHE, PREFILL_CHUNK, PREFILL_WAIT,
                 PREFILL_DRAW, SLOT_COPY, DECODE, DECODE_WAIT, DRAW, TRAIN_STEP, TRAIN_FORWARD,
                 TRAIN_BACKWARD, TRAIN_OPTIMIZER, MODEL_GROUP)
OUTSIDE = "(outside)"  # :func:`idle_by_span`'s key for gaps outside every program span

_OFF = contextlib.nullcontext()

_DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
_HOST_KINDS = {"cpu_op": "op", "user_annotation": "span", "cuda_runtime": "runtime",
               "cuda_driver": "runtime", "python_function": "python"}


def span(name: str):
    """A ``record_function`` span ``name`` while a profiler is recording,
    else one shared context that does nothing: such a span costs under a
    microsecond, where a ``record_function`` with no profiler running
    costs over ten microseconds of dispatcher calls.  Use it as ``with
    span(name): ...``; the profiler's own ``with`` block turns the spans
    on."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


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


def profile_steps(step, steps: int, *, shapes: bool = True) -> list[Record]:
    """``step(i)`` for i < ``steps`` on the card under ``torch.profiler``
    (CPU and CUDA activities), each call in a span :data:`STEP_SPAN` that
    ends after a synchronise; returns the run's records.  A warm-up phase
    runs first, whose events the profiler discards: tracing may lose the
    first device activities after it starts (a step's first launches
    went missing without one).

    The kept window opens :data:`MARGIN_S` before the first step and
    closes as long after the last, with no device work in either margin.
    The profiler drops every device record whose time, moved onto the
    host's clock, lies outside that window, and the move can be off by
    milliseconds or more (kernels stamped before their own launch call:
    :func:`clock_lead_us`), so without the margins a kernel near either
    end of the steps can go missing from the trace."""
    import time

    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        x = torch.zeros(1, device="cuda")
        for _ in range(32):
            x.add_(1)
        torch.cuda._sleep(WARMUP_CYCLES)
        torch.cuda.synchronize()
        prof.step()  # the warm-up ends: the trace that is kept starts
        time.sleep(MARGIN_S)
        for i in range(steps):
            with record_function(STEP_SPAN):
                step(i)
                torch.cuda.synchronize()
        time.sleep(MARGIN_S)
    return records_from_profile(prof, shapes=shapes)


# ---------------------------------------------------------------------------
# Pure readings
# ---------------------------------------------------------------------------


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


def _spans(records, name: str) -> list[Record]:
    spans = [r for r in records if r.where == "host" and r.name == name]
    if not spans:
        raise ValueError(f"no host span {name!r} in the records")
    return spans


def span_window(records, name: str = STEP_SPAN) -> tuple[float, float]:
    """From the start of the first host span ``name`` to the end of the
    last: the profiled steps' window."""
    spans = _spans(records, name)
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


def idle_share(records, window) -> float:
    """1 - device busy / the window's length."""
    lo, hi = window
    if hi <= lo:
        raise ValueError(f"an empty window {window}")
    return 1.0 - device_busy_us(records, window) / (hi - lo)


def _launcher(records):
    """Device record -> the host record that launched it: its runtime
    call (matched by correlation id), else the host op it is linked to,
    else None (a kernel launched outside any op)."""
    runtime = {r.corr: r for r in records if r.kind == "runtime" and r.corr}
    ops = {r.corr: r for r in records if r.kind == "op" and r.corr}

    def launcher(r):
        return runtime.get(r.corr) if r.corr in runtime else ops.get(r.link) if r.link else None

    return launcher


def _launch_time(records):
    """Device record -> the host time of its launch (:func:`_launcher`'s
    start), else its own start."""
    launcher = _launcher(records)

    def when(r):
        host = launcher(r)
        return host.start if host is not None else r.start

    return when


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


def _matching(records, pattern):
    return [r for r in _device(records) if r.kind == "kernel"
            and fnmatch.fnmatchcase(stem(r.name), pattern)]


def launches(records, pattern: str, step: str = STEP_SPAN) -> list[int]:
    """Launches of the kernels whose stem matches ``pattern`` (a
    ``fnmatch`` pattern) in each host span ``step`` (one per profiled
    step), in order; a launch belongs to the span its runtime call
    lies in."""
    dev = _matching(records, pattern)
    spans = sorted(_spans(records, step), key=lambda r: r.start)
    when = _launch_time(records)
    starts = [s.start for s in spans]
    counts = [0] * len(spans)
    for r in dev:
        t = when(r)
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i].end:
            counts[i] += 1
    return counts


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


def clock_lead_us(records) -> float:
    """How far, at most, a device record starts before the runtime call
    that launched it, in us (0 if none does): the error of the
    profiler's move of device times onto the host's clock, since no
    kernel starts before its launch."""
    calls = {r.corr: r for r in records if _is_launch(r) and r.corr}
    leads = [calls[r.corr].start - r.start for r in records
             if r.where == "device" and r.corr in calls]
    return max([0.0, *leads])


def launch_streams(records, pattern: str) -> list[int]:
    """The streams the kernels whose stem matches ``pattern`` ran on."""
    return sorted({r.stream for r in _matching(records, pattern)})


def only_on_streams(records, pattern: str, streams) -> bool:
    """True iff the kernels whose stem matches ``pattern`` launched at
    least once and ran on ``streams`` only: the counterpart of
    ``head_matmul_conditional_only`` (the emit on the final stage's
    stream).  A trace without the kernel is not a pass."""
    found = launch_streams(records, pattern)
    return bool(found) and set(found) <= set(streams)


def span_streams(records, name: str) -> list[int]:
    """The streams of the device work launched inside host spans ``name``
    (a script marks a stream by launching on it inside such a span)."""
    spans = _spans(records, name)
    when = _launch_time(records)
    return sorted({r.stream for r in _device(records)
                   if any(s.start <= when(r) <= s.end for s in spans)})


class _Cover:
    """The union of intervals, and whether a time lies in it."""

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
    """Device busy time (the union of the records' spans) of the work
    launched inside host spans ``name``: each device record belongs to a
    span when its launch call (:func:`_launch_time`) lies in it.  With
    ``within``, only the spans ``name`` that lie inside a span
    ``within``.  Containment is by time, on any thread, as in
    :func:`launches`: autograd launches the backward from a thread of its
    own."""
    spans = _spans(records, name)
    if within is not None:
        outer = _spans(records, within)
        spans = [s for s in spans if any(o.start <= s.start and s.end <= o.end for o in outer)]
    cover = _Cover((s.start, s.end) for s in spans)
    when = _launch_time(records)
    return busy_us([(r.start, r.end) for r in _device(records) if when(r) in cover])


def span_host_us(records, name: str, minus=()) -> float:
    """The summed host time of spans ``name``, less the time that their
    child spans (on the same thread) named in ``minus`` cover."""
    children = [r for r in records if r.where == "host" and r.name in minus]
    total = 0.0
    for s in _spans(records, name):
        inner = [(c.start, c.end) for c in children
                 if c.thread == s.thread and s.start <= c.start and c.end <= s.end]
        total += s.end - s.start - busy_us(inner)
    return total


def _puts_work(r) -> bool:
    """A runtime call that puts work on the device: a kernel or graph
    launch (:func:`_is_launch`), a memcpy or a memset."""
    return _is_launch(r) or (r.kind == "runtime" and ("Memcpy" in r.name or "Memset" in r.name))


def span_launch_calls(records, name: str) -> int:
    """The runtime calls that put work on the device (kernel and graph
    launches, memcpy and memset calls) starting inside host spans
    ``name``, by time on any thread.  A graph launch is one call,
    however many kernels it runs."""
    cover = _Cover((s.start, s.end) for s in _spans(records, name))
    return sum(1 for r in records if _puts_work(r) and r.start in cover)


def idle_by_span(records, window, names=PROGRAM_SPANS) -> dict[str, float]:
    """The device's idle time in ``window``, in us, summed by the
    innermost span of ``names`` that was open when each gap began on the
    thread that issued the record ending the gap; where that thread had
    none open (autograd's thread between two recomputes, the gap up to
    the window's end), the one opened last among those open on any
    thread.  A gap outside every such span counts under :data:`OUTSIDE`.
    The values sum to the window's idle time.  Gaps are device times set
    against host spans, so they hold to within :func:`clock_lead_us`."""
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


# ---------------------------------------------------------------------------
# Cache copies and collectives, from the host ops' shapes
# ---------------------------------------------------------------------------

# bytes of an element by the profiler's dtype names; a name it does not
# know (a tensor list's 'TensorList') counts 4
_ITEMSIZE = {
    "float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2, "long int": 8, "int": 4,
    "short int": 2, "signed char": 1, "unsigned char": 1, "bool": 1,
    "c10::complex<float>": 8, "c10::complex<double>": 16, "c10::Float8_e4m3fn": 1,
    "c10::Float8_e5m2": 1,
}
# op -> the input whose elements it writes: "self" ops write all of
# input 0 (a copy into it, or a new tensor of its shape), indexed
# in-place writes the values they are given, concatenations the sum of
# their list
_WRITES = {
    "aten::copy_": 0, "aten::clone": 0, "aten::index_put": 0, "aten::scatter": 0,
    "aten::index_copy": 0, "aten::slice_scatter": 0, "aten::select_scatter": 0,
    "aten::index_add": 0,
    "aten::index_put_": 2, "aten::_index_put_impl_": 2, "aten::index_copy_": 3,
    "aten::scatter_": 2, "aten::index_add_": 3,
    "aten::cat": "list", "aten::_cat": "list", "aten::stack": "list",
}
# ops that only move data: a write nested in one of them is the
# program's copy; a write nested in any other op (the layout copy
# ``torch.einsum`` makes of an operand for its matmul) is part of that op
_COPY_FAMILY = set(_WRITES) | {
    "aten::to", "aten::_to_copy", "aten::contiguous", "aten::reshape", "aten::flatten",
    "aten::repeat", "aten::expand_as", "aten::_reshape_alias",
}


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def written_bytes(r: Record) -> int:
    """Bytes the copy, scatter or clone op ``r`` writes, from its input
    shapes and dtypes (0 for any other op)."""
    arg = _WRITES.get(r.name)
    if arg is None or not r.shapes:
        return 0
    dtypes = list(r.dtypes) + [""] * len(r.shapes)
    if arg == "list":
        entry = r.shapes[0]
        shapes = entry if entry and isinstance(entry[0], tuple) else ()
        return sum(_numel(s) for s in shapes) * _ITEMSIZE.get(dtypes[0], 4)
    if arg >= len(r.shapes):
        return 0
    return _numel(r.shapes[arg]) * _ITEMSIZE.get(dtypes[arg], 4)


def slab_copy_ops(records, slab_bytes: int) -> list[tuple[str, int, float]]:
    """The program's copies of at least ``slab_bytes`` (one layer's K
    slab) as ``(op, bytes, start_us)``: copy, scatter, clone and
    concatenation ops that write that many bytes, counted once at the
    outermost such op (a clone and the copy inside it are one copy) and
    only where every op around them only moves data.  An in-place row
    write (``index_put_`` of B rows into the cache) writes its rows, not
    the slab it indexes."""
    host = [r for r in records if r.where == "host" and r.kind == "op"]
    if not host:
        raise ValueError("no host ops in the records: nothing to read")
    tree = _HostTree(records, kinds=("op",))
    found = []
    for r in host:
        size = written_bytes(r)
        if size < slab_bytes:
            continue
        up = list(tree.ancestors(r))
        if any(a.name not in _COPY_FAMILY for a in up):
            continue
        if any(written_bytes(a) >= slab_bytes for a in up):
            continue  # counted at the outer op
        found.append((r.name, size, r.start))
    return found


def slab_copies(records, slab_bytes: int) -> int:
    """How many slab-sized copies the host's ops made (see
    :func:`slab_copy_ops`)."""
    return len(slab_copy_ops(records, slab_bytes))


# ring all-reduce moves about twice its buffer; the others about once
_COLLECTIVES = {"all_reduce": 2.0, "allreduce": 2.0, "all_gather": 1.0, "allgather": 1.0,
                "reduce_scatter": 1.0, "all_to_all": 1.0, "alltoall": 1.0, "send": 1.0,
                "recv": 0.0, "broadcast": 1.0}


def collective_bytes(records) -> dict:
    """Operand bytes of the collective ops the host issued (``c10d::`` and
    ``nccl:`` ops), by kind, and their sum weighted by each kind's ring
    traffic: the counterpart of ``collective_bytes_from_hlo``.  One card
    issues none: 0."""
    by_kind: dict[str, int] = collections.defaultdict(int)
    counts: collections.Counter = collections.Counter()
    for r in records:
        if r.where != "host" or not r.name.startswith(("c10d::", "nccl:")):
            continue
        base = r.name.split("::", 1)[-1].split(":", 1)[-1].rstrip("_").lower()
        kind = next((k for k in _COLLECTIVES if base.startswith(k)), None)
        if kind is None:
            continue
        dtypes = list(r.dtypes) + [""] * len(r.shapes)
        nbytes = 0
        for s, dt in zip(r.shapes, dtypes):
            shapes = s if s and isinstance(s[0], tuple) else (s,) if s else ()
            nbytes += sum(_numel(x) for x in shapes) * _ITEMSIZE.get(dt, 4)
        by_kind[kind] += nbytes
        counts[kind] += 1
    weighted = sum(b * _COLLECTIVES[k] for k, b in by_kind.items())
    return {"bytes_by_kind": dict(by_kind), "counts": dict(counts), "weighted_bytes": weighted}
