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
import fnmatch
from typing import NamedTuple

STEP_SPAN = "profiled_step"  # a ``record_function`` span around each profiled step
WARMUP_CYCLES = 20_000_000   # the warm-up phase's device spin (about 10 ms)
MARGIN_S = 1.0               # host-only time kept before the first and after the last step

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

    import torch
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
    spans = sorted((r for r in records if r.where == "host" and r.name == step),
                   key=lambda r: r.start)
    if not spans:
        raise ValueError(f"no host span {step!r} in the records")
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
    spans = [r for r in records if r.where == "host" and r.name == name]
    if not spans:
        raise ValueError(f"no host span {name!r} in the records")
    when = _launch_time(records)
    return sorted({r.stream for r in _device(records)
                   if any(s.start <= when(r) <= s.end for s in spans)})


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
