"""What the drivers share: the clock, the device record, the traced
stretch's readings, freeing the program before the reference runs."""
from __future__ import annotations

import gc
import time

from gpubench import trace as TR

now = time.perf_counter


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_record(run, peak: int) -> dict:
    import torch

    if torch.device(run.device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": run.chips,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": run.chips, "memory_peak_bytes": int(peak)}


def memory_peak(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def profiled(run, steps) -> dict:
    """Run ``steps`` (callables) under the profiler on the card; the
    records, the device's busy time and the traced window (none on the
    CPU, where the profiler sees no device)."""
    import torch

    if torch.device(run.device).type != "cuda":
        for s in steps:
            s()
        return {"records": None}
    records = TR.profile(steps)
    window = TR.span_window(records)
    out = {"records": records, "window_us": window[1] - window[0],
           "lost_launches": TR.lost_launches(records)}
    try:
        out["busy_us"] = TR.device_busy_us(records, window)
    except TR.NoDeviceActivity:
        out["busy_us"] = None
    return out


def trace_fields(prof: dict) -> tuple[dict, dict | None]:
    """The ``device`` block's busy and window seconds and the
    ``breakdown`` of a profiled stretch."""
    if not prof.get("records") or prof.get("busy_us") is None:
        return {}, None
    records, window = prof["records"], TR.span_window(prof["records"])
    ops = [[name, us / 1e6] for name, us, _ in TR.kernel_time_by_name(records, 10, window)]
    gaps = [[op, us / 1e6] for us, _, op in TR.longest_gaps(records, 10, window)]
    return ({"busy_s": prof["busy_us"] / 1e6, "window_s": prof["window_us"] / 1e6},
            {"device_ops": ops, "idle_gaps": gaps})


def kernel_us(records, prefixes) -> float | None:
    """Device time of the kernels whose stem starts with one of
    ``prefixes``, in the profiled window; None where none ran."""
    if not records:
        return None
    window = TR.span_window(records)
    total = [us for name, us, _ in TR.kernel_time_by_name(records, 10 ** 6, window)
             if name.startswith(tuple(prefixes))]
    return sum(total) if total else None


def free(device) -> None:
    """Drop what the program left and return its memory to the card."""
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
