"""prefill_ms.serve: what the window's admitting steps took above a
plain decode step (``decode_step_ms.serve``), summed and divided by the
requests they admitted."""
LAYER = "engine admission (Engine._admit, _prefill_single)"
MOVES = "itl_p95_ms"
NEEDS_TRACE = False


def read(facts):
    steps = facts["window"]["steps"]
    plain = [s["end"] - s["start"] for s in steps if not s["admitted"]]
    admitting = [s for s in steps if s["admitted"]]
    if not plain or not admitting:
        return None
    base = sum(plain) / len(plain)
    extra = sum(s["end"] - s["start"] - base for s in admitting)
    return extra / sum(s["admitted"] for s in admitting) * 1e3
