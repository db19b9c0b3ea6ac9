"""idle_share.serve: 1 - the device's busy time a profiled step over
the wall time of a step without the profiler (the profiler slows the
host, so its own steps would overstate the idle time)."""
LAYER = "device"
MOVES = "serve_tokens_per_s"
NEEDS_TRACE = True


def read(facts):
    prof, w = facts["profiled"], facts["window"]
    if not prof.get("busy_us") or not w["steps"]:
        return None
    busy = prof["busy_us"] / 1e6 / len(prof["steps"])
    return (1 - busy / (w["window_s"] / len(w["steps"]))) * 100
