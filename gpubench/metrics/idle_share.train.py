"""idle_share.train: 1 - the device's busy time a profiled step over
the wall time of a step without the profiler."""
LAYER = "device"
MOVES = "train_tokens_per_s"
NEEDS_TRACE = True


def read(facts):
    prof, w = facts["profiled"], facts["window"]
    if not prof.get("busy_us") or not w["durations"]:
        return None
    busy = prof["busy_us"] / 1e6 / facts["mix"]["profiled_steps"]
    return (1 - busy / (sum(w["durations"]) / len(w["durations"]))) * 100
