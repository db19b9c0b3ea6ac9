"""train_tokens_per_s: tokens of the steps completed in the window over
the time from its start to the end of the last completed step (each
step ends in a synchronise; a step still running at the end is not
counted)."""
NEEDS_TRACE = False


def read(facts):
    w = facts["window"]
    return w["tokens"] / w["window_s"] if w["durations"] else None
