"""decode_step_ms.serve: the mean host time of the window's steps that
admitted nothing (a step ends in its logits' copy to the host)."""
LAYER = "engine (serve/engine.py Engine.step)"
MOVES = "serve_tokens_per_s"
NEEDS_TRACE = False


def plain_steps(facts):
    return [s["end"] - s["start"] for s in facts["window"]["steps"] if not s["admitted"]]


def read(facts):
    steps = plain_steps(facts)
    return sum(steps) / len(steps) * 1e3 if steps else None
