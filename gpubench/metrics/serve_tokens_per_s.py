"""serve_tokens_per_s: every output token returned in the window, first
tokens included, over the window's seconds (host clock; the window ends
when its last step returns)."""
NEEDS_TRACE = False


def read(facts):
    w = facts["window"]
    return sum(s["tokens"] for s in w["steps"]) / w["window_s"]
