"""draw_ms.serve: the mean host time of the span ``engine.draw`` -- the
(slots, vocabulary) fp32 logits' copy to the host and the batched draw
on the host -- over the profiled steps that decoded (one span each).
The stream's work before it is waited for in ``engine.decode_wait``."""
from gpubench import spans as S

LAYER = "engine draw (serve/engine.py Engine.step: logits to host, sample_token)"
MOVES = "serve_tokens_per_s"
NEEDS_TRACE = True


def read(facts):
    records = S.records_of(facts)
    n = S.count(records, S.DRAW)
    return S.span_host_us(records, S.DRAW) / n / 1e3 if n else None
