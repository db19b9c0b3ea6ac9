"""admit_overhead_ms.serve: the mean host time of an admission (the
span ``engine.admit``) less its prefill chunks' issue
(``engine.prefill_chunk``) and its wait for them
(``engine.prefill_wait``): the one-slot cache's allocation, the first
token's copy and draw, and the copy into the slot, over the admissions
in the profiled steps."""
from gpubench import spans as S

LAYER = "engine admission (Engine._admit, _prefill_single)"
MOVES = "itl_p95_ms"
NEEDS_TRACE = True


def read(facts):
    records = S.records_of(facts)
    n = S.count(records, S.ENGINE_ADMIT)
    if not n:
        return None
    us = S.span_host_us(records, S.ENGINE_ADMIT, minus=(S.PREFILL_CHUNK, S.PREFILL_WAIT))
    return us / n / 1e3
