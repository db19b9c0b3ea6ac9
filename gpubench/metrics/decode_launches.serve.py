"""decode_launches.serve: the runtime calls that put work on the device
(kernel and graph launches, memcpy and memset calls) inside the span
``engine.decode`` -- the decode step's issue -- a profiled step that
decoded.  A captured step counts one graph launch."""
from gpubench import spans as S

LAYER = "model step issue (models/transformer.py decode_step)"
MOVES = "serve_tokens_per_s"
NEEDS_TRACE = True


def read(facts):
    records = S.records_of(facts)
    n = S.count(records, S.DECODE)
    return S.span_launch_calls(records, S.DECODE) / n if n else None
