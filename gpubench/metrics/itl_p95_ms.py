"""itl_p95_ms: the 95th percentile of every gap between successive
tokens of a request in the window, each token timed when the step that
made it returns (two tokens returned by one step are 0 apart)."""
import numpy as np

NEEDS_TRACE = False


def read(facts):
    gaps = facts["window"]["gaps"]
    return float(np.percentile(gaps, 95)) * 1e3 if gaps else None
