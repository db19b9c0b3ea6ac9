"""recompute_ms.train: the device time of the work launched inside the
spans ``model.group`` that lie inside ``train.backward`` -- remat's
recompute of each layer group -- a profiled step."""
from gpubench import spans as S

LAYER = "remat recompute (models/transformer.py forward, graph._checkpoint)"
MOVES = "train_tokens_per_s"
NEEDS_TRACE = True


def read(facts):
    return S.device_ms_per_step(facts, S.MODEL_GROUP, within=S.TRAIN_BACKWARD)
