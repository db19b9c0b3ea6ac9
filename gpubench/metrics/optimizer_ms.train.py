"""optimizer_ms.train: the device time of the work launched inside the
span ``train.optimizer`` (``adamw_update``) a profiled step."""
from gpubench import spans as S

LAYER = "optimizer (train/optimizer.py adamw_update)"
MOVES = "train_tokens_per_s"
NEEDS_TRACE = True


def read(facts):
    return S.device_ms_per_step(facts, S.TRAIN_OPTIMIZER)
