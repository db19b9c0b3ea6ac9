"""forward_ms.train: the device time of the work launched inside the
span ``train.forward`` (the loss's forward, ``lm_loss``) a profiled
step."""
from gpubench import spans as S

LAYER = "train forward (train/train_step.py lm_loss)"
MOVES = "train_tokens_per_s"
NEEDS_TRACE = True


def read(facts):
    return S.device_ms_per_step(facts, S.TRAIN_FORWARD)
