"""backward_ms.train: the device time of the work launched inside the
span ``train.backward`` (``torch.autograd.grad``, remat's recompute
included) a profiled step."""
from gpubench import spans as S

LAYER = "train backward (train/train_step.py value_and_grad)"
MOVES = "train_tokens_per_s"
NEEDS_TRACE = True


def read(facts):
    return S.device_ms_per_step(facts, S.TRAIN_BACKWARD)
