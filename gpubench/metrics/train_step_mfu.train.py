"""train_step_mfu.train: model FLOPs of the window's completed steps
(the forward 3 times, attention over the causal half, nothing counted
for remat's recompute; ``work.train_step_flops``) over their time and
the chips' bf16 peak (989 TFLOP/s each)."""
from gpubench import work

LAYER = "train step (train/train_step.py, train/optimizer.py)"
MOVES = "train_tokens_per_s"
NEEDS_TRACE = False


def read(facts):
    w, mix = facts["window"], facts["mix"]
    if not w["durations"]:
        return None
    flops = work.train_step_flops(facts["config"], mix["batch"], mix["seq_len"]) * len(w["durations"])
    return flops / w["window_s"] / (facts["chips"] * work.PEAK_FLOPS_BF16) * 100
