"""step_mfu.serve: model FLOPs of the tokens served in the window over
its seconds and the chips' bf16 peak (989 TFLOP/s each): each decode
row at its own context, each prefill chunk's valid tokens over the
causal half of their pairs, the head once a row."""
from gpubench import work

LAYER = "model step (models/transformer.py prefill_step, decode_step)"
MOVES = "serve_tokens_per_s"
NEEDS_TRACE = False


def read(facts):
    cfg = facts["config"]
    flops = 0.0
    for s in facts["window"]["steps"]:
        d = s["decode"]
        if d:
            pairs = d["active_ctx"] if cfg["block"] == "attention" else 0
            flops += work.forward_flops(cfg, d["active"], pairs, d["active"])
        for pos, valid in s["chunks"]:
            flops += work.forward_flops(cfg, valid, work.causal_pairs(cfg, pos + valid, pos, valid), 1)
    return flops / facts["window"]["window_s"] / (facts["chips"] * work.PEAK_FLOPS_BF16) * 100
