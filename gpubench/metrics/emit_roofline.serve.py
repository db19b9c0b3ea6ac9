"""emit_roofline.serve: the least time of the profiled steps' emits
(``work.emit_work``, the head read once a call however many launches it
takes) over the device time of the kernels named here."""
from gpubench import work
from gpubench.drivers.common import kernel_us

LAYER = "kernels (kernels/decode_attention, kernels/emit_norm_logits)"
MOVES = "serve_tokens_per_s"
NEEDS_TRACE = True
KERNELS = ("emit_",)


def read(facts):
    prof = facts["profiled"]
    cfg = facts["config"]
    elem = 2 if cfg["dtype"] == "bfloat16" else 4
    us = kernel_us(prof.get("records"), KERNELS)
    if not us:
        return None
    bound = sum(
        work.bound_ms(*work.emit_work(d["batch"], cfg["d_model"], cfg["table_rows"], elem,
                                      scaled=cfg["norm"] == "rmsnorm"), cfg["dtype"])[0]
        for d in (s["decode"] for s in prof["steps"]) if d)
    return bound / (us / 1e3) * 100
