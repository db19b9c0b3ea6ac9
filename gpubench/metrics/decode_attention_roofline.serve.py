"""decode_attention_roofline.serve: the least time of the profiled
steps' decode attention (``work.decode_attention_work`` over the valid
rows each step had, once a layer) over the device time of the kernels
named here."""
from gpubench import work
from gpubench.drivers.common import kernel_us

LAYER = "kernels (kernels/decode_attention, kernels/emit_norm_logits)"
MOVES = "serve_tokens_per_s"
NEEDS_TRACE = True
KERNELS = ("decode_attention",)


def read(facts):
    prof = facts["profiled"]
    cfg = facts["config"]
    elem = 2 if cfg["dtype"] == "bfloat16" else 4
    us = kernel_us(prof.get("records"), KERNELS)
    if not us:
        return None
    bound = sum(
        cfg["n_layers"] * work.bound_ms(*work.decode_attention_work(
            d["batch"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], d["rows_all"], elem),
            cfg["dtype"])[0]
        for d in (s["decode"] for s in prof["steps"]) if d)
    return bound / (us / 1e3) * 100
