"""Llama-4-Maverick 400B-A17B: MoE 128e top-1 + shared expert, early
fusion [hf:meta-llama/Llama-4-Scout-17B-16E family; unverified].
MoE every 2nd layer (HF interleave_moe_layer_step=2) with one shared
expert; dense layers use d_ff=16384 (HF intermediate_size_mlp), experts
d_ff=8192 (the assigned figure).  Totals ~402B params, ~17B active."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=202048,
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192,
                  num_shared_experts=1, every_k_layers=2),
    rope_theta=5e5,
    notes="full attention in all layers (no chunked-local variant)",
)
