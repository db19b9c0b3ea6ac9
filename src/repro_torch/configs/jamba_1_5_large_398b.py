"""Jamba-1.5-Large (398B): Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].  Pattern period 8 (attention at position 4, as in
the paper); MoE every other layer.  SSD stands in for Mamba-1 (DESIGN §5).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    block_pattern=(
        "mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba",
    ),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576, every_k_layers=2),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk_size=256),
    rope_theta=None or 10000.0,
    notes="hybrid 1:7 attn:mamba; MoE every 2nd layer",
)
