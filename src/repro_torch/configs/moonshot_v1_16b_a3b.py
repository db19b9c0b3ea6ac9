"""Moonlight-16B-A3B (moonshot): DeepSeek-V3-style MoE 64e top-6 + 2
shared experts [hf:moonshotai/Moonlight-16B-A3B; hf]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2, every_k_layers=1),
    rope_theta=5e4,
)
