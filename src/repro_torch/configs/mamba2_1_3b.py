"""Mamba2-1.3B: attention-free SSD [arXiv:2405.21060; unverified].
d_inner=4096 (expand 2), 64 heads x head_dim 64, state 128."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,      # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,           # no MLP: pure Mamba blocks
    vocab_size=50280,
    block_pattern=("mamba",),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk_size=256),
    tie_embeddings=True,
)
