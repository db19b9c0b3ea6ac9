"""Llama-3.2-Vision-90B backbone: cross-attention image layers every 5th
layer [hf:meta-llama/Llama-3.2-11B-Vision family; unverified].  Vision
frontend is a stub: input_specs() provides precomputed tile/patch
embeddings (1601 tokens/image, d_model)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    vision_tokens=1601,
    rope_theta=5e5,
    notes="cross-attn layers replace self-attn at positions 4,9,... (DESIGN §5)",
)
