"""MusicGen-medium backbone: decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].  The EnCodec frontend is a stub: input_specs()
provides precomputed frame embeddings (sum of the 4 codebook embeddings);
the head predicts one codebook (vocab 2048)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    embeds_input=True,
)
