"""Architecture + shape configuration (PyTorch port of ``repro.configs.base``).

One ``ArchConfig`` per assigned architecture (``configs/<id>.py``), the
same fields as the JAX package's, with ``dtype`` a ``torch.dtype``.
Shapes (train_4k / prefill_32k / decode_32k / long_500k) are global.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    every_k_layers: int = 1  # MoE replaces the MLP in layers where (i % k == k-1)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    num_groups: int = 1  # B/C groups (GVA)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # block pattern, repeated to cover num_layers; entries: "attn" | "mamba"
    block_pattern: tuple[str, ...] = ("attn",)
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    qkv_bias: bool = False
    qk_norm: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm_nonparam
    rope_theta: float = 10000.0
    cross_attn_every: int = 0  # >0: every k-th layer is cross-attention (VLM)
    vision_tokens: int = 0     # stubbed frontend sequence length
    embeds_input: bool = False # audio/vlm stub: model takes embeddings directly
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    norm_eps: float = 1e-5
    # per-op implementation dispatch (repro_torch.kernels.get_impl):
    # "plain" runs the PyTorch reference ops, "cuda" the hand-written
    # Hopper kernels (a CUDA device is required), "auto" picks "cuda" for
    # tensors on a CUDA device and "plain" for tensors on the CPU.
    kernels: str = "auto"
    notes: str = ""

    @property
    def attn_free(self) -> bool:
        return "attn" not in self.block_pattern and self.cross_attn_every == 0

    @property
    def sub_quadratic(self) -> bool:
        return "mamba" in self.block_pattern

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_groups(self) -> int:
        assert self.num_layers % self.pattern_period == 0
        return self.num_layers // self.pattern_period

    def with_overrides(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class DecodePipelineConfig:
    """Stream-shaped serving knobs (see repro_torch.serve.engine.StreamEngine).

    The decode loop runs as a ``Stream.feedback`` program: the
    transformer's layer groups split into ``num_cells`` pipeline cells,
    the batch splits into ``microbatches`` in-flight items (the feedback
    lag), and one round executes ``round_steps`` decode steps with up to
    ``admit_per_round`` freshly prefilled requests admitted into retired
    slots inside the round.
    """

    num_cells: int = 4        # layer-group pipeline cells (must divide groups)
    microbatches: int = 4     # in-flight request microbatches = feedback lag
    schedule: str = "gpipe"   # gpipe | one_f_one_b | interleaved
    interleave: int = 1       # virtual stages per stage (interleaved only)
    round_steps: int = 8      # decode steps per round
    admit_per_round: int = 4  # admissions a round may install
    axis_name: str = "pod"    # the FutureEvaluator's name for its stage axis
    # kernel dispatch for the decode hot path ("plain" | "cuda" | "auto");
    # None inherits the model's ArchConfig.kernels knob.
    kernels: str | None = None


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        shapes.append("long_500k")  # skip for pure full-attention archs
    return shapes


# smoke-test reduction: same family, tiny dims
def smoke_config(cfg: ArchConfig) -> ArchConfig:
    period = cfg.pattern_period
    num_layers = 2 * period if cfg.cross_attn_every == 0 else 2 * cfg.cross_attn_every
    kw: dict[str, Any] = dict(
        num_layers=num_layers,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        vision_tokens=min(cfg.vision_tokens, 16) if cfg.vision_tokens else 0,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=8, chunk_size=8
        )
    return cfg.with_overrides(**kw)
