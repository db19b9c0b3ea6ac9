"""Roofline terms against one NVIDIA H100 SXM5 80GB (port of ``repro.roofline.analysis``).

Three terms, in seconds, per (arch x shape x chips):

    compute    = FLOPs            / (989e12 FLOP/s, dense bf16 tensor cores)
    memory     = HBM bytes        / (3.35e12 B/s)
    collective = collective bytes / (450e9 B/s, NVLink one way)

The peaks are the figures of NVIDIA's H100 SXM5 80GB datasheet (dense,
without sparsity, at the card's 700 W).  A bound is the least time the
card could take, so bounds read these peaks and not a measured rate;
``chip_smoke.py`` step 11 prints the card's attainable copy and matmul
rates beside them (and fails a reading above 105 % of its peak).

What the reference reads from XLA's artefacts has no counterpart here:
an eager PyTorch program has no compiled module.  ``normalize_flops``
(XLA's per-device or global reporting convention) has none, since the
FLOP count comes from :mod:`~repro_torch.roofline.analytic`, global by
construction, and is divided by ``chips`` explicitly.
``collective_bytes_from_hlo`` becomes
:func:`repro_torch.roofline.trace.collective_bytes` (the collectives'
operand bytes read from a profiler trace; 0 on one card), and
``while_trip_counts`` becomes :func:`repro_torch.roofline.trace.launches`
(an eager loop launches its kernels once per trip, and the trace counts
the launches).
"""
from __future__ import annotations

import dataclasses

# --- NVIDIA H100 SXM5 80GB, datasheet figures (per card) ---------------------
PEAK_FLOPS_BF16 = 989e12        # dense bf16 / fp16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12         # fp32 on the CUDA cores
PEAK_FLOPS_3XTF32 = 495e12 / 3  # fp32-accurate products: 495 TFLOP/s TF32 over 3 products
HBM_BW = 3.35e12                # HBM3, bytes/s
# NVLink 4: 900 GB/s per card in both directions together (datasheet),
# 450 GB/s each way; the reference charges one ICI link, the port one
# direction of the card's NVLink.
NVLINK_BW = 450e9
ICI_BW_PER_LINK = NVLINK_BW

# peak rate by the name of the operands' type (torch dtype names)
PEAK_OPS = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_FP32, "3xtf32": PEAK_FLOPS_3XTF32}


@dataclasses.dataclass
class RooflineTerms:
    """The reference's record, field for field.  ``hlo_flops`` and
    ``hlo_bytes`` keep their names so the two packages' records compare
    key for key; in the port they hold the step's FLOPs and HBM bytes as
    the caller counted them (per card: the per-kernel bytes of
    :mod:`~repro_torch.roofline.analytic`, since there is no compiled
    module to read), and ``collective_bytes`` the bytes of
    :func:`~repro_torch.roofline.trace.collective_bytes`."""

    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float          # per card
    hlo_bytes: float          # per card
    collective_bytes: float   # per card (weighted)
    model_flops: float        # 6ND train / 2ND inference (global)
    analytic_flops: float = 0.0  # exact accounting (repro_torch.roofline.analytic)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    def finalize(self) -> "RooflineTerms":
        flops_per_dev = (
            self.analytic_flops / self.chips
            if self.analytic_flops
            else self.hlo_flops
        )
        self.compute_s = flops_per_dev / PEAK_FLOPS_BF16
        self.memory_s = self.hlo_bytes / HBM_BW
        self.collective_s = self.collective_bytes / ICI_BW_PER_LINK
        return self

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted compute: remat, padding, redundancy."""
        total = self.analytic_flops or self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def step_time_s(self) -> float:
        """Lower bound assuming perfect overlap: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute roofline fraction (MFU against the bound)."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS_BF16)
        return ideal / self.step_time_s if self.step_time_s else 0.0

    def to_json(self) -> dict:
        return {
            **dataclasses.asdict(self),
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "step_time_s": self.step_time_s,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, shape, active_params: int) -> float:
    """6·N·D for training, 2·N·D for inference steps (N = active params)."""
    if shape.kind == "train":
        return 6.0 * active_params * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * active_params * shape.tokens
    # decode: one token per sequence
    return 2.0 * active_params * shape.global_batch


def active_param_count(cfg, layout) -> int:
    """Parameter count of a :class:`~repro_torch.models.params.ParamSpec`
    layout with each leaf that has an ``"experts"`` axis scaled by
    top_k / num_experts (embeddings kept, for the 6ND convention)."""
    if isinstance(layout, dict):
        return sum(active_param_count(cfg, v) for v in layout.values())
    n = 1
    for d in layout.shape:
        n *= int(d)
    if "experts" in layout.logical_axes:
        n = int(n * (cfg.moe.top_k / cfg.moe.num_experts))
    return n
