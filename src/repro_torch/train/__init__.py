"""Training (port of ``repro.train``): AdamW, gradient compression,
checkpoints in the reference's layout, the resilient loop, the train
step (sharded by ``param_pspecs`` under a mesh) and, in
:mod:`repro_torch.train.elastic`, re-meshing and re-planning on a change
of device count."""
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.compression import compress_decompress, init_error_state
from repro_torch.train.fault import FaultConfig, ResilientLoop
from repro_torch.train.optimizer import (
    AdamWConfig,
    abstract_opt_state,
    adamw_update,
    global_norm,
    init_opt_state,
    lr_schedule,
)
from repro_torch.train.train_step import (
    TrainConfig,
    accumulate_grads,
    lm_loss,
    make_train_step,
)

__all__ = [
    "AdamWConfig",
    "Checkpointer",
    "FaultConfig",
    "ResilientLoop",
    "TrainConfig",
    "abstract_opt_state",
    "accumulate_grads",
    "adamw_update",
    "compress_decompress",
    "global_norm",
    "init_error_state",
    "init_opt_state",
    "lm_loss",
    "lr_schedule",
    "make_train_step",
]
