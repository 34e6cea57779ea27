"""Checkpoints of the port, in the reference's formats: monolithic npz
(``ckpt``), erasure-coded MDS stripes with bit-exact restore from any
N - s survivors (``coded``, parity through the ``gc_encode`` kernel on
the card), and the cadence/retention manager the trainer wires in."""
from .ckpt import (
    intact_steps,
    latest_step,
    load_checkpoint,
    restore_train_state,
    save_checkpoint,
)
from .coded import (
    CheckpointError,
    CodedSpec,
    ShardCorruptionError,
    ShardLossError,
    latest_coded_step,
    load_coded_checkpoint,
    restore_coded_train_state,
    save_coded_checkpoint,
)
from .manager import CheckpointManager, CkptConfig

__all__ = [
    "CheckpointError",
    "CheckpointManager",
    "CkptConfig",
    "CodedSpec",
    "ShardCorruptionError",
    "ShardLossError",
    "intact_steps",
    "latest_coded_step",
    "latest_step",
    "load_checkpoint",
    "load_coded_checkpoint",
    "restore_coded_train_state",
    "restore_train_state",
    "save_checkpoint",
    "save_coded_checkpoint",
]
