"""Training: host dedup, losses, the train step and ``fit`` loop (``Trainer``),
checkpoints and chunked test inference."""
from .checkpoint import CheckpointManager, latest_step, restore_checkpoint, save_checkpoint
from .dedup import dedup_bucket, dedup_capable, pad_dedup_to, prep_dedup_batch
from .inference import assemble_submission, chunked_score, split_chunks
from .losses import binary_logloss, categorical_crossentropy, l2_penalty, loss_fn_for
from .trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "dedup_bucket", "dedup_capable", "pad_dedup_to",
           "prep_dedup_batch", "binary_logloss", "categorical_crossentropy", "l2_penalty",
           "loss_fn_for", "CheckpointManager", "latest_step", "restore_checkpoint",
           "save_checkpoint", "assemble_submission", "chunked_score", "split_chunks"]
